"""Ray-scene intersection: naive oracle, block BVH, CUDA kernels."""
