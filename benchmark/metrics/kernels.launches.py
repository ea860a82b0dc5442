"""kernels.launches: launches of the port's hand-written traversal
kernels (the sum of `kernels.LAUNCHES`) over the window, per sample."""


def counter():
    from mobileraytracer_tpu_torch.ops import kernels
    return sum(kernels.LAUNCHES.values())


def read(run):
    return run.deltas["kernels.launches"] / run.samples if run.samples \
        else None
