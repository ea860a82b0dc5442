"""setup_s: from the start of the benchmark's process to the start of the
window: imports, the CUDA context, the scene and its build, the kernel
library's build or load, and the warm-up."""


def read(run):
    return run.setup_s
