"""block_traversal.refill_loops: iterations of the traversal's exact
refill (`block_traversal.LOOPS["refill"]`) over the window, per sample."""


def counter():
    from mobileraytracer_tpu_torch.ops import block_traversal
    return block_traversal.LOOPS["refill"]


def read(run):
    return run.deltas["block_traversal.refill_loops"] / run.samples \
        if run.samples else None
