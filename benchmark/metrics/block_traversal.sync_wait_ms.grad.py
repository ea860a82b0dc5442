"""block_traversal.sync_wait_ms.grad: milliseconds the traversal drivers
wait on the host for device values (the program's `traversal.sync` spans)
over the window, per call."""
from benchmark import program_spans as ps


def counter():
    return ps.span_ms(lambda n: n == "traversal.sync", "total_ms")


def read(run):
    return ps.per_sample(run, "block_traversal.sync_wait_ms.grad")
