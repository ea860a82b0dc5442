"""block_traversal.self_ms.grad: self milliseconds of the program's
`traversal.*` spans (the scene queries, candidate windows, refill and
dense backstop on the host, outside the kernels' wrappers), host syncs
excepted, over the window, per call."""
from benchmark import program_spans as ps


def counter():
    return ps.span_ms(ps.layer_self("traversal"), "self_ms")


def read(run):
    return ps.per_sample(run, "block_traversal.self_ms.grad")
