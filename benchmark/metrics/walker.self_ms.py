"""walker.self_ms: self milliseconds of the program's `walker.*`
spans (the walk, its steps and direct lighting, outside the traversal
they call), host syncs excepted, over the window, per sample."""
from benchmark import program_spans as ps


def counter():
    return ps.span_ms(ps.layer_self("walker"), "self_ms")


def read(run):
    return ps.per_sample(run, "walker.self_ms")
