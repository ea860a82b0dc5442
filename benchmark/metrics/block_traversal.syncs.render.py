"""block_traversal.syncs.render: the traversal drivers' host reads of device
values (the program's `SYNCS["traversal"]`) over the window, per sample."""
from benchmark import program_spans as ps


def counter():
    return ps.syncs("traversal")


def read(run):
    return ps.per_sample(run, "block_traversal.syncs.render")
