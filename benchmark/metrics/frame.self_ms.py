"""frame.self_ms: self milliseconds of the program's span
`frame.render_frame` (the frame's own host work outside its child spans:
ray keys, jitter, camera rays, the film) over the window, per sample."""
from benchmark import program_spans as ps


def counter():
    return ps.span_ms(lambda n: n == "frame.render_frame", "self_ms")


def read(run):
    return ps.per_sample(run, "frame.self_ms")
