"""frame.pixel_order_ms: milliseconds in the program's span
`frame._pixel_order` (the lane order of a frame's pixels, made on the
host) over the window, per sample."""
from benchmark import program_spans as ps


def counter():
    return ps.span_ms(lambda n: n == "frame._pixel_order", "total_ms")


def read(run):
    return ps.per_sample(run, "frame.pixel_order_ms")
