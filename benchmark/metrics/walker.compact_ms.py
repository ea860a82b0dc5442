"""walker.compact_ms: milliseconds in the program's span `walker.compact`
(the compacted walk's gather of a chunk's lanes and its scatter back)
over the window, per sample.  None where the program has no such span."""
from benchmark import program_spans as ps

SPAN = "walker.compact"


def counter():
    return ps.span_ms(lambda n: n == SPAN, "total_ms")


def read(run):
    t = ps.tracer()
    if t is None or SPAN not in t.summary()["spans"]:
        return None
    return ps.per_sample(run, "walker.compact_ms")
