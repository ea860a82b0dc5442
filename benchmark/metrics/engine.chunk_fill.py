"""engine.chunk_fill: the share of the compacted walk's chunk slots that
held a live lane (`engine.CHUNKS`: live over slots) over the window, in
percent.  None where the program has no such counter."""
import numpy as np


def _chunks():
    from mobileraytracer_tpu_torch.shaders import engine
    return getattr(engine, "CHUNKS", None)


def counter():
    c = _chunks()
    return np.zeros(2) if c is None else np.array([c["live"], c["slots"]],
                                                  np.float64)


def read(run):
    live, slots = run.deltas["engine.chunk_fill"]
    if _chunks() is None or not slots:
        return None
    return float(100.0 * live / slots)
