"""walker.diff_live_share: the share of the lanes traced by the walk's
full-batch steps (the differentiable walk's, `engine.FULL`) that were
live, over the window, in percent.  None where the program has no such
counter."""
import numpy as np


def _full():
    from mobileraytracer_tpu_torch.shaders import engine
    return getattr(engine, "FULL", None)


def counter():
    c = _full()
    return np.zeros(2) if c is None else np.array([c["live"], c["lanes"]],
                                                  np.float64)


def read(run):
    live, lanes = run.deltas["walker.diff_live_share"]
    if _full() is None or not lanes:
        return None
    return float(100.0 * live / lanes)
