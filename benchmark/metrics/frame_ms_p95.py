"""frame_ms_p95: the 95th percentile (nearest rank) of the times of every
frame in the window, each from its call until its ray count is on the
host."""
import math


def p95(values):
    """Nearest-rank 95th percentile: the smallest value with at least 95%
    of the values at or below it."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def read(run):
    if run.cell.traffic.get("unit") != "frame":
        return None
    return p95([(e - s) * 1e3 for s, e, _ in run.units])
