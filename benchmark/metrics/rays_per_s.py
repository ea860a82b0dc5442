"""rays_per_s: the casted rays (camera, secondary and shadow) of every
unit finished in the window, over the time from the window's start to the
last unit's end (MobileRT's metric, C_wrapper.cpp:256)."""


def rate(window_start, units):
    """Work of all units over the time to the last one's end."""
    if not units:
        return None
    return sum(w for _, _, w in units) / (units[-1][1] - window_start)


def read(run):
    if run.cell.traffic.get("work") != "rays":
        return None
    return rate(run.window_start, run.units)
