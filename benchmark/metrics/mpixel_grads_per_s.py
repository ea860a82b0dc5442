"""mpixel_grads_per_s: the pixels of every vertex-gradient call finished
in the window, in millions, over the time from the window's start to the
last call's end (bench_grad's metric, taken over the whole window)."""


def read(run):
    if run.cell.traffic.get("work") != "pixels" or not run.units:
        return None
    pixels = sum(w for _, _, w in run.units)
    return pixels / (run.units[-1][1] - run.window_start) / 1e6
