"""engine.full_steps: the walk's full-batch steps (the differentiable
walk's, `engine.FULL["steps"]`) over the window, per unit.  None where
the program has no such counter."""


def _full():
    from mobileraytracer_tpu_torch.shaders import engine
    return getattr(engine, "FULL", None)


def counter():
    c = _full()
    return 0 if c is None else c["steps"]


def read(run):
    if _full() is None or not run.samples:
        return None
    return run.deltas["engine.full_steps"] / run.samples
