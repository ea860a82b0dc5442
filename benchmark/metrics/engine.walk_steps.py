"""engine.walk_steps: the walker's steps (`engine.WALK["steps"]`, chunk
steps or full-batch steps) over the window, per sample."""


def counter():
    from mobileraytracer_tpu_torch.shaders import engine
    return engine.WALK["steps"]


def read(run):
    return run.deltas["engine.walk_steps"] / run.samples if run.samples \
        else None
