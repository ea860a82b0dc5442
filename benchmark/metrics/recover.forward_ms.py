"""recover.forward_ms: device milliseconds of a recovery step's forward
render (the loss of its 16 differentiable samples) per step, from the
CUDA events that `parallel.recover` records into `recover.EVENTS` (this
reader switches them on for the window).  None where the program records
none."""
PART = "forward"


def _events():
    try:
        from mobileraytracer_tpu_torch.parallel import recover
    except ImportError:
        return None
    if getattr(recover, "EVENTS", None) is None:
        recover.EVENTS = {}
    return recover.EVENTS.get(PART, [])


def counter():
    import torch
    events = _events()
    if not events:
        return 0.0
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events)


def read(run):
    if not run.units or not _events():
        return None
    return run.deltas[f"recover.{PART}_ms"] / len(run.units)
