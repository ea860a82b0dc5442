"""geom.draws_ms: device milliseconds of the Gumbel-max edge draws per
call, from the CUDA events that `diff.geom` records into `geom.EVENTS`
(this reader switches them on for the window)."""
PART = "draws"


def counter():
    import torch
    from mobileraytracer_tpu_torch.diff import geom
    if geom.EVENTS is None:
        geom.EVENTS = {}
    events = geom.EVENTS.get(PART, [])
    if events:
        torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events)


def read(run):
    from mobileraytracer_tpu_torch.diff import geom
    if not run.units or not (geom.EVENTS or {}).get(PART):
        return None
    return run.deltas[f"geom.{PART}_ms"] / len(run.units)
