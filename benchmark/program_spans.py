"""Reads the program's own tracer (mobileraytracer_tpu_torch/utils/
metrics.py: `span`, `summary`, `SYNCS`) for the per-layer metrics of
program spans and host syncs.  A reader's `counter()` turns the tracer
on, so a traced run records the program's spans over its whole window
(an untraced run reads no per-layer metric, so its tracer stays off);
`read()` divides the window's change by the run's samples (a frame's
sample, or a gradient call).

A checkout whose program has no tracer gives 0 to every counter and None
to every read: the metric is left out of its line."""


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from mobileraytracer_tpu_torch.utils import metrics
    except ImportError:
        return None
    if not all(hasattr(metrics, n) for n in ("enable", "summary", "SYNCS")):
        return None
    return metrics


def span_ms(names, kind: str) -> float:
    """Turns the tracer on; the sum of `kind` ("total_ms" or "self_ms")
    over the spans whose name `names(name)` accepts, since the tracer's
    last reset."""
    t = tracer()
    if t is None:
        return 0.0
    t.enable()
    return sum(v[kind] for k, v in t.summary()["spans"].items() if names(k))


def syncs(layer: str) -> int:
    """The program's host reads of device values in `layer` so far."""
    t = tracer()
    return 0 if t is None else t.SYNCS.get(layer, 0)


def layer_self(layer: str):
    """Accepts the spans of `layer` except its host syncs."""
    return lambda n: n.startswith(layer + ".") and n != layer + ".sync"


def per_sample(run, metric: str):
    """The window's change of `metric`'s counter per sample, or None."""
    if tracer() is None or not run.samples:
        return None
    return run.deltas[metric] / run.samples
