"""The per-layer metrics that read the program's own spans and host-sync
counts (benchmark/program_spans.py), on the CPU at the small cells' size:
a traced run reports each of them, an untraced run leaves its tracer off,
and a program without a tracer leaves them out without raising."""
import pytest

from benchmark import harness, program_spans, trace

RENDER = ("frame.pixel_order_ms", "frame.self_ms", "walker.self_ms",
          "block_traversal.self_ms.render",
          "block_traversal.sync_wait_ms.render",
          "block_traversal.syncs.render")
GRAD = ("block_traversal.self_ms.grad", "block_traversal.sync_wait_ms.grad",
        "block_traversal.syncs.grad")


@pytest.fixture
def tracer():
    """The program's tracer, off and emptied again after the test."""
    from mobileraytracer_tpu_torch.utils import metrics
    metrics.disable()
    metrics.reset()
    yield metrics
    metrics.disable()
    metrics.reset()


def _traced(cell, seed):
    return harness.run_cell(cell, seed, 0.5, True, "cpu", started=0.0,
                            profile=lambda d, f: trace.profile_units(d, f, 1))


def test_the_new_metrics_are_the_cells_per_layer_ones(small_cell,
                                                      small_grad_cell):
    assert set(RENDER) <= {m["name"] for m in small_cell.per_layer}
    assert set(GRAD) <= {m["name"] for m in small_grad_cell.per_layer}
    assert not set(GRAD) & {m["name"] for m in small_cell.per_layer}


def test_a_traced_whitted_run_reads_the_program_spans(small_cell, tracer):
    res = _traced(small_cell, 2**31 + 23)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"] and tracer.enabled()
    for name in RENDER:
        assert m[name] > 0, name
    # One closest-hit and one shadow query a sample, each with its refill:
    # at least the two reads that end each refill.
    assert m["block_traversal.syncs.render"] >= 4
    assert m["engine.walk_steps"] == 1.0


def test_a_traced_grad_run_reads_the_program_spans(small_grad_cell, tracer):
    res = _traced(small_grad_cell, 2**31 + 29)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"]
    for name in GRAD:
        assert m[name] > 0, name
    # Eleven traversal queries a call (interior 2, silhouette 4, shadow 5).
    assert m["block_traversal.syncs.grad"] >= 2 * 11


def test_an_untraced_run_leaves_the_tracer_off(small_cell, tracer):
    res = harness.run_cell(small_cell, 2**31 + 31, 0.3, False, "cpu",
                           started=0.0)
    assert not tracer.enabled()
    assert not tracer.summary()["spans"]
    assert not set(RENDER) & set(res["metrics"])


def test_a_program_without_a_tracer_leaves_the_metrics_out(
        small_cell, tracer, monkeypatch):
    monkeypatch.setattr(program_spans, "tracer", lambda: None)
    res = _traced(small_cell, 2**31 + 37)
    assert not tracer.enabled()
    assert not set(RENDER) & set(res["metrics"])
    assert "engine.walk_steps" in res["metrics"]
