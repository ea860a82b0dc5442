"""The port's tracer (utils/metrics.py) on the CPU: off it records
nothing and reads no clock, and frames and gradients come out bitwise
the same with it on; on, the spans nest as the layers do (frame, walker,
traversal drivers, kernels), carry their unit's id, and their self times
add up to the unit's duration; the traversal's host reads follow the
refill's loop count; a block's counts set apart replay as if it ran
again; the Renderer's worker thread keeps its own stack;
`cli --spans` writes the spans; a recovery step is a unit with its
forward, backward and update spans, the full-batch walk counts its
steps, lanes and live lanes with one host read a step, and the lights'
radiance survives a checkpoint.  Imports neither jax nor the JAX package,
so the `cuda` test runs on a machine with PyTorch for CUDA alone:

    python -m pytest --noconftest tests/test_torch_tracing.py -q -m cuda
"""
import dataclasses
import json
import sys
import threading

import numpy as np
import pytest
import torch

from mobileraytracer_tpu_torch import bench_scenes, cli, convert, renderer
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import sampling
from mobileraytracer_tpu_torch.diff import geom
from mobileraytracer_tpu_torch.ops import block_traversal as bt
from mobileraytracer_tpu_torch.parallel import recover
from mobileraytracer_tpu_torch.shaders import engine
from mobileraytracer_tpu_torch.types import RenderConfig
from mobileraytracer_tpu_torch.utils import checkpoint, metrics

torch.set_num_threads(2)

WHITTED = RenderConfig(width=32, height=32, spp=1, shader=C.SHADER_WHITTED,
                       accelerator=C.ACC_BVH)
GRAD = dict(edge_samples=2, edge_budget=64, shadow_edges=True,
            shadow_budget=16)
QUERIES = ("traversal.intersect_scene_blocks", "traversal.occluded_blocks")


@pytest.fixture(scope="module")
def conference():
    """The conference proxy at 20,000 triangles on its block grid: its
    32x32 Whitted frame needs no dense backstop."""
    scene, cam, _ = bench_scenes.conference_proxy(target_prims=20000)
    return bt.build(scene, device="cpu"), cam


@pytest.fixture
def tracer():
    """The tracer, off and empty before and after the test."""
    metrics.disable()
    metrics.reset()
    yield metrics
    metrics.disable()
    metrics.reset()


def _frame(conference, i=0):
    scene, cam = conference
    key = sampling.fold_in(sampling.prng_key(11, torch.device("cpu")), i)
    return renderer.render_frame(scene, cam, WHITTED, key)


def _tree(recs):
    """{span id: record} and {span id: [child records]} of one unit."""
    by_id = {r[0]: r for r in recs}
    kids = {}
    for r in recs:
        kids.setdefault(r[4], []).append(r)
    return by_id, kids


def _ancestors(rec, by_id):
    out = []
    while rec[4] is not None:
        rec = by_id[rec[4]]
        out.append(rec[1])
    return out


def test_off_records_nothing_and_reads_no_clock(conference, tracer,
                                                monkeypatch):
    def no_clock():
        raise AssertionError("the tracer read its clock while off")
    monkeypatch.setattr(metrics, "clock", no_clock)
    assert metrics.span("frame.render_frame") is \
        metrics.span("frame.render_frame")
    syncs = metrics.SYNCS["traversal"]
    _frame(conference)
    assert metrics.SYNCS["traversal"] > syncs     # counted while off
    assert metrics.summary()["spans"] == {} and metrics.units() == []


def test_frame_and_gradient_bitwise_with_tracing_on(conference, tracer):
    scene, cam = conference
    cfg = dataclasses.replace(WHITTED, width=16, height=16)
    key = sampling.prng_key(5, torch.device("cpu"))
    off_frame = _frame(conference)
    off_grad = geom.vertex_grad(scene, cam, cfg, key, **GRAD)
    metrics.enable()
    on_frame = _frame(conference)
    on_grad = geom.vertex_grad(scene, cam, cfg, key, **GRAD)
    metrics.disable()
    assert torch.equal(off_frame["image"], on_frame["image"])
    assert torch.equal(off_frame["bitmap"], on_frame["bitmap"])
    assert int(off_frame["rays"]) == int(on_frame["rays"]) > 0
    assert torch.equal(off_grad[0], on_grad[0])
    for k in off_grad[1]:
        assert torch.equal(off_grad[1][k], on_grad[1][k]), k
    spans = metrics.summary()["spans"]
    for name in ("gradients.vertex_grad", "gradients.interior",
                 "gradients.silhouette", "gradients.shadow",
                 "gradients.draws", "frame.render_frame"):
        assert name in spans, name
    assert spans["gradients.draws"]["count"] == 2      # silhouette, shadow


def test_spans_nest_by_layer_with_one_unit_a_frame(conference, tracer):
    metrics.enable()
    _frame(conference, 0)
    _frame(conference, 1)
    metrics.disable()
    units = metrics.units()
    assert len(units) == 2 and units[0][0] != units[1][0]
    for unit, recs in units:
        by_id, _ = _tree(recs)
        assert {r[5] for r in recs} == {unit}
        (root,) = [r for r in recs if r[4] is None]
        assert root[1] == "frame.render_frame" and root is recs[-1]
        cands = [r for r in recs if r[1] == "traversal._candidates"]
        assert cands
        for r in cands:
            up = _ancestors(r, by_id)
            assert up[-2:] == ["walker.trace_image_sample",
                               "frame.render_frame"]
            assert any(q in up for q in QUERIES)
        names = {r[1] for r in recs}
        assert {"frame._pixel_order", "frame.finish_frame", "walker.step",
                "walker.direct_lighting", "traversal._refill_exact",
                "kernels.traverse_tilemt", "kernels.traverse_banded",
                "traversal.sync", "walker.sync"} <= names


def test_self_times_add_up_to_the_root_on_a_fake_clock(conference, tracer,
                                                      monkeypatch):
    ticks = iter(range(0, 10**9, 7))
    monkeypatch.setattr(metrics, "clock", lambda: next(ticks))
    metrics.enable()
    _frame(conference)
    metrics.disable()
    ((_, recs),) = metrics.units()
    _, kids = _tree(recs)
    dur = {r[0]: r[3] - r[2] for r in recs}
    self_ns = {r[0]: dur[r[0]] - sum(dur[k[0]] for k in kids.get(r[0], ()))
               for r in recs}
    (root,) = kids[None]
    assert all(v >= 0 for v in self_ns.values())
    assert sum(self_ns.values()) == dur[root[0]]
    spans = metrics.summary()["spans"]
    for name in {r[1] for r in recs}:
        mine = [r[0] for r in recs if r[1] == name]
        assert spans[name]["count"] == len(mine)
        assert spans[name]["total_ms"] * 1e6 == pytest.approx(
            sum(dur[i] for i in mine))
        assert spans[name]["self_ms"] * 1e6 == pytest.approx(
            sum(self_ns[i] for i in mine))


def test_traversal_syncs_follow_the_refill_loops(conference, tracer):
    """Each refill reads its unresolved count once before its first loop
    and once after each loop, and its dense backstop reads nothing:
    SYNCS = refill loops + queries."""
    before = (dict(bt.LOOPS), dict(bt.REFILL), metrics.SYNCS["traversal"])
    metrics.enable()
    _frame(conference)
    metrics.disable()
    loops = {k: bt.LOOPS[k] - before[0][k] for k in bt.LOOPS}
    refill = {k: bt.REFILL[k] - before[1][k] for k in bt.REFILL}
    spans = metrics.summary()["spans"]
    queries = sum(spans[q]["count"] for q in QUERIES)
    assert queries == 2 and loops["refill"] > 0 and loops["dense"] == 0
    syncs = metrics.SYNCS["traversal"] - before[2]
    assert syncs == loops["refill"] + queries
    assert spans["traversal.sync"]["count"] == syncs
    assert refill["loops"] == loops["refill"]
    assert 0 < refill["rays"] <= refill["lanes"] // bt.ST
    counters = metrics.summary()["counters"]
    assert counters["block_traversal.LOOPS"] is not bt.LOOPS
    assert counters["block_traversal.LOOPS"] == dict(bt.LOOPS)
    assert set(counters) == {"block_traversal.LOOPS",
                             "block_traversal.REFILL", "kernels.LAUNCHES",
                             "engine.WALK", "engine.CHUNKS", "engine.GRAPH",
                             "engine.FULL", "metrics.SYNCS", "renderer.ORDER"}


def _counts():
    return {k: dict(v) for k, v in metrics.summary()["counters"].items()}


def test_counted_apart_block_replays_as_if_it_ran_again(conference, tracer):
    """`counted_apart` restores every registered counter after its block
    and records the block's change: two replays of it leave the counters
    as if the block had run twice more, the same dicts updated."""
    s0 = _counts()
    _frame(conference)
    s1 = _counts()
    change = {name: {k: v - s0[name][k] for k, v in c.items()
                     if v != s0[name][k]} for name, c in s1.items()}
    change = {name: c for name, c in change.items() if c}
    assert change["block_traversal.LOOPS"]["refill"] > 0
    assert change["metrics.SYNCS"]["traversal"] > 0
    loops = bt.LOOPS
    with metrics.counted_apart() as counted:
        _frame(conference)
    assert _counts() == s1 and bt.LOOPS is loops
    assert counted.change == change
    counted.replay()
    counted.replay()
    assert _counts() == {name: {k: v + 2 * change.get(name, {}).get(k, 0)
                                for k, v in c.items()}
                         for name, c in s1.items()}


def test_renderer_worker_thread_keeps_its_own_stack(conference, tracer):
    scene, cam = conference
    r = renderer.Renderer(scene, cam, dataclasses.replace(WHITTED, spp=2),
                          device="cpu")
    metrics.enable()
    worker = r.render_async()
    _frame(conference)
    assert r.wait(timeout=600) == renderer.STATE_FINISHED
    assert not worker.is_alive()
    metrics.disable()
    units = metrics.units()
    roots = sorted(recs[-1][1] for _, recs in units)
    assert roots == ["frame.render_frame", "frame.render_sample",
                     "frame.render_sample"]
    for unit, recs in units:
        by_id, _ = _tree(recs)
        assert len({r[6] for r in recs}) == 1
        for rec in recs:
            if rec[4] is not None:
                assert by_id[rec[4]][5] == unit
    assert metrics.SYNCS["frame"] >= 2


def test_span_sums_lose_no_update_across_threads(tracer):
    """16 threads, each 200 units of a root and two children, with the
    interpreter switching threads as often as it can: every span is
    counted, and each unit holds one thread's three spans."""
    n_threads, n_units = 16, 200

    def work():
        for _ in range(n_units):
            with metrics.span("gradients.vertex_grad"):
                with metrics.span("gradients.draws"):
                    pass
                with metrics.span("gradients.shadow"):
                    pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    metrics.enable()
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        metrics.disable()
        sys.setswitchinterval(switch)
    spans = metrics.summary()["spans"]
    for name in ("gradients.vertex_grad", "gradients.draws",
                 "gradients.shadow"):
        assert spans[name]["count"] == n_threads * n_units, name
    for unit, recs in metrics.units():
        assert [r[1] for r in recs] == ["gradients.draws", "gradients.shadow",
                                        "gradients.vertex_grad"]
        assert len({r[6] for r in recs}) == 1 and {r[5] for r in recs} == {
            unit}


def test_cli_spans_writes_the_trace(tmp_path, tracer):
    spans, rows = tmp_path / "spans.json", tmp_path / "m.jsonl"
    assert cli.main(["--cpu", "--width", "16", "--height", "16", "--acc",
                     "3", "--quiet", "--spans", str(spans),
                     "--metrics-jsonl", str(rows)]) == 0
    assert not metrics.enabled()
    trace = json.loads(spans.read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"frame.render_sample", "walker.trace_image_sample",
            "traversal.intersect_scene_blocks"} <= names
    assert all(e["ph"] == "X" for e in trace["traceEvents"])
    (unit,) = {e["args"]["unit"] for e in trace["traceEvents"]
               if e["name"] == "frame.render_sample"}
    assert unit is not None
    (row,) = [json.loads(x) for x in rows.read_text().splitlines()]
    assert row["trace"] == trace["otherData"]
    assert row["trace"]["spans"]["frame.render_sample"]["count"] == 1
    assert "metrics.SYNCS" in row["trace"]["counters"]


RECOVER = RenderConfig(width=16, height=16, spp=2,
                       shader=C.SHADER_PATHTRACER, accelerator=C.ACC_BVH,
                       nee_share=128, nee_reverse=True,
                       nee_share_secondary=True)


def _recovery(conference, steps=1, **kw):
    """recover_materials of kD and the lights' radiance on the PathTracer
    at 16x16 from half the scene's values."""
    scene, cam = conference
    init = {"kd": scene.materials.kd * 0.5,
            "radiance": scene.lights.radiance * 0.5}
    target = torch.full((16, 16, 3), 0.25)
    return recover.recover_materials(
        scene, cam, RECOVER, target, steps=steps,
        params_subset=("kd", "radiance"), learning_rate=0.05,
        base_key=sampling.prng_key(4), init_params=init, **kw)


def test_recovery_spans_and_full_counter_advance(conference, tracer):
    """A recovery step is one unit, `recover.step`, holding its forward,
    backward and update spans; the full-batch walk's counter `engine.FULL`
    is registered and counts its steps, the lanes they traced (every lane
    at every step) and the live ones among them."""
    before = dict(engine.FULL)
    metrics.enable()
    _recovery(conference)
    metrics.disable()
    spans = metrics.summary()["spans"]
    for name in ("recover.step", "recover.forward", "recover.backward",
                 "recover.update"):
        assert spans[name]["count"] == 1, name
    assert spans["walker.trace_image_sample"]["count"] == RECOVER.spp
    unit, recs = metrics.units()[-1]
    names = {r[1] for r in recs}
    assert {"recover.step", "recover.forward", "recover.backward",
            "recover.update", "walker.step"} <= names
    assert all(r[5] == unit for r in recs)
    full = {k: engine.FULL[k] - before[k] for k in engine.FULL}
    assert full["steps"] >= RECOVER.spp
    assert full["lanes"] == full["steps"] * 16 * 16
    assert 0 < full["live"] < full["lanes"]
    assert metrics.summary()["counters"]["engine.FULL"] == dict(engine.FULL)


def test_full_batch_walk_reads_the_host_once_a_step(conference, tracer):
    """The differentiable walk reads its live-lane count once before each
    step and once more to find it drained (a chain of depth_max + 1 nodes
    drains within the pops budget): SYNCS["walker"] is the full-batch
    steps plus the walks, as it was while the read was `.any()`."""
    before = (metrics.SYNCS["walker"], engine.FULL["steps"])
    metrics.enable()
    _recovery(conference)
    metrics.disable()
    walks = metrics.summary()["spans"]["walker.trace_image_sample"]["count"]
    steps = engine.FULL["steps"] - before[1]
    assert metrics.SYNCS["walker"] - before[0] == steps + walks


def test_radiance_checkpoint_round_trip_and_resume_bitwise(conference,
                                                           tmp_path):
    """The lights' radiance and its Adam moments go under their own names
    beside JAX's leaves of kD; load_opt_state gives back the saved state
    exactly, and a run resumed from its step-2 file equals the
    uninterrupted run bit for bit."""
    path = tmp_path / "rec.npz"
    params, losses = _recovery(conference, steps=3,
                               checkpoint_path=str(path), checkpoint_every=2)
    with np.load(path) as f:
        assert sorted(f.files) == sorted(
            ["leaf_0", "leaf_1", "leaf_2", "leaf_3", "radiance",
             "radiance_mu", "radiance_nu", "opt_step", "losses"])
        assert int(f["leaf_1"]) == int(f["opt_step"]) == 2
        saved = {k: f[k] for k in f.files}
    scene = conference[0]
    template = recover.make_state({"kd": scene.materials.kd,
                                   "radiance": scene.lights.radiance}, 0.05)
    (got, opt), step, _ = checkpoint.load_opt_state(str(path), template)
    assert step == 2
    assert np.array_equal(got["kd"].detach().numpy(), saved["leaf_0"])
    assert np.array_equal(got["radiance"].detach().numpy(),
                          saved["radiance"])
    count, mu, nu = convert.adam_to_optax(opt, got)
    assert int(count) == 2
    assert np.array_equal(mu["radiance"], saved["radiance_mu"])
    assert np.array_equal(nu["radiance"], saved["radiance_nu"])
    assert np.array_equal(mu["kd"], saved["leaf_2"])
    resumed, losses_r = _recovery(conference, steps=3,
                                  checkpoint_path=str(path),
                                  checkpoint_every=2, resume=True)
    for k in params:
        assert torch.equal(params[k], resumed[k]), k
    assert np.array_equal(losses, losses_r)
    assert float((params["radiance"] - scene.lights.radiance * 0.5)
                 .abs().max()) > 0.01


@pytest.mark.cuda
def test_gradient_spans_and_events_agree_on_the_card(tracer):
    """On the card, the gradient parts' spans also record geom.EVENTS:
    one event pair per span, under the span name's last part."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see chip_smoke.py)")
    dev = torch.device("cuda")
    scene, cam, _ = bench_scenes.conference_proxy(target_prims=20000)
    scene = bt.build(scene, device=dev)
    cfg = dataclasses.replace(WHITTED, width=64, height=64)
    metrics.enable()
    geom.EVENTS = {}
    try:
        geom.vertex_grad(scene, cam, cfg, sampling.prng_key(5, dev), **GRAD)
        torch.cuda.synchronize()
        events = geom.EVENTS
    finally:
        geom.EVENTS = None
        metrics.disable()
    spans = metrics.summary()["spans"]
    parts = {n.rpartition(".")[2]: v["count"] for n, v in spans.items()
             if n.startswith("gradients.") and n != "gradients.vertex_grad"}
    assert parts == {k: len(v) for k, v in events.items()}
    assert set(parts) == {"interior", "silhouette", "shadow", "draws"}
    assert all(s.elapsed_time(e) >= 0 for v in events.values() for s, e in v)
