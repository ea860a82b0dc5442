"""The PathTracer cell's entry (entries/renderer_sample.py) on the CPU at
32x32 and 3,000 triangles: units are the samples of Renderer lives, a
frame's 16th sample is followed by the next frame's first, the reservoir
keeps 2 samples and the last, the check passes the program and reports a
perturbed sample as off, and a traced run reads the new counters and the
compaction span."""
import pytest
import torch

from benchmark import harness, trace


@pytest.fixture
def small_pt_cell():
    torch.set_num_threads(4)
    cell = harness.cell("conference-512.pathtracer")
    cell.config = dict(cell.config, width=32, height=32,
                       scene=dict(cell.config["scene"], triangles=3000))
    return cell


def _driver(cell, seed):
    d = cell.entry().Driver(cell.config, cell.traffic, seed, "cpu")
    d.setup()
    return d


def test_units_roll_over_frames_and_pass_the_check(small_pt_cell):
    d = _driver(small_pt_cell, 2**31 + 41)
    spp = small_pt_cell.config["spp"]
    lives = []
    for i in range(spp + 2):
        assert d.unit(i) > 0
        lives.append(d._life)
    frame0, frame1 = lives[spp - 1], lives[spp]
    assert frame0[0] == 0 and frame1[0] == 1
    assert frame0[1] is not frame1[1] and lives[spp + 1][1] is frame1[1]
    assert frame0[1].sample == spp and frame1[1].sample == 2
    assert all(life[1] is frame0[1] for life in lives[:spp])
    checked = d.units_to_check()
    assert len(checked) <= 3 and checked[-1]["i"] == spp + 1
    assert [r["i"] for r in checked] == sorted(r["i"] for r in checked)
    d.release()
    numbers = d.check()
    limits = small_pt_cell.limits
    assert set(numbers) == set(limits)
    assert all(numbers[k] <= limits[k] for k in limits), numbers


def test_a_perturbed_sample_is_reported_off(small_pt_cell, monkeypatch):
    from mobileraytracer_tpu_torch import renderer
    real = renderer.trace_image_sample

    def perturbed(*a, **k):
        rgb, rays = real(*a, **k)
        return rgb * 1.01, rays
    d = _driver(small_pt_cell, 2**31 + 43)
    monkeypatch.setattr(renderer, "trace_image_sample", perturbed)
    for i in range(2):
        d.unit(i)
    d.release()
    numbers = d.check()
    assert numbers["pixels_off_ppm"] > small_pt_cell.limits["pixels_off_ppm"]
    assert numbers["hit_lanes_off_ppm"] == 0.0


def test_a_traced_run_reads_the_new_metrics(small_pt_cell):
    from mobileraytracer_tpu_torch.utils import metrics
    try:
        res = harness.run_cell(
            small_pt_cell, 2**31 + 47, 0.5, True, "cpu", started=0.0,
            profile=lambda d, f: trace.profile_units(d, f, 1))
    finally:
        metrics.disable()
        metrics.reset()
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"], res["checks"]
    assert m["walker.compact_ms"] > 0
    assert 0 < m["engine.chunk_fill"] <= 100
    assert m["engine.walk_steps"] > 1
    loops = m["block_traversal.refill_loops"]
    if loops:
        assert m["block_traversal.refill_rays"] >= 1
    assert "rays_per_s" not in m
