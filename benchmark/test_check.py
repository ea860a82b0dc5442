"""The check that decides `correct`, at a size the CPU holds, for each
cell: the scene the program is handed is the reference's, the program
passes it, the control (the reference in bfloat16 in the program's place)
fails it, and a run whose timed path is broken underneath comes out not
correct."""
import numpy as np
import pytest
import torch

from benchmark import harness, program_scene
from benchmark.reference import proxy


def test_scene_arrays_are_the_ports_conference_proxy():
    from mobileraytracer_tpu_torch import bench_scenes

    arrays = proxy.conference_proxy(5000)
    mine, cam = program_scene.port_scene(arrays)
    theirs, cam2, _ = bench_scenes.conference_proxy(5000)
    for part in ("triangles", "materials", "lights"):
        a, b = getattr(mine, part), getattr(theirs, part)
        for f in a.__dataclass_fields__:
            assert torch.equal(getattr(a, f), getattr(b, f)), (part, f)
    for f in cam.__dataclass_fields__:
        assert torch.equal(getattr(cam, f), getattr(cam2, f)), f


@pytest.mark.parametrize("which", ["small_cell", "small_grad_cell"])
def test_program_passes_and_control_fails(which, request):
    """A few units of the program against the reference, then the
    reference in bfloat16 put in the program's place: the first within
    every limit, the second past at least one."""
    cell = request.getfixturevalue(which)
    d = cell.entry().Driver(cell.config, cell.traffic, 2**31 + 17, "cpu")
    d.setup()
    for i in range(2):
        d.unit(i)
    limits = cell.limits
    numbers = d.check()
    assert all(numbers[k] <= limits[k] for k in limits), numbers
    ctrl = d.control(1)
    assert any(ctrl[k] > limits[k] for k in limits), ctrl
    d.release()


def _stale(monkeypatch):
    """Every frame returns the first frame's answers: state unchanged."""
    from mobileraytracer_tpu_torch import renderer
    real, first = renderer.render_frame, {}

    def stale(*a, **k):
        if "out" not in first:
            first["out"] = real(*a, **k)
        return first["out"]
    monkeypatch.setattr(renderer, "render_frame", stale)


def _half(monkeypatch):
    """Half of each frame's lanes left out: traced on the first half only,
    the rest black, the rays of the half traced."""
    from mobileraytracer_tpu_torch import renderer
    real = renderer.trace_image_sample

    def half(scene, config, o, d, keys, *a, **k):
        h = o.shape[0] // 2
        rgb, rays = real(scene, config, o[:h], d[:h], keys[:h], *a, **k)
        return torch.cat([rgb, torch.zeros_like(rgb)]), rays
    monkeypatch.setattr(renderer, "trace_image_sample", half)


def _answer(monkeypatch):
    """The tile-MT kernel's closest hits altered where they are made."""
    from mobileraytracer_tpu_torch.ops import kernels
    real = kernels.traverse_tilemt

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[:, 0] = torch.where(out[:, 0] < 1e29, out[:, 0] * 1.001,
                                out[:, 0])
        return out
    monkeypatch.setattr(kernels, "traverse_tilemt", altered)


def _stale_grad(monkeypatch):
    """Every call returns the first call's gradient: state unchanged."""
    from mobileraytracer_tpu_torch.diff import geom
    real, first = geom.vertex_grad, {}

    def stale(*a, **k):
        if "out" not in first:
            first["out"] = real(*a, **k)
        return first["out"]
    monkeypatch.setattr(geom, "vertex_grad", stale)


def _half_grad(monkeypatch):
    """Half of the pixels left out of the interior, the mean taken over
    the rest."""
    from mobileraytracer_tpu_torch.diff import geom
    real = geom._interior

    def half(scene, camera, config, verts, keys, u, v, *a, **k):
        h = u.shape[0] // 2
        return real(scene, camera, config, verts, keys[:h], u[:h], v[:h],
                    *a, **k)
    monkeypatch.setattr(geom, "_interior", half)


def _draws_grad(monkeypatch):
    """The edge draws altered where they are made: each the next edge."""
    from mobileraytracer_tpu_torch.diff import geom
    real = geom._draw_edges

    def altered(key, w_e, budget):
        sel, mc_w = real(key, w_e, budget)
        return (sel + 1) % w_e.shape[0], mc_w
    monkeypatch.setattr(geom, "_draw_edges", altered)


def _flipped_grad(monkeypatch):
    """The interior gradient's sign flipped on every other triangle row
    where it is made: every leaf's norm unchanged."""
    from mobileraytracer_tpu_torch.diff import geom
    real = geom._interior

    def flipped(*a, **k):
        loss, g = real(*a, **k)
        sign = torch.ones_like(next(iter(g.values()))[:, :1])
        sign[1::2] = -1.0
        return loss, {key: x * sign for key, x in g.items()}
    monkeypatch.setattr(geom, "_interior", flipped)


@pytest.mark.parametrize("which, fault", [
    ("small_cell", _stale), ("small_cell", _half), ("small_cell", _answer),
    ("small_grad_cell", _stale_grad), ("small_grad_cell", _half_grad),
    ("small_grad_cell", _draws_grad), ("small_grad_cell", _flipped_grad)],
    ids=["whitted-state-unchanged", "whitted-half-the-batch",
         "whitted-answer-altered", "grad-state-unchanged",
         "grad-half-the-batch", "grad-answer-altered",
         "grad-rows-flipped"])
def test_a_broken_timed_path_is_not_correct(which, fault, request,
                                            monkeypatch):
    cell = request.getfixturevalue(which)
    fault(monkeypatch)
    res = harness.run_cell(cell, 2**31 + 23, 1.0, False, "cpu", started=0.0)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conference-512.whitted",
                                  "conference-vgrad-512.grad"])
def test_the_cell_on_the_card_is_correct(name, cuda_card):
    """One short run of each cell as committed (python3 -m pytest
    benchmark -m cuda runs them on the card)."""
    cell = harness.cell(name)
    res = harness.run_cell(cell, 2**31 + 29, 2.0, False, "cuda",
                           started=0.0,
                           device_kind=torch.cuda.get_device_name(0))
    assert res["correct"], res["checks"]
    assert all(np.isfinite(m["value"]) for m in res["metrics"].values())
