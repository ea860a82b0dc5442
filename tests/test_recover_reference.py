"""The benchmark's plain recovery step (benchmark/reference/recover.py)
against the port's `make_recovery_step` on the CPU: a seeded 3,000-triangle
conference proxy (all diffuse, 2 area lights) at 32x32 and 2 samples, the
PathTracer with NEE shared by 128 lanes on every step, every material's kD
and both lights' radiance recovered from values drawn from a seeded RNG.
Two steps agree with the reference in the loss, both gradients and the
parameters after each step; the radiance gradient agrees with the port's
own central differences (at 16x16); and the reference shaded in bfloat16
fails one of the cell's limits, so the check can see a broken step.
Imports neither jax nor the JAX package."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import program_scene
from benchmark.reference import pathtracer, proxy
from benchmark.reference import recover as ref_recover
from benchmark.reference import threefry as ref_tf
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import film, renderer, sampling
from mobileraytracer_tpu_torch.ops import block_traversal
from mobileraytracer_tpu_torch.parallel import mesh as pmesh
from mobileraytracer_tpu_torch.parallel import recover
from mobileraytracer_tpu_torch.types import RenderConfig

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMITS = json.loads((ROOT / "benchmark" / "limits"
                     / "conference-ptrecover-512.materials.json").read_text())
SIZE, SPP, SEED, LR = 32, 2, 2**31 + 201, 0.05
FD_SIZE = 16
CPU = torch.device("cpu")
CONFIG = RenderConfig(width=SIZE, height=SIZE, spp=SPP,
                      shader=C.SHADER_PATHTRACER, accelerator=C.ACC_BVH,
                      nee_share=128, nee_reverse=True,
                      nee_share_secondary=True)
UPPER = {"kd": 1.0, "radiance": None}
# Float32 sums of the same terms in another order (the loss over 3,072
# pixel channels, autograd's scatter-adds into the kD and radiance rows,
# the reference's blocks): a few ulps of the result, far under the
# bfloat16 control's 1e-4 (loss) and 5e-3 (gradients).
LOSS_REL, GRAD_REL = 1e-6, 1e-5
# Adam divides by sqrt(v): a gradient's relative rounding moves the step
# by at most lr times it, on parameters of 0.2-1.5.
PARAMS_REL = 1e-6


@pytest.fixture(scope="module")
def setup():
    arrays = proxy.conference_proxy(3000, seed=7)
    scene, cam = program_scene.port_scene(arrays)
    scene = block_traversal.build(scene, device=CPU)
    rng = np.random.default_rng(3)
    kd = torch.from_numpy(rng.uniform(0.2, 0.9, (3, 3)).astype(np.float32))
    rad = torch.from_numpy(rng.uniform(0.5, 1.5, (2, 3)).astype(np.float32))
    start = {"kd": scene.materials.kd.clone(),
             "radiance": scene.lights.radiance.clone()}
    start["kd"][:3], start["radiance"][:2] = kd, rad
    target = torch.from_numpy(rng.uniform(0.0, 1.0, (SIZE, SIZE, 3))
                              .astype(np.float32))
    return arrays, scene, cam, start, target


def _snapshot(state):
    params, opt = state
    out = {"params": {}, "m": {}, "step": 0}
    for k, p in params.items():
        st = opt.state.get(p, {})
        out["params"][k] = p.detach().clone()
        zero = torch.zeros_like(p)
        out["m"][k] = ((st["exp_avg"].clone(), st["exp_avg_sq"].clone())
                       if st else (zero, zero))
        out["step"] = int(st["step"]) if st else 0
    return out


ROWS = {"kd": 3, "radiance": 2}


def _rows(x, n=ROWS):
    return {k: x[k][:n[k]] for k in n}


def _ref_step(arrays, i, before, target, shade=None):
    """The reference's step i (shaded in `shade`) from the state `before`,
    cut to the scene's rows, with Adam's update in "after"."""
    params = _rows(before["params"])
    out = ref_recover.loss_and_grads(
        pathtracer.Scene(arrays, device=CPU), params,
        ref_tf.fold_in(ref_tf.prng_key(SEED), i), target, SIZE, SIZE, SPP,
        shade=shade)
    moments = {k: tuple(m[:ROWS[k]] for m in before["m"][k]) for k in ROWS}
    out["after"] = ref_recover.adam(params, out["grads"], moments,
                                    before["step"], LR, UPPER)
    return out


@pytest.fixture(scope="module")
def steps(setup):
    """Two `make_recovery_step` steps from the start: each with the state
    before it, its loss, gradients and parameters after it, and the
    reference's float32 step from that state."""
    arrays, scene, cam, start, target = setup
    step_fn, _ = recover.make_recovery_step(
        scene, cam, CONFIG, params_subset=("kd", "radiance"),
        learning_rate=LR)
    state = recover.make_state(start, LR)
    base = sampling.prng_key(SEED, CPU)
    out = []
    for i in range(2):
        before = _snapshot(state)
        state, loss = step_fn(state, sampling.fold_in(base, i), target)
        params = state[0]
        out.append({"before": before, "loss": float(loss),
                    "grads": {k: p.grad.clone() for k, p in params.items()},
                    "after": {k: p.detach().clone()
                              for k, p in params.items()},
                    "ref": _ref_step(arrays, i, before, target)})
    return out


def test_two_steps_match_the_reference(setup, steps):
    start = setup[3]
    for i, st in enumerate(steps):
        ref = st["ref"]
        assert st["before"]["step"] == i
        assert abs(st["loss"] - ref["loss"]) <= LOSS_REL * ref["loss"]
        assert ref_recover._rows_rel(st["grads"], ref["grads"]) <= GRAD_REL
        assert ref_recover._rows_rel(st["after"], ref["after"]) <= PARAMS_REL
        assert float(ref["grads"]["radiance"].abs().min()) > 0
        for k, n in ROWS.items():          # the padding never moves
            assert torch.equal(st["after"][k][n:], start[k][n:])
    params = steps[-1]["after"]
    assert float(params["radiance"].min()) >= 0.0
    assert float((params["kd"] - start["kd"]).abs().max()) > 0.01


def test_radiance_gradient_matches_central_differences(setup):
    """The film is linear in the radiance (each path's radiance is, and a
    positive radiance changes no decision), so the loss is quadratic in it
    and a central difference is its derivative.  The port renders the
    films in float32; the loss of each and the differences are taken in
    float64, so what is left is each pixel's float32 rounding.  At 16x16
    (what is checked does not depend on the size, and a render at 32x32
    takes twice as long on the CPU), along one seeded direction over both
    lights' (r, g, b) rows, a row each in its own proportions."""
    _, scene, cam, start, target = setup
    config = dataclasses.replace(CONFIG, width=FD_SIZE, height=FD_SIZE)
    key = sampling.fold_in(sampling.prng_key(SEED, CPU), 5)
    prep = pmesh.prepared(scene, cam, config, key,
                          target[:FD_SIZE, :FD_SIZE].contiguous())
    full = dict(pmesh.material_params(scene.materials, scene.lights),
                **start)
    _, grads = pmesh.loss_and_grads(full, scene, config, prep,
                                    ("kd", "radiance"))

    def loss_at(rad):
        scene_r = pmesh._scene_with_params(scene, dict(full, radiance=rad))
        acc = torch.zeros((FD_SIZE * FD_SIZE, 3))
        with torch.no_grad():
            for s in range(SPP):
                rgb, _ = renderer.sample_pixels(
                    scene_r, prep["camera"], config, prep["key"], s,
                    prep["u"], prep["v"], prep["pids"], differentiable=True)
                acc = film.incremental_avg_float(acc, rgb, s + 1)
        gap = acc.double() - prep["target"].double()
        return float((gap * gap).sum()) / prep["denom"]

    rng = np.random.default_rng(11)
    step = torch.zeros_like(start["radiance"])
    step[:2] = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 3))
                                .astype(np.float32)) * 0.25
    fd = (loss_at(start["radiance"] + step)
          - loss_at(start["radiance"] - step)) / 2.0
    g = grads["radiance"].double()
    assert float(g[:2].abs().min()) > 0          # both lights' rows
    g = float((g * step.double()).sum())
    assert abs(fd - g) <= 1e-4 * abs(g), (fd, g)


def test_bfloat16_shading_fails_a_limit(setup, steps):
    """The control: the reference shaded in bfloat16 in the program's
    place for the second step of a run, from the state the first step
    left, as the entry's control takes it: the gradients and the film
    read off (at 32x32 the loss and the update may not; at 512x512 they
    do, PERF.md).  The entry holds the target apart (its
    `target_pixels_off_ppm`), so a step's numbers are the others."""
    arrays, target = setup[0], setup[4]
    second = steps[1]
    numbers = ref_recover.numbers(
        _ref_step(arrays, 1, second["before"], target, torch.bfloat16),
        second["ref"])
    assert set(numbers) == set(LIMITS) - {"target_pixels_off_ppm"}
    off = {k for k in numbers if numbers[k] > LIMITS[k]}
    assert off >= {"grad_rel", "pixels_off_ppm"}, numbers
