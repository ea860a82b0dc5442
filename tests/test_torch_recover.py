"""Material recovery of the PyTorch port against the JAX package on the
CPU: three `recover_materials` steps with torch.optim.Adam against optax's
adam, and optimizer checkpoints resumed across the two packages in both
directions.

Scene: cornell2 at 16x16, Whitted, ACC_NAIVE; kd starts flat at 0.5 and
moves toward a target from numpy (seed 0) at lr 0.05.  Tolerances: losses
rtol 1e-5; parameters and Adam moments within rtol 1e-4 or atol 1e-6
(PyTorch takes Adam's bias corrections in float64 and updates with lerp,
optax in float32).  Within one package a resumed run is bitwise equal to
an uninterrupted one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.parallel import mesh as jmesh
from mobileraytracer_tpu.parallel import recover as jrec
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import convert, sampling
from mobileraytracer_tpu_torch.parallel import recover as trec
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
from mobileraytracer_tpu_torch.utils import checkpoint as tckpt
from test_torch_render import arrays

torch.set_num_threads(2)

SIZE = 16
STEPS = 3
KW = dict(width=SIZE, height=SIZE, spp=1, shader=C.SHADER_WHITTED,
          accelerator=C.ACC_NAIVE, scene_id=C.SCENE_CORNELL2)
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def setup():
    js, jc = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    js = jax.device_put(js)
    target = np.random.default_rng(0).uniform(
        0.0, 1.0, (SIZE, SIZE, 3)).astype(np.float32)
    kd0 = np.full(np.asarray(js.materials.kd).shape, 0.5, np.float32)
    ts = convert.scene_from_arrays(arrays(js))
    tc = convert.camera_from_arrays(arrays(jc))
    return js, jc, ts, tc, target, kd0


def jax_run(setup, path, steps=STEPS, resume=False):
    js, jc, _, _, target, kd0 = setup
    return jrec.recover_materials(
        js, jc, JConfig(**KW), jnp.asarray(target),
        jmesh.make_mesh(n_devices=1), steps=steps, params_subset=("kd",),
        learning_rate=0.05, base_key=jax.random.PRNGKey(5),
        init_params={"kd": jnp.asarray(kd0)}, checkpoint_path=str(path),
        checkpoint_every=2, resume=resume)


def port_run(setup, path, steps=STEPS, resume=False):
    _, _, ts, tc, target, kd0 = setup
    return trec.recover_materials(
        ts, tc, TConfig(**KW), torch.from_numpy(target), steps=steps,
        params_subset=("kd",), learning_rate=0.05,
        base_key=sampling.prng_key(5),
        init_params={"kd": torch.from_numpy(kd0)},
        checkpoint_path=str(path), checkpoint_every=2, resume=resume)


def assert_params_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_recovery_and_checkpoints_match_jax(setup, tmp_path):
    jp, jlosses = jax_run(setup, tmp_path / "jax.npz")
    tp, tlosses = port_run(setup, tmp_path / "port.npz")
    assert len(tlosses) == STEPS and np.isfinite(tlosses).all()
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert_params_close(tp["kd"].numpy(), jp["kd"])
    assert np.abs(tp["kd"].numpy() - 0.5).max() > 0.01   # it moved

    # Both step-2 files: the same leaves (params.kd, count, mu.kd, nu.kd).
    jf, tf = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(jf.files) == sorted(tf.files) == sorted(
        ["leaf_0", "leaf_1", "leaf_2", "leaf_3", "opt_step", "losses"])
    for k in jf.files:
        assert jf[k].dtype == tf[k].dtype and jf[k].shape == tf[k].shape, k
    assert int(tf["leaf_1"]) == int(jf["leaf_1"]) == 2
    assert int(tf["opt_step"]) == int(jf["opt_step"]) == 2
    for k in ("leaf_0", "leaf_2", "leaf_3"):
        np.testing.assert_allclose(tf[k], jf[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)

    # Resumed in the other package: step 3 equals the uninterrupted run.
    tp_r, tlosses_r = port_run(setup, tmp_path / "jax.npz", resume=True)
    np.testing.assert_array_equal(tlosses_r[:2], jlosses[:2])
    np.testing.assert_allclose(tlosses_r, jlosses, rtol=LOSS_RTOL)
    assert_params_close(tp_r["kd"].numpy(), jp["kd"])
    jp_r, jlosses_r = jax_run(setup, tmp_path / "port.npz", resume=True)
    np.testing.assert_array_equal(jlosses_r[:2], tlosses[:2])
    np.testing.assert_allclose(jlosses_r, tlosses, rtol=LOSS_RTOL)
    assert_params_close(jp_r["kd"], tp["kd"].numpy())


def test_resumed_recovery_is_bitwise_uninterrupted(setup, tmp_path):
    """A run resumed from its own step-2 checkpoint equals the uninterrupted
    run bit for bit: the step's key is fold_in(key, s), and the file keeps
    Adam's moments and count exactly."""
    tp, tlosses = port_run(setup, tmp_path / "a.npz")
    tp_r, tlosses_r = port_run(setup, tmp_path / "a.npz", resume=True)
    assert torch.equal(tp["kd"], tp_r["kd"])
    np.testing.assert_array_equal(tlosses, tlosses_r)
    _, _, ts, _, _, _ = setup
    assert tckpt.load_opt_state(str(tmp_path / "missing.npz"),
                                trec.make_state({"kd": ts.materials.kd},
                                                0.05)) is None


def test_adam_state_converts_both_ways():
    """optax's (count, mu, nu) into torch.optim.Adam and back."""
    params, opt = trec.make_state({"kd": torch.zeros(4, 3)}, 0.05)
    mu = {"kd": np.arange(12, dtype=np.float32).reshape(4, 3)}
    nu = {"kd": np.full((4, 3), 0.25, np.float32)}
    convert.adam_from_optax(opt, params, np.int32(7), mu, nu)
    count, mu2, nu2 = convert.adam_to_optax(opt, params)
    assert count.dtype == np.int32 and int(count) == 7
    np.testing.assert_array_equal(mu2["kd"], mu["kd"])
    np.testing.assert_array_equal(nu2["kd"], nu["kd"])
    params["kd"].grad = torch.ones(4, 3)
    opt.step()
    assert float(opt.state[params["kd"]]["step"]) == 8.0
    fresh_params, fresh = trec.make_state({"kd": torch.zeros(2)}, 0.05)
    count, mu3, _ = convert.adam_to_optax(fresh, fresh_params)
    assert int(count) == 0 and not mu3["kd"].any()
