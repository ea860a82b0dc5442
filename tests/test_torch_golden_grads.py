"""The gradients that `chip_smoke.py` phase 10 holds the port against on the
GPU, committed as tests/data/torch_port_golden_grads.npz, and the port's
CPU gradients held against them.

    python tests/test_torch_golden_grads.py    # rewrites the file from JAX

Scene: cornell2 with material 0 (the yellow triangle) made emissive,
le = LE0, so that le has a gradient; 32x32, Whitted, 1 spp, over
ACC_NAIVE and over ACC_BVH (the JAX package's Pallas block BVH in
interpret mode; the port's `block_traversal.build` gives the same
triangle order).  For each accelerator the file holds:
  - `{acc}_loss`, `{acc}_kd`, `{acc}_le`: `train_step_sharded` on the
    one-device mesh at key 1 against TARGET (numpy seed 0);
  - `{acc}_vloss`, `{acc}_va`, `{acc}_vb`, `{acc}_vc`: `vertex_grad` at
    key 3 with VKW and `edge_keep=edge_topology(triangles)`: the
    silhouette term over 64 length-importance draws (the Gumbel-max draw)
    and the shadow term over 32.
Tolerances are those of tests/test_torch_diff_render.py.
"""
import pathlib

import numpy as np
import pytest
import torch

from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import sampling
from mobileraytracer_tpu_torch import scenes as tscenes
from mobileraytracer_tpu_torch.diff import geom as tgeom
from mobileraytracer_tpu_torch.ops import block_traversal as bt
from mobileraytracer_tpu_torch.parallel import mesh as tmesh
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig

torch.set_num_threads(2)

GOLDEN = (pathlib.Path(__file__).parent / "data"
          / "torch_port_golden_grads.npz")
LE0 = (1.5, 1.0, 0.5)
SIZE = 32
VKW = dict(edge_samples=4, edge_budget=64, shadow_edges=True,
           shadow_budget=32)
ACCS = {"naive": C.ACC_NAIVE, "bvh": C.ACC_BVH}
# Loss rtol; a gradient entry holds within rtol or ATOL_REL * max |g|.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
ATOL_REL = 1e-5


def target():
    return np.random.default_rng(0).uniform(
        0.0, 1.0, (SIZE, SIZE, 3)).astype(np.float32)


def config_kw(acc):
    return dict(width=SIZE, height=SIZE, spp=1, shader=C.SHADER_WHITTED,
                accelerator=ACCS[acc], scene_id=C.SCENE_CORNELL2)


def assert_grads_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), what
    atol = ATOL_REL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                               err_msg=what)


def port_scene(acc, device="cpu"):
    scene, cam = tscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    mats = scene.materials
    le = mats.le.clone()
    le[0] = torch.tensor(LE0)
    scene = scene.replace(materials=mats.replace(le=le))
    if acc == "bvh":
        return bt.build(scene, device=device), cam
    return scene.to(device), cam


def port_grads(acc, device="cpu"):
    """The port's counterpart of each golden entry."""
    scene, cam = port_scene(acc, device)
    cfg = TConfig(**config_kw(acc))
    loss, g = tmesh.train_step_sharded(scene, cam, cfg,
                                       sampling.prng_key(1, device),
                                       torch.from_numpy(target()))
    keep = tgeom.edge_topology(scene.triangles)
    vloss, vg = tgeom.vertex_grad(scene, cam, cfg,
                                  sampling.prng_key(3, device),
                                  edge_keep=keep, **VKW)
    out = {"loss": loss, "kd": g["kd"], "le": g["le"], "vloss": vloss}
    out.update(vg)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


@pytest.mark.parametrize("acc", list(ACCS))
def test_port_gradients_match_golden(acc):
    gold = np.load(GOLDEN)
    np.testing.assert_array_equal(gold["target"], target())
    np.testing.assert_array_equal(gold["le0"], np.float32(LE0))
    got = port_grads(acc)
    for k in ("loss", "vloss"):
        np.testing.assert_allclose(got[k], gold[f"{acc}_{k}"],
                                   rtol=LOSS_RTOL, err_msg=k)
    for k in ("kd", "le", "va", "vb", "vc"):
        assert_grads_close(got[k], gold[f"{acc}_{k}"], f"{acc} {k}")
    assert np.abs(gold[f"{acc}_le"]).max() > 0
    assert np.abs(gold[f"{acc}_va"]).max() > 0


def jax_golden():
    import jax
    import jax.numpy as jnp
    from mobileraytracer_tpu import scenes as jscenes
    from mobileraytracer_tpu.diff import geom as jgeom
    from mobileraytracer_tpu.ops import pallas_bvh as jpb
    from mobileraytracer_tpu.parallel import mesh as jmesh
    from mobileraytracer_tpu.types import RenderConfig as JConfig

    out = {"target": target(), "le0": np.float32(LE0)}
    for acc in ACCS:
        js, jc = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
        js = jax.device_put(js)
        le = jnp.asarray(js.materials.le).at[0].set(jnp.asarray(LE0))
        js = js.replace(materials=js.materials.replace(le=le))
        if acc == "bvh":
            js = jpb.build(js)
        cfg = JConfig(**config_kw(acc))
        loss, g = jmesh.train_step_sharded(
            js, jc, cfg, jax.random.PRNGKey(1), jnp.asarray(target()),
            jmesh.make_mesh(n_devices=1))
        keep = jgeom.edge_topology(js.triangles)
        vloss, vg = jgeom.vertex_grad(js, jc, cfg, jax.random.PRNGKey(3),
                                      edge_keep=keep, **VKW)
        out.update({f"{acc}_loss": loss, f"{acc}_kd": g["kd"],
                    f"{acc}_le": g["le"], f"{acc}_vloss": vloss})
        out.update({f"{acc}_{k}": vg[k] for k in vg})
        print(acc, float(loss), float(vloss), flush=True)
    return {k: np.asarray(v) for k, v in out.items()}


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDEN, **jax_golden())
