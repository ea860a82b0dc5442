"""The four CUDA traversal kernels against their plain PyTorch versions,
on the card.  Imports neither jax nor the JAX package, so it runs on a machine
with PyTorch for CUDA alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -s

(`--noconftest`: the repository's conftest configures jax.)  Every test
skips where torch.cuda is unavailable.
"""
import numpy as np
import pytest
import torch

from mobileraytracer_tpu_torch import bench_scenes, cameras
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import renderer
from mobileraytracer_tpu_torch.ops import block_traversal as bt
from mobileraytracer_tpu_torch.ops import kernels as K
from mobileraytracer_tpu_torch.types import RenderConfig

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see chip_smoke.py)")
    dev = torch.device("cuda")
    scene, cam, _ = bench_scenes.conference_proxy(target_prims=20000)
    scene = bt.build(scene, device=dev)
    u, v, _, _ = renderer._pixel_order(RenderConfig(width=64, height=64), dev)
    zero = torch.zeros_like(u)
    o, d = cameras.generate_rays(cam.to(dev), u, v, zero, zero)
    return scene, o, d


def _inputs(scene, o, d, st, any_hit):
    b = o.shape[0]
    t0 = torch.full((b,), 900.0 if any_hit else C.RAY_LENGTH_MAX,
                    device=o.device)
    pk = torch.zeros(b, dtype=torch.int32, device=o.device)
    pi = torch.full((b,), -1, dtype=torch.int32, device=o.device)
    rays, _ = bt._pack_rays(o, d, t0, pk, pi, K.TILE)
    top = dict(top_s=bt.TILE_TOP_S, top_m=bt.TILE_TOP_M) if st == K.TILE \
        else {}
    cg, _, ce, _ = bt._candidates(scene.bvh, rays[:, :3], rays[:, 3:6], st=st,
                                  **top)
    return scene.bvh.tb, cg, ce, rays, cg.shape[1], any_hit


@pytest.mark.cuda
def test_kernel_library_builds():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see chip_smoke.py)")
    from mobileraytracer_tpu_torch.ops import _build
    _build.load()
    print(_build.BUILD_INFO["log"])


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_tilemt_kernel_equals_plain(cuda_scene, any_hit):
    args = _inputs(*cuda_scene, K.TILE, any_hit)
    before = K.LAUNCHES["tilemt"]
    got = K.traverse_tilemt(*args)
    assert K.LAUNCHES["tilemt"] == before + 1
    want = K.tilemt_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert len(torch.unique(got[:, 2])) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_banded_kernel_equals_plain(cuda_scene, any_hit):
    args = _inputs(*cuda_scene, K.ST, any_hit)
    before = K.LAUNCHES["banded"]
    got = torch.stack(K.traverse_banded(*args))
    assert K.LAUNCHES["banded"] == before + 1
    want = torch.stack(K.banded_plain(*args))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert len(torch.unique(got[2])) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_tilebw_kernel_equals_plain(cuda_scene, any_hit):
    scene = cuda_scene[0]
    tb, cg, ce, rays, m, _ = _inputs(*cuda_scene, K.TILE, any_hit)
    args = (scene.bvh.tw, cg, ce, rays, m, any_hit, scene.bvh.t_margin)
    before = K.LAUNCHES["tilebw"]
    got = K.traverse_tile(*args)
    assert K.LAUNCHES["tilebw"] == before + 1
    want = K.tile_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert len(torch.unique(got[:, 7])) > 1


@pytest.mark.cuda
def test_resident_kernel_equals_plain(cuda_scene):
    scene = cuda_scene[0]
    _, cg, ce, rays, m, _ = _inputs(*cuda_scene, K.ST, True)
    tb_pad, starts, glist, n_parts = bt._resident_lists(scene.bvh, cg, ce)
    args = (tb_pad, starts, glist, rays, m, n_parts)
    before = K.LAUNCHES["resident"]
    got = torch.stack(K.traverse_resident(*args))
    assert K.LAUNCHES["resident"] == before + 1
    want = torch.stack(K.resident_plain(*args))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got[0] < rays[:, 6]).any())


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(cuda_scene):
    scene, o, d = cuda_scene
    K.reset_launches()
    b = o.shape[0]
    pk = torch.zeros(b, dtype=torch.int32, device=o.device)
    pi = torch.full((b,), -1, dtype=torch.int32, device=o.device)
    t, ids = bt.traverse_tilemt(scene.bvh, scene.triangles, o, d,
                                C.RAY_LENGTH_MAX, pk, pi)
    assert K.LAUNCHES["tilemt"] == 1
    assert np.isfinite(t.cpu().numpy()).all()
    assert (ids >= 0).float().mean() > 0.9
    t2, ids2 = bt.traverse_tile(scene.bvh, scene.triangles, o, d,
                                C.RAY_LENGTH_MAX, pk, pi)
    assert K.LAUNCHES["tilebw"] == 1
    assert torch.equal(ids2 >= 0, ids >= 0)
    md = torch.where(ids >= 0, t * 0.5, 1.0)
    occ = bt.traverse_resident(scene.bvh, scene.triangles, o, d, md, pk,
                               pi)[1] >= 0
    assert K.LAUNCHES["resident"] == 1
    occ_b = bt.traverse(scene.bvh, scene.triangles, o, d, md, pk, pi,
                        any_hit=True)[1] >= 0
    assert torch.equal(occ, occ_b)
