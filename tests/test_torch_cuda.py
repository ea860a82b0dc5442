"""The four CUDA traversal kernels, the Gumbel-max draw kernel and the
candidate-window kernel against their plain PyTorch versions, on the
card, and frames of the PathTracer and of the grid and escape-index BVH on
the card.  Imports neither jax nor the JAX package (nor does
test_torch_kernel_design, whose hand-made blocks it uses), so it runs on
a machine with PyTorch for CUDA alone (the last test starts two ranks of
tests/torch_mesh_worker.py, which imports no jax either):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -s

(`--noconftest`: the repository's conftest configures jax.)  Every test
skips where torch.cuda is unavailable.
"""
import pathlib

import numpy as np
import pytest
import torch

from mobileraytracer_tpu_torch import bench_scenes, cameras, sampling, scenes
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import renderer, threefry
from mobileraytracer_tpu_torch.ops import block_traversal as bt
from mobileraytracer_tpu_torch.ops import bvh, grid
from mobileraytracer_tpu_torch.ops import kernels as K
from mobileraytracer_tpu_torch.types import RenderConfig, Triangles
from test_torch_kernel_design import bw_blocks, bw_rays

torch.set_num_threads(2)

EDGE_TILE = (pathlib.Path(__file__).parent / "data"
             / "torch_port_shadow_tile_edge.npy")


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
@pytest.mark.parametrize("g_n", [1, 2, 4, 8, 16, 32])
def test_resident_kernel_equals_plain_at_g_n(cuda_scene, g_n):
    """The resident kernel with g_n bands a program (res_group), bitwise
    its plain version; traverse_resident's occlusion equals traverse's."""
    scene, o, d = cuda_scene
    _, cg, ce, rays, m, _ = _inputs(scene, o, d, K.ST, True)
    tb_pad, starts, glist, n_parts = bt._resident_lists(scene.bvh, cg, ce)
    args = (tb_pad, starts, glist, rays, m, n_parts, g_n)
    before = K.LAUNCHES["resident"]
    got = torch.stack(K.traverse_resident(*args))
    assert K.LAUNCHES["resident"] == before + 1
    want = torch.stack(K.resident_plain(*args))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    b = o.shape[0]
    pk = torch.zeros(b, dtype=torch.int32, device=o.device)
    pi = torch.full((b,), -1, dtype=torch.int32, device=o.device)
    md = torch.full((b,), 900.0, device=o.device)
    occ = bt.traverse_resident(scene.bvh, scene.triangles, o, d, md, pk, pi,
                               res_group=g_n)[1] >= 0
    occ_b = bt.traverse(scene.bvh, scene.triangles, o, d, md, pk, pi,
                        any_hit=True)[1] >= 0
    assert torch.equal(occ, occ_b)


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
    # One window a traversal kernel launch: tile-MT's, and each refill
    # loop's before its banded launch.
    assert K.LAUNCHES["window"] == 1 + K.LAUNCHES["banded"]
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
    from mobileraytracer_tpu_torch.diff import geom
    w_e = torch.rand(5000, generator=torch.Generator().manual_seed(0))
    sel, _ = geom._draw_edges(sampling.prng_key(1, o.device),
                              w_e.to(o.device), 64)
    assert K.LAUNCHES["gumbel"] == 1
    assert sel.device == o.device and sel.shape == (64,)


# ---------------------------------------------------------------------------
# The banded and tile-MT kernels on inputs that reach their early exits,
# the clamped prefetch, the split-round merge and the tile order.
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see chip_smoke.py)")
    return torch.device("cuda")


def _both_equal_plain(tb, rays, lists, any_hit):
    """Runs tile-MT and banded on `rays` ((Bp, 8), Bp a multiple of 128)
    with lists = {K.TILE: (cg, ce), K.ST: (cg, ce)} and asserts each
    equals its plain version bit for bit.  Returns the two outputs."""
    cg, ce = lists[K.TILE]
    args = (tb, cg, ce, rays, cg.shape[1], any_hit)
    got_t = K.traverse_tilemt(*args)
    assert torch.equal(got_t, K.tilemt_plain(*args))
    cg, ce = lists[K.ST]
    args = (tb, cg, ce, rays, cg.shape[1], any_hit)
    got_b = torch.stack(K.traverse_banded(*args))
    assert torch.equal(got_b, torch.stack(K.banded_plain(*args)))
    return got_t, got_b


def _windows(bvh, rays):
    out = {}
    for st in (K.TILE, K.ST):
        top = dict(top_s=bt.TILE_TOP_S, top_m=bt.TILE_TOP_M) \
            if st == K.TILE else {}
        cg, _, ce, _ = bt._candidates(bvh, rays[:, :3], rays[:, 3:6], st=st,
                                      **top)
        out[st] = (cg, ce)
    return out


def _soup_with_twins(n, dev):
    """n random triangles whose last quarter repeats the first quarter
    exactly, so coincident pairs tie at the same t."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (n, 3))
    ab = rng.uniform(-0.3, 0.3, (n, 3))
    ac = rng.uniform(-0.3, 0.3, (n, 3))
    q = n // 4
    for x in (a, ab, ac):
        x[n - q:] = x[:q]
    f = lambda x: torch.from_numpy(x.astype(np.float32))
    tris = Triangles(
        point_a=f(a), ab=f(ab), ac=f(ac), normal_a=torch.zeros(n, 3),
        normal_b=torch.zeros(n, 3), normal_c=torch.zeros(n, 3),
        uv_a=torch.full((n, 2), -1.0), uv_b=torch.full((n, 2), -1.0),
        uv_c=torch.full((n, 2), -1.0), mat_id=torch.zeros(n, dtype=torch.int32),
        valid=torch.ones(n, dtype=torch.bool))
    _, grid = bt.build_blocks(tris)
    return grid.to(dev)


def _rays(o, d, t0, prev=None):
    prev = torch.full_like(t0, -1.0) if prev is None else prev
    return torch.cat([o, d, t0[:, None], prev[:, None]], 1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernels_equal_plain_on_soup_with_coincident_twins(any_hit):
    dev = _need_cuda()
    grid = _soup_with_twins(120000, dev)
    rng = np.random.default_rng(5)
    b = 1024
    o = torch.from_numpy(rng.uniform(-2, 2, (b, 3)).astype(np.float32))
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    t0 = torch.full((b,), 1.0 if any_hit else C.RAY_LENGTH_MAX)
    rays = _rays(o, d, t0).to(dev)
    got_t, got_b = _both_equal_plain(grid.tb, rays, _windows(grid, rays),
                                     any_hit)
    assert (got_t[:, 1] >= 0).sum() > b // 20
    # Rays whose previous slot is their hit: the kernels must skip it.
    prev = torch.where(got_t[:, 1] >= 0, got_t[:, 1], -1.0)
    rays2 = _rays(o.to(dev), d.to(dev), t0.to(dev), prev)
    got_t2, _ = _both_equal_plain(grid.tb, rays2, _windows(grid, rays2),
                                  any_hit)
    hit = prev >= 0
    assert not bool((got_t2[hit, 1] == prev[hit]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernels_equal_plain_on_the_shadow_edge_tile(any_hit):
    dev = _need_cuda()
    scene, _, _ = bench_scenes.conference_proxy()
    scene = bt.build(scene, device=dev)
    a = torch.from_numpy(np.load(EDGE_TILE)).to(dev)
    prev = torch.where(a[:, 7] == C.PRIM_TRIANGLE, a[:, 8], -1.0)
    t0 = a[:, 6] if any_hit else torch.full_like(a[:, 6], C.RAY_LENGTH_MAX)
    rays = _rays(a[:, 0:3], a[:, 3:6], t0, prev)
    _both_equal_plain(scene.bvh.tb, rays, _windows(scene.bvh, rays),
                      any_hit)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 6])
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernels_equal_plain_on_short_and_repeated_lists(m, any_hit):
    """Hand-made lists: one entry, or six that name the same few blocks
    again and again, with equal entry distances; one program each (as the
    refill sends) and a batch of several."""
    dev = _need_cuda()
    scene, cam, _ = bench_scenes.conference_proxy(target_prims=20000)
    scene = bt.build(scene, device=dev)
    u, v, _, _ = renderer._pixel_order(RenderConfig(width=32, height=32),
                                       dev)
    zero = torch.zeros_like(u)
    o, d = cameras.generate_rays(cam.to(dev), u, v, zero, zero)
    t0 = torch.full((o.shape[0],), 900.0 if any_hit else C.RAY_LENGTH_MAX,
                    device=dev)
    rays = _rays(o, d, t0)
    nb = scene.bvh.tb.shape[0]
    gen = torch.Generator().manual_seed(m)
    for bp in (K.TILE, rays.shape[0]):
        lists = {}
        for st in (K.TILE, K.ST):
            rows = bp // st
            cg = torch.randint(0, 3, (rows, m), generator=gen) * (nb // 3)
            ce = torch.sort(torch.randint(0, 2, (rows, m), generator=gen)
                            .float() * 100.0, 1).values
            lists[st] = (cg.to(torch.int32).to(dev), ce.to(dev))
        got_t, got_b = _both_equal_plain(scene.bvh.tb, rays[:bp], lists,
                                         any_hit)
        assert int(got_t[:, 2].max()) <= m and int(got_b[2].max()) <= m


@pytest.mark.cuda
def test_kernels_stop_after_round_zero_when_every_ray_is_occluded():
    """Each ray aims at the centre of a triangle of block 0, which heads
    every list: after round 0 every ray is occluded, so both kernels stop
    there (any-hit)."""
    dev = _need_cuda()
    scene, _, _ = bench_scenes.conference_proxy(target_prims=20000)
    scene = bt.build(scene, device=dev)
    tb = scene.bvh.tb
    blk = tb[0]
    area = torch.cross(blk[3:6].T, blk[6:9].T, dim=1).norm(dim=1)
    lanes = torch.nonzero((blk[9] > 0.5) & (area > 1e-6))[:, 0]
    b = 2 * K.TILE
    pick = lanes[torch.arange(b, device=dev) % lanes.numel()]
    centre = blk[0:3, pick].T + (blk[3:6, pick].T + blk[6:9, pick].T) / 3.0
    normal = torch.cross(blk[3:6, pick].T, blk[6:9, pick].T, dim=1)
    normal = normal / normal.norm(dim=1, keepdim=True)
    o = centre + normal
    d = -normal
    rays = _rays(o, d, torch.full((b,), 10.0, device=dev))
    nb = tb.shape[0]
    lists = {}
    for st in (K.TILE, K.ST):
        rows = b // st
        cg = torch.arange(4, device=dev, dtype=torch.int32)[None, :] \
            * (nb // 4)
        ce = torch.arange(4, device=dev, dtype=torch.float32)[None, :]
        lists[st] = (cg.expand(rows, 4).contiguous(),
                     ce.expand(rows, 4).contiguous())
    got_t, got_b = _both_equal_plain(tb, rays, lists, True)
    assert bool((got_t[:, 0] < 10.0).all())
    assert int(got_t[:, 2].max()) == 1 and int(got_b[2].max()) == 1


# ---------------------------------------------------------------------------
# The tilebw and resident kernels on inputs that reach their trims, their
# single-pass top-3 and its full reruns, and the resident lockstep across
# partitions.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_tilebw_kernel_equals_plain_on_hand_made_blocks(any_hit):
    """Blocks with exact ties at equal t, counts that are not multiples of
    4 or 32, a block with no valid lane, lanes at t = 1e30 seen with
    t_init = 1e30 (the slot resets), and a slot repeated among tracked
    lanes, walked in random orders by tiles of rays that do and do not
    reach them."""
    dev = _need_cuda()
    tw, far, dup = bw_blocks(0)
    rng = np.random.default_rng(7)
    n_tiles, m = 6, 5
    rays = np.concatenate([bw_rays(rng, K.TILE, C.RAY_LENGTH_MAX if i % 2
                                   else 4.0) for i in range(n_tiles)])
    rays[:K.TILE, 3:6] = [0.0, 0.0, 1.0]      # tile 0 tracks the far lanes
    rays[:K.TILE, 6] = C.RAY_LENGTH_MAX
    cg = np.stack([rng.permutation(tw.shape[0])[:m] for _ in range(n_tiles)])
    cg[0], cg[1, 0] = far, dup
    ce = np.sort(rng.uniform(0.0, 3.0, (n_tiles, m)), 1)
    ce[:2] = 0.0
    args = (torch.from_numpy(tw).to(dev),
            torch.from_numpy(cg.astype(np.int32)).to(dev),
            torch.from_numpy(ce.astype(np.float32)).to(dev),
            torch.from_numpy(rays).to(dev), m, any_hit, 1e-4)
    before = K.LAUNCHES["tilebw"]
    got = K.traverse_tile(*args)
    assert K.LAUNCHES["tilebw"] == before + 1
    want = K.tile_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert len(torch.unique(got[:, 7])) > 1
    # Tile 0 walks only the far block: its nearest t is 1e30, which is not
    # below 1e30, so its slot resets to -1.
    assert bool((got[:K.TILE, 0] == C.RAY_LENGTH_MAX).all())
    assert bool((got[:K.TILE, 1] == -1.0).all())


@pytest.mark.cuda
def test_resident_kernel_equals_plain_across_partitions():
    """The 120k soup spans several 640-block partitions; some bands list no
    block in a partition where another band of their program does, so they
    keep testing their clamped block while the program runs."""
    dev = _need_cuda()
    grid = _soup_with_twins(120000, dev)
    rng = np.random.default_rng(9)
    b = 2048
    o = torch.from_numpy(rng.uniform(-2, 2, (b, 3)).astype(np.float32))
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    t0 = torch.from_numpy(rng.uniform(0.2, 2.0, b).astype(np.float32))
    rays = _rays(o, d, t0).to(dev)
    cg, _, ce, _ = bt._candidates(grid, rays[:, :3], rays[:, 3:6], st=K.ST)
    tb_pad, starts, glist, n_parts = bt._resident_lists(grid, cg, ce)
    assert n_parts >= 2
    runs = (starts[:, 1:] - starts[:, :-1]).reshape(-1, K.GROUP, n_parts)
    empty_beside_busy = (runs == 0) & (runs > 0).any(1, keepdim=True)
    assert bool(empty_beside_busy.any())
    for prev in (None, torch.full_like(t0, -1.0)):
        if prev is not None:     # rays whose previous slot is their blocker
            occ_t, occ_s = K.traverse_resident(tb_pad, starts, glist, rays,
                                               cg.shape[1], n_parts)
            blocker = torch.where(occ_t < rays[:, 6][None], occ_s, -1.0)
            prev = blocker.amax(0)
            rays = _rays(o.to(dev), d.to(dev), t0.to(dev), prev)
        args = (tb_pad, starts, glist, rays, cg.shape[1], n_parts)
        before = K.LAUNCHES["resident"]
        got = torch.stack(K.traverse_resident(*args))
        assert K.LAUNCHES["resident"] == before + 1
        want = torch.stack(K.resident_plain(*args))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert bool((got[0] < rays[:, 6]).any())


# ---------------------------------------------------------------------------
# The PathTracer and the other accelerators on the card.
# ---------------------------------------------------------------------------

SHADERS_GOLDEN = (pathlib.Path(__file__).parent / "data"
                  / "torch_port_golden_shaders64.npz")
# As in test_torch_pathtracer.py (which imports jax): a pixel holds when
# |port - golden| <= 1e-4 + 1e-3 |golden|, and 99.9% of pixels hold.
PT_ATOL, PT_RTOL, PT_FRACTION = 1e-4, 1e-3, 0.999


def _pt_match(img, ref):
    assert np.isfinite(img).all()
    ok = (np.abs(img - ref) <= PT_ATOL + PT_RTOL * np.abs(ref)).all(-1)
    assert ok.mean() >= PT_FRACTION, np.abs(img - ref).max()


@pytest.mark.cuda
def test_pathtracer_golden_on_the_card():
    dev = _need_cuda()
    ts, tc = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    cfg = RenderConfig(width=64, height=64, spp=2,
                       shader=C.SHADER_PATHTRACER, accelerator=C.ACC_BVH,
                       nee_share=128, nee_share_secondary=True)
    K.reset_launches()
    out = renderer.render_frame(bt.build(ts, device=dev), tc.to(dev), cfg,
                                sampling.prng_key(0, dev))
    assert K.LAUNCHES["tilemt"] > 0 and K.LAUNCHES["banded"] > 0
    golden = np.load(SHADERS_GOLDEN)
    assert int(out["rays"]) == int(golden["pathtracer_rays"])
    _pt_match(out["image"].cpu().numpy(), golden["pathtracer"])


@pytest.mark.cuda
@pytest.mark.parametrize("secondary", [True, False])
def test_pathtracer_step_graphs_equal_op_by_op_steps(secondary):
    """The compacted walk's chunk steps replayed as CUDA graphs, with the
    speculative refill, give the frame of the op-by-op steps bit for bit,
    and the same ray count."""
    from mobileraytracer_tpu_torch.shaders import engine
    dev = _need_cuda()
    scene, cam, _ = bench_scenes.conference_proxy(target_prims=20000)
    scene = bt.build(scene, device=dev)
    cfg = RenderConfig(width=64, height=64, spp=2,
                       shader=C.SHADER_PATHTRACER, accelerator=C.ACC_BVH,
                       nee_share=128, nee_reverse=True,
                       nee_share_secondary=secondary)
    key = sampling.prng_key(11, dev)
    frames = []
    for graphs in (True, False):
        engine.GRAPH_STEPS = graphs
        replays = engine.GRAPH["replays"]
        try:
            out = renderer.render_frame(scene, cam.to(dev), cfg, key)
        finally:
            engine.GRAPH_STEPS = True
        assert (engine.GRAPH["replays"] > replays) == graphs
        frames.append((out["image"].cpu().numpy(), int(out["rays"])))
    engine.clear_graphs()
    np.testing.assert_array_equal(frames[0][0], frames[1][0])
    assert frames[0][1] == frames[1][1]


@pytest.mark.cuda
def test_step_graphs_key_on_every_field_of_the_scene():
    """Two scenes on the same tensors whose block grids differ only in
    `top_m` get a step graph each: with both scenes' graphs cached, each
    scene's PathTracer sample equals its op-by-op sample in image, rays
    and the refill's loops and rays, and equals in REFILL, LAUNCHES and
    GRAPH the sample replayed from graphs captured for that scene alone.
    (The speculative refill's fixed loops launch other lanes and kernels
    than the op-by-op loops, so those two are held to the graphs alone.)
    """
    import dataclasses
    from mobileraytracer_tpu_torch.shaders import engine
    dev = _need_cuda()
    scene, cam, _ = bench_scenes.conference_proxy(target_prims=20000)
    scene = bt.build(scene, device=dev)
    other = scene.replace(bvh=dataclasses.replace(scene.bvh, top_m=24))
    assert other.bvh.top_m != scene.bvh.top_m
    cam = cam.to(dev)
    cfg = RenderConfig(width=64, height=64, spp=1,
                       shader=C.SHADER_PATHTRACER, accelerator=C.ACC_BVH,
                       nee_share=128, nee_reverse=True)
    key = sampling.prng_key(11, dev)

    def sample(sc, graphs):
        before = (dict(bt.REFILL), dict(K.LAUNCHES), dict(engine.GRAPH))
        engine.GRAPH_STEPS = graphs
        try:
            out = renderer.render_frame(sc, cam, cfg, key)
        finally:
            engine.GRAPH_STEPS = True
        counts = [{k: v - b[k] for k, v in now.items()} for now, b in zip(
            (bt.REFILL, K.LAUNCHES, engine.GRAPH), before)]
        return out["image"].cpu().numpy(), int(out["rays"]), counts

    scenes_ = (scene, other)
    op = [sample(sc, False) for sc in scenes_]
    alone = []
    for sc in scenes_:
        engine.clear_graphs()
        sample(sc, True)
        alone.append(sample(sc, True))
    engine.clear_graphs()
    for sc in scenes_:
        sample(sc, True)
    try:
        for sc, o, a in zip(scenes_, op, alone):
            img, rays, counts = sample(sc, True)
            assert counts[2]["replays"] > 0
            np.testing.assert_array_equal(img, o[0])
            assert rays == o[1]
            assert {k: counts[0][k] for k in ("loops", "rays")} == \
                {k: o[2][0][k] for k in ("loops", "rays")}
            assert counts == a[2]
            np.testing.assert_array_equal(img, a[0])
    finally:
        engine.clear_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("shader", [C.SHADER_WHITTED, C.SHADER_PATHTRACER,
                                    C.SHADER_DEPTHMAP])
def test_grid_and_escape_bvh_frames_on_the_card(shader):
    dev = _need_cuda()
    ts, tc = scenes.load_builtin(C.SCENE_CORNELL, 1.0)
    mp = torch.from_numpy(scenes.DEPTHMAP_MAX_POINT[C.SCENE_CORNELL])
    frames = {}
    for acc, scene in ((C.ACC_NAIVE, ts.to(dev)),
                       (C.ACC_REGULAR_GRID, grid.build_grid(ts, device=dev)),
                       (C.ACC_BVH, bvh.build(ts, device=dev))):
        cfg = RenderConfig(width=32, height=32, shader=shader,
                           accelerator=acc, nee_share=128,
                           nee_share_secondary=True)
        out = renderer.render_frame(scene, tc.to(dev), cfg,
                                    sampling.prng_key(0, dev), mp)
        frames[acc] = (out["image"].cpu().numpy(), int(out["rays"]))
    ref, rays = frames[C.ACC_NAIVE]
    for acc in (C.ACC_REGULAR_GRID, C.ACC_BVH):
        assert frames[acc][1] == rays
        _pt_match(frames[acc][0], ref)


@pytest.mark.cuda
def test_lane_tables_cached_on_the_card():
    """The 512² lane tables on the card equal a fresh CPU build bitwise; a
    cache hit ("cuda" and cuda:<index> are one key) hands out the same
    tensors without a sync, and a warm frame builds no table."""
    dev = _need_cuda()
    cfg = RenderConfig(width=512, height=512)
    card = renderer._pixel_order(cfg, dev)
    fresh = renderer._build_order(512, 512, torch.device("cpu"))
    for a, b in zip(card, fresh):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)
    reused = renderer.ORDER["reused"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        hit = renderer._pixel_order(
            cfg, torch.device("cuda", torch.cuda.current_device()))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(a is b for a, b in zip(hit, card))
    assert renderer.ORDER["reused"] == reused + 1

    ts, tc = scenes.load_builtin(C.SCENE_CORNELL, 1.0)
    fcfg = RenderConfig(width=32, height=32, shader=C.SHADER_WHITTED,
                        accelerator=C.ACC_NAIVE)
    key = sampling.prng_key(0, dev)
    first = renderer.render_frame(ts.to(dev), tc.to(dev), fcfg, key)
    built = renderer.ORDER["built"]
    warm = renderer.render_frame(ts.to(dev), tc.to(dev), fcfg, key)
    assert renderer.ORDER["built"] == built
    assert torch.equal(first["image"], warm["image"])


def _gumbel_plain(key, logits, k, table):
    return threefry.categorical(key, logits, k, table=table)


def _plain_kernels():
    """Puts the plain versions in the tile-MT, banded, Gumbel-max and
    window kernels' place; returns the function that puts the wrappers
    back."""
    saved = (K.traverse_tilemt, K.traverse_banded, K.gumbel_argmax,
             bt._candidates)
    K.traverse_tilemt, K.traverse_banded, K.gumbel_argmax = (
        K.tilemt_plain, K.banded_plain, _gumbel_plain)
    bt._candidates = bt._candidates_plain

    def restore():
        (K.traverse_tilemt, K.traverse_banded, K.gumbel_argmax,
         bt._candidates) = saved
    return restore


# ---------------------------------------------------------------------------
# The Gumbel-max draw kernel (csrc/gumbel_argmax.cu) against
# threefry.categorical: a tile is 2,048 columns by 16 rows, and columns
# 256 apart share a thread.
# ---------------------------------------------------------------------------

def _draw_inputs(e, dev):
    rng = np.random.default_rng(e)
    logits = torch.from_numpy(
        np.log(rng.uniform(1e-3, 2.0, e)).astype(np.float32)).to(dev)
    return sampling.fold_in(sampling.prng_key(3, dev), 0x5ED6E), logits


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 300, 1024])
@pytest.mark.parametrize("e", [1, 37, 5000, 993552])
def test_gumbel_kernel_equals_plain(e, k):
    dev = _need_cuda()
    key, logits = _draw_inputs(e, dev)
    table = threefry._gumbel_table(dev)
    before = K.LAUNCHES["gumbel"]
    got = K.gumbel_argmax(key, logits, k, table)
    assert K.LAUNCHES["gumbel"] == before + 1
    want = threefry.categorical(key, logits, k)
    assert torch.equal(got, want)
    if e > 1 and k > 1:
        assert len(torch.unique(got)) > 1


@pytest.mark.cuda
def test_gumbel_kernel_equals_plain_past_two_to_the_32():
    """k E > 2^32: the rows past the boundary hash counts whose hi word
    is 1."""
    dev = _need_cuda()
    e, k = 993552, 4600
    assert (k - 200) * e > 2 ** 32
    key, logits = _draw_inputs(e, dev)
    got = K.gumbel_argmax(key, logits, k, threefry._gumbel_table(dev))
    assert torch.equal(got, threefry.categorical(key, logits, k))


@pytest.mark.cuda
@pytest.mark.parametrize("zero", [0.0, -0.0])
def test_gumbel_kernel_ties_go_to_the_first_column(zero):
    """An all-zero table (+0.0 or -0.0) leaves each row's values the
    logits: their maximum, 0, sits at columns in one warp, one thread
    and three tiles, -0.0 at the first and +0.0 at the others.  Every row
    draws the first, as the plain version does; and a NaN logit, larger
    than any value for torch.argmax, is drawn at its first column."""
    dev = _need_cuda()
    e, k = 20000, 300
    logits = -torch.linspace(1.0, 2.0, e)
    ties = [3001, 3002, 3257, 9000, 17999]
    logits[ties] = 0.0
    logits[ties[0]] = -0.0
    logits = logits.to(dev)
    key = sampling.prng_key(5, dev)
    table = torch.full((1 << 23,), zero, device=dev)
    got = K.gumbel_argmax(key, logits, k, table)
    assert torch.equal(got, torch.full((k,), ties[0], device=dev))
    assert torch.equal(got, threefry.categorical(key, logits, k, table=table))
    logits[[7000, 12000]] = float("nan")
    got = K.gumbel_argmax(key, logits, k, threefry._gumbel_table(dev))
    assert torch.equal(got, torch.full((k,), 7000, device=dev))
    assert torch.equal(got, threefry.categorical(key, logits, k))


@pytest.mark.cuda
def test_vertex_grad_on_the_card_equals_plain_versions(cuda_scene):
    """vertex_grad at 64x64 on the 20k proxy (silhouette and shadow edge
    draws): the gradient path launches banded, never tile-MT, and the
    Gumbel-max kernel once a draw, and under deterministic algorithms
    equals the same call with the plain versions in the kernels' place,
    bit for bit."""
    from mobileraytracer_tpu_torch.diff import geom
    scene = cuda_scene[0]
    _, cam, _ = bench_scenes.conference_proxy(target_prims=20000)
    cfg = RenderConfig(width=64, height=64, shader=C.SHADER_WHITTED,
                       accelerator=C.ACC_BVH, nee_share=128)
    kw = dict(edge_keep=geom.edge_topology(scene.triangles), edge_budget=256,
              shadow_edges=True, shadow_budget=64)
    key = sampling.prng_key(0, "cuda")
    torch.use_deterministic_algorithms(True)
    try:
        K.reset_launches()
        loss, g = geom.vertex_grad(scene, cam, cfg, key, **kw)
        launches = dict(K.LAUNCHES)
        restore = _plain_kernels()
        try:
            loss_p, g_p = geom.vertex_grad(scene, cam, cfg, key, **kw)
        finally:
            restore()
    finally:
        torch.use_deterministic_algorithms(False)
    assert launches["banded"] > 0 and launches["tilemt"] == 0, launches
    assert launches["window"] == launches["banded"], launches
    assert launches["gumbel"] == 2, launches
    assert torch.equal(loss, loss_p)
    for k in g:
        assert torch.isfinite(g[k]).all()
        assert torch.equal(g[k], g_p[k]), k
    assert float(g["va"].abs().max()) > 0


@pytest.mark.cuda
def test_train_step_on_the_card_equals_plain_versions(cuda_scene):
    """One material training step at 64x64: the loss and every material
    gradient equal the plain-version step's under deterministic
    algorithms, and only banded launches."""
    from mobileraytracer_tpu_torch.parallel import mesh as pmesh
    scene = cuda_scene[0]
    _, cam, _ = bench_scenes.conference_proxy(target_prims=20000)
    cfg = RenderConfig(width=64, height=64, shader=C.SHADER_WHITTED,
                       accelerator=C.ACC_BVH, nee_share=128)
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (64, 64, 3)).astype(np.float32))
    key = sampling.prng_key(1, "cuda")
    torch.use_deterministic_algorithms(True)
    try:
        K.reset_launches()
        loss, g = pmesh.train_step_sharded(scene, cam, cfg, key, target)
        launches = dict(K.LAUNCHES)
        restore = _plain_kernels()
        try:
            loss_p, g_p = pmesh.train_step_sharded(scene, cam, cfg, key,
                                                   target)
        finally:
            restore()
    finally:
        torch.use_deterministic_algorithms(False)
    assert launches["banded"] > 0 and launches["tilemt"] == 0, launches
    assert launches["window"] == launches["banded"], launches
    assert torch.equal(loss, loss_p)
    for k in g:
        assert torch.isfinite(g[k]).all()
        assert torch.equal(g[k], g_p[k]), k
    assert float(g["kd"].abs().max()) > 0


@pytest.mark.cuda
def test_pathtracer_recovery_step_on_the_card_equals_plain_versions(
        cuda_scene):
    """One PathTracer recovery step of kD and the lights' radiance at 64x64
    (the differentiable walk, its backward, Adam and the clamp): under
    deterministic algorithms the loss, both gradients and the parameters
    after it equal the same step's with the plain versions in the kernels'
    place, bit for bit; only banded launches."""
    from mobileraytracer_tpu_torch.parallel import recover
    scene = cuda_scene[0]
    _, cam, _ = bench_scenes.conference_proxy(target_prims=20000)
    cfg = RenderConfig(width=64, height=64, spp=2,
                       shader=C.SHADER_PATHTRACER, accelerator=C.ACC_BVH,
                       nee_share=128, nee_reverse=True,
                       nee_share_secondary=True)
    target = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (64, 64, 3)).astype(np.float32))
    key = sampling.prng_key(2, "cuda")
    start = {"kd": torch.full_like(scene.materials.kd, 0.5),
             "radiance": scene.lights.radiance * 0.5}

    def step():
        step_fn, _ = recover.make_recovery_step(
            scene, cam, cfg, params_subset=("kd", "radiance"))
        state, loss = step_fn(recover.make_state(start, 0.05), key, target)
        return loss, {k: (p.grad, p.detach()) for k, p in state[0].items()}
    torch.use_deterministic_algorithms(True)
    try:
        K.reset_launches()
        loss, got = step()
        launches = dict(K.LAUNCHES)
        restore = _plain_kernels()
        try:
            loss_p, got_p = step()
        finally:
            restore()
    finally:
        torch.use_deterministic_algorithms(False)
    assert launches["banded"] > 0 and launches["tilemt"] == 0, launches
    assert launches["window"] == launches["banded"], launches
    assert torch.equal(loss, loss_p)
    for k in got:
        for a, b in zip(got[k], got_p[k]):
            assert torch.isfinite(a).all()
            assert torch.equal(a, b), k
    assert float(got["radiance"][0].abs().max()) > 0
    assert float(got["radiance"][1].min()) >= 0.0


@pytest.mark.cuda
def test_two_rank_gloo_frame_on_the_card(tmp_path):
    """The cornell2 32x32 block-BVH frame of tests/torch_mesh_worker.py
    sharded over 2 gloo ranks that share the card: both ranks launch the
    banded kernel (a shard of 512 lanes takes full-batch steps, so no
    tile-MT primary pass) and return the one-device frame bit for bit."""
    import torch_mesh_worker as W
    from mobileraytracer_tpu_torch.ops import _build
    dev = _need_cuda()
    _build.load()               # once, before the ranks look for it
    got = W.finish(W.start(2, tmp_path, "cuda", ["frame"]), tmp_path, 600)
    s, c = W.frame_scene(dev)
    one = renderer.render_frame(s, c, RenderConfig(**W.FRAME_KW),
                                sampling.prng_key(0, dev))
    for r in got:
        f = r["frame"]
        assert f["launches"][1] > 0, f["launches"]
        assert int(f["rays"]) == int(one["rays"])
        assert torch.equal(f["bitmap"], one["bitmap"].cpu())
        assert torch.equal(f["image"], one["image"].cpu())


@pytest.mark.cuda
def test_chunked_frame_on_the_card_equals_fused(cuda_scene):
    """render_frame_auto at 64x64 on the 20k proxy, Whitted with the main
    path's NEE sharing, cut into four 1,024-lane chunks by its budget: each
    chunk takes its own tile-MT primary pass, and the frame equals
    render_frame's bit for bit."""
    scene = cuda_scene[0]
    dev = scene.device
    cfg = RenderConfig(width=64, height=64, shader=C.SHADER_WHITTED,
                       accelerator=C.ACC_BVH, nee_share=128,
                       nee_share_secondary=True)
    budget = renderer._dispatch_cost(cfg) / 4
    assert renderer._chunk_geometry(cfg, budget) == (4, 1024)
    cam = bench_scenes.conference_proxy(target_prims=20000)[1].to(dev)
    key = sampling.prng_key(0, dev)
    one = renderer.render_frame(scene, cam, cfg, key)
    K.reset_launches()
    out = renderer.render_frame_auto(scene, cam, cfg, key, budget=budget)
    torch.cuda.synchronize()
    assert K.LAUNCHES["tilemt"] == 4 and K.LAUNCHES["banded"] >= 4, \
        K.LAUNCHES
    for k in ("bitmap", "image", "rays"):
        assert torch.equal(out[k], one[k]), k


# ---------------------------------------------------------------------------
# The window kernel (csrc/candidate_windows.cu) against
# block_traversal._candidates_plain on the card: all four outputs bit for
# bit (floats by their bits, so a zero's sign counts), and frames whose
# windows come from either.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def conference_full():
    """The 331,179-triangle conference proxy on the card (241 supers of 16
    blocks), its camera and its 512x512 primary rays."""
    dev = _need_cuda()
    scene, cam, _ = bench_scenes.conference_proxy()
    scene = bt.build(scene, device=dev)
    u, v, _, _ = renderer._pixel_order(RenderConfig(width=512, height=512),
                                       dev)
    zero = torch.zeros_like(u)
    o, d = cameras.generate_rays(cam.to(dev), u, v, zero, zero)
    return scene, cam.to(dev), o, d


WINDOW_CASES = ["st16", "st16-cap", "st128-48-64", "sel_st32", "sel_st64",
                "refill", "cap-floor", "small-scene", "all-inf", "zero-dirs",
                "on-face"]


def _on_face_rays(grid, n_bundles, rng):
    """Bundles of 16 rays that share an origin on a face of a random
    non-empty block (axis and face by bundle), the other two coordinates
    inside it; their directions point into the block on that axis, or
    (every fourth bundle) both ways, so the slab products meet exact zeros
    of both signs."""
    pk = grid.blocks_packed.cpu().numpy()
    bps = grid.bps
    lo = np.stack([pk[:, a * bps:(a + 1) * bps].reshape(-1)
                   for a in range(3)], 1)
    hi = np.stack([pk[:, (3 + a) * bps:(4 + a) * bps].reshape(-1)
                   for a in range(3)], 1)
    live = np.nonzero(pk[:, 7 * bps:8 * bps].reshape(-1) > 0)[0]
    blocks = rng.choice(live, n_bundles)
    o = rng.uniform(lo[blocks], hi[blocks]).astype(np.float32)
    d = rng.normal(size=(n_bundles, 16, 3)).astype(np.float32)
    for i, g in enumerate(blocks):
        a, on_hi = i % 3, (i // 3) % 2 == 0
        o[i, a] = hi[g, a] if on_hi else lo[g, a]
        if i % 4 != 3:
            d[i, :, a] = np.abs(d[i, :, a]) * (-1.0 if on_hi else 1.0)
    o = np.repeat(o, 16, 0)
    return o, d.reshape(-1, 3)


def _window_case(case, conference_full):
    """(grid, o, d, cap, floor, bundle width, knobs) of one window shape."""
    scene, _, o, d = conference_full
    grid, dev = scene.bvh, o.device
    rng = np.random.default_rng(WINDOW_CASES.index(case))
    ext = float((grid.super_hi.max(1).values
                 - grid.super_lo.min(1).values).norm())
    cap = floor = None
    st, top = K.ST, {}
    if case == "st128-48-64":
        st, top = K.TILE, dict(top_s=bt.TILE_TOP_S, top_m=bt.TILE_TOP_M)
    elif case in ("sel_st32", "sel_st64"):
        st = int(case[-2:])
    elif case == "refill":
        # The refill's call: 65,536 rays, each duplicated into a subtile.
        o, d = (x[:65536].repeat_interleave(K.ST, 0) for x in (o, d))
    elif case == "small-scene":
        ts, _ = scenes.load_builtin(C.SCENE_CORNELL, 1.0)
        grid = bt.build(ts, device=dev).bvh
        top = dict(top_s=bt.DEFAULT_TOP_S, top_m=bt.DEFAULT_TOP_M)
    if case in ("small-scene", "zero-dirs", "on-face"):
        lo = grid.super_lo.min(1).values.cpu().numpy()
        hi = grid.super_hi.max(1).values.cpu().numpy()
        if case == "on-face":
            o, d = _on_face_rays(grid, 4096, rng)
        else:
            o = rng.uniform(lo, hi, (65536, 3)).astype(np.float32)
            d = rng.normal(size=(65536, 3)).astype(np.float32)
            d[::3, 0] = 0.0
            d[1::4, 1] = -0.0
            d[2::5, 2] = 0.0
        o, d = (torch.from_numpy(x).to(dev) for x in (o, d))
    nt = o.shape[0] // st
    per = lambda lo_, hi_: torch.from_numpy(
        rng.uniform(lo_, hi_, nt).astype(np.float32)).to(dev)
    if case != "st16" and case != "small-scene":
        cap = per(0.05 * ext, ext)
    if case in ("refill", "cap-floor"):
        floor = per(0.0, 0.3 * ext)
    if case == "all-inf":
        cap = torch.full((nt,), -float("inf"), device=dev)
    return grid, o, d, cap, floor, st, top


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_kernel_equals_plain(conference_full, case):
    grid, o, d, cap, floor, st, top = _window_case(case, conference_full)
    before = K.LAUNCHES["window"]
    got = bt._candidates(grid, o, d, cap=cap, floor=floor, st=st, **top)
    assert K.LAUNCHES["window"] == before + 1
    want = bt._candidates_plain(grid, o, d, cap, floor, st, **top)
    for name, g, w in zip(("cand_gid", "cand_first", "cand_entry", "cut"),
                          got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bad = (_bits(g) != _bits(w)).nonzero()
        assert bad.shape[0] == 0, (name, bad[:4].tolist(),
                                   g[tuple(bad[0])].item(),
                                   w[tuple(bad[0])].item())
    ce = want[2]
    if case == "on-face":
        zeros = ce[ce == 0.0]
        assert zeros.numel() > 0 and torch.signbit(zeros).any()
    if case == "all-inf":
        assert (ce == C.RAY_LENGTH_MAX).all()
    else:
        assert (ce < C.RAY_LENGTH_MAX).any()


def _plain_windows_on_the_cpu(grid):
    """_candidates for `grid`'s queries through the plain version on the
    CPU, its outputs sent back to the card."""
    cpu_grid = grid.to("cpu")

    def windows(g, o, d, cap=None, floor=None, st=K.ST, top_s=None,
                top_m=None):
        assert g is grid
        c = lambda x: None if x is None else x.cpu()
        out = bt._candidates_plain(cpu_grid, o.cpu(), d.cpu(), c(cap),
                                   c(floor), st, top_s, top_m)
        return tuple(x.to(o.device) for x in out)
    return windows


@pytest.mark.cuda
@pytest.mark.parametrize("shader", ["whitted", "pathtracer"])
def test_frames_with_kernel_windows_equal_plain_windows(conference_full,
                                                        monkeypatch, shader):
    """The main path's 512x512 Whitted frame and a 256x256 PathTracer
    sample (its chunk steps as CUDA graphs) with the window kernel equal,
    bit for bit, the frames whose windows the plain version computes on
    the CPU (PathTracer steps then op by op); one window a traversal
    kernel launch."""
    from mobileraytracer_tpu_torch.shaders import engine
    scene, cam, o, _ = conference_full
    dev = o.device
    if shader == "whitted":
        cfg = RenderConfig(width=512, height=512, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                           nee_share=128, nee_share_secondary=True)
    else:
        cfg = RenderConfig(width=256, height=256, spp=1,
                           shader=C.SHADER_PATHTRACER,
                           accelerator=C.ACC_BVH, nee_share=128,
                           nee_reverse=True, nee_share_secondary=True)
    key = sampling.prng_key(7, dev)
    K.reset_launches()
    out = renderer.render_frame(scene, cam, cfg, key)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    walks = sum(launches[k] for k in ("banded", "tilemt", "tilebw",
                                      "resident"))
    assert launches["window"] == walks > 0, launches
    monkeypatch.setattr(bt, "_candidates",
                        _plain_windows_on_the_cpu(scene.bvh))
    monkeypatch.setattr(engine, "GRAPH_STEPS", False)
    K.reset_launches()
    ref = renderer.render_frame(scene, cam, cfg, key)
    assert K.LAUNCHES["window"] == 0
    engine.clear_graphs()
    assert int(out["rays"]) == int(ref["rays"]) > 0
    assert torch.equal(out["image"], ref["image"])
    assert torch.equal(out["bitmap"], ref["bitmap"])
