"""The premises the tilebw and resident kernels' designs rest on, held on
the plain versions: a block's valid lanes come first (so a scan may stop at
the last one), they carry distinct slots, and the tile round's three slot-
excluding passes equal one (t, slot)-sorted top-3 wherever its smallest
tracked t lies below 1e30.  Also the Baldwin-Weber blocks the CUDA tests
build by hand (`bw_blocks`, `bw_rows`).  Imports neither jax nor the JAX
package."""
import numpy as np
import pytest
import torch

from mobileraytracer_tpu_torch import bench_scenes, scenes
from mobileraytracer_tpu_torch.ops import block_traversal as tbt
from mobileraytracer_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

BIG = 1.0e30                         # RAY_LENGTH_MAX
BIG2 = np.float32(2.0e30)
TMG = 1e-4                           # a grid's t_margin


@pytest.mark.parametrize("scene", ["cornell", "proxy20k"])
def test_valid_lanes_come_first_with_distinct_slots(scene):
    if scene == "cornell":
        tris = scenes.load_builtin(0, 1.0)[0].triangles
    else:
        tris = bench_scenes.conference_proxy(target_prims=20000)[0].triangles
    _, grid = tbt.build_blocks(tris)
    k1 = grid.blocks_packed.shape[0]
    count = grid.blocks_packed.reshape(k1, 8, -1)[:, 7].reshape(-1).long()
    assert count.shape[0] == grid.tb.shape[0] and int(count.max()) > 0
    first = torch.arange(K.LANES)[None, :] < count[:, None]
    assert torch.equal(grid.tb[:, 9] > 0.5, first)
    assert torch.equal(grid.tw[:, 4, :K.LANES] > 0.5, first)
    for slots in (grid.tb[:, 10], grid.tw[:, 4, K.LANES:2 * K.LANES]):
        for b in range(slots.shape[0]):
            s = slots[b, :int(count[b])]
            assert s.unique().numel() == s.numel()


def bw_rows(pa, ab, ac):
    """Baldwin-Weber rows of triangles (n, 3) as block_traversal.build_blocks
    forms them in float64: the unit normal, the barycentric gradients and
    their offsets, and |ab x ac|.  Returns (n_hat, d_n, w_u, c_u, w_v, c_v,
    nlen), float64."""
    pa, ab, ac = (np.asarray(x, np.float64) for x in (pa, ab, ac))
    n = np.cross(ab, ac)
    nsq = np.einsum("ij,ij->i", n, n)
    n_hat = n / np.sqrt(nsq)[:, None]
    w_u = np.cross(ac, n) / nsq[:, None]
    w_v = np.cross(n, ab) / nsq[:, None]
    return (n_hat, -np.einsum("ij,ij->i", n_hat, pa), w_u,
            -np.einsum("ij,ij->i", w_u, pa), w_v,
            -np.einsum("ij,ij->i", w_v, pa), np.sqrt(nsq))


def bw_block(rows, slots, valid=None):
    """One (8, 3 * LANES) float32 block of tw: lanes [0, n) from `rows`
    (bw_rows' tuple, n triangles) with the given slots and valid flags
    (default all 1), the rest zero."""
    n_hat, d_n, w_u, c_u, w_v, c_v, nlen = rows
    n = n_hat.shape[0]
    w = np.zeros((8, 3 * K.LANES), np.float32)
    for g, (vec, off) in enumerate(((n_hat, d_n), (w_u, c_u), (w_v, c_v))):
        w[0:3, g * K.LANES:g * K.LANES + n] = vec.T
        w[3, g * K.LANES:g * K.LANES + n] = off
    w[4, :n] = 1.0 if valid is None else valid
    w[4, K.LANES:K.LANES + n] = slots
    w[4, 2 * K.LANES:2 * K.LANES + n] = nlen
    return w


def stacked_block(rng, n, ties=0, slot0=0, aside=0.2):
    """n triangles facing rays along +z from near the origin: planes at
    z in [1, 5] tilted a little, large enough that most rays cross most of
    them, nearest first, a share `aside` shifted aside so that u or v fails,
    some with |ab x ac| set to 1e-6 so that their det_s passes only the
    loose test, the last `ties` exact copies of the first (equal t, other
    slots).  Slots slot0, slot0 + 1, ... in a shuffled order."""
    z = np.sort(rng.uniform(1, 5, n))
    tilt = rng.uniform(-0.2, 0.2, (n, 2))
    pa = np.stack([np.full(n, -1.5), np.full(n, -1.5), z], 1)
    pa[:, :2] += np.where(rng.random((n, 1)) < aside, 1.8, 0.0)
    ab = np.stack([np.full(n, 4.0), np.zeros(n), 4.0 * tilt[:, 0]], 1)
    ac = np.stack([np.zeros(n), np.full(n, 4.0), 4.0 * tilt[:, 1]], 1)
    for x in (pa, ab, ac):
        x[n - ties:] = x[:ties]
    rows = bw_rows(pa, ab, ac)
    rows[6][rng.random(n) < 0.4] = 1e-6
    rows[6][n - ties:] = rows[6][:ties]
    return bw_block(rows, slot0 + rng.permutation(n))


def far_block(slots, offsets):
    """Lanes on planes z = -offset (an offset near -1e30 puts t near 1e30),
    facing +z, with u = (x + 1) / 3 and v = (y + 1) / 3 that do not change
    along +z: a ray along +z from |x|, |y| < 0.5 tracks each of them."""
    n = len(slots)
    rows = (np.tile([0.0, 0.0, 1.0], (n, 1)), np.asarray(offsets, np.float64),
            np.tile([1 / 3, 0.0, 0.0], (n, 1)), np.full(n, 1 / 3),
            np.tile([0.0, 1 / 3, 0.0], (n, 1)), np.full(n, 1 / 3),
            np.ones(n))
    return bw_block(rows, slots)


def bw_rays(rng, n, t_init):
    """(n, 8) float32 rays from near the origin along about +z."""
    o = rng.uniform(-0.4, 0.4, (n, 3)) * [1, 1, 0.1]
    d = np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)), np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), t_init), np.full((n, 1), -1)],
                          1).astype(np.float32)


def bw_blocks(seed=0):
    """Hand-made Baldwin-Weber blocks for the tile kernel: stacked lanes
    with exact ties at counts that are not multiples of 4 or 32, a full
    block, a block with no valid lane, lanes at t near 1e30 (the slot
    resets), and a block that repeats a slot among tracked lanes.  Returns
    (tw (NB, 8, 384) float32, index of the far block, index of the block
    with the repeated slot)."""
    rng = np.random.default_rng(seed)
    blocks = [stacked_block(rng, 37, ties=6), stacked_block(rng, 5, ties=2),
              stacked_block(rng, 128, ties=20, slot0=1000),
              stacked_block(rng, 70, ties=9, slot0=3000),
              np.zeros((8, 3 * K.LANES), np.float32)]
    far = len(blocks)
    blocks.append(far_block([7, 3, 5], [-1e30, -1e30, -1.0001e30]))
    # The two nearest lanes share a slot; the three nearest pass only the
    # loose test, so every ray tracks them in both modes.
    dup = stacked_block(rng, 33, slot0=5000, aside=0.0)
    dup[4, K.LANES + 1] = dup[4, K.LANES]
    dup[4, 2 * K.LANES:2 * K.LANES + 3] = 1e-6
    blocks.append(dup)
    return np.stack(blocks), far, len(blocks) - 1


def _round(w, rays, any_hit):
    """kernels._bw_round on blocks w (n, 8, 384) for rays (R, 8), every
    block against every ray; its outputs (n, R)."""
    w = torch.from_numpy(w)
    r = torch.from_numpy(rays)[None, :, :, None].expand(w.shape[0], -1, -1, 1)
    k = K.bw_consts(TMG)
    parts = [r[:, :, c] for c in range(8)]
    cap = parts[6]
    hi = (cap * k[8] + k[10], cap * k[9] - k[10])
    out = K._bw_round(w, *parts[:6], parts[7], hi, any_hit, k)
    return [x[..., 0].numpy() for x in out]


def _tracked(w, rays, any_hit):
    """Each lane's tracked t ((R, LANES), 2e30 where not tracked): the
    round's m1 with that lane alone valid."""
    probes = np.repeat(w[None], K.LANES, 0)
    valid = probes[:, 4, :K.LANES].copy()
    probes[:, 4, :K.LANES] = 0.0
    probes[np.arange(K.LANES), 4, np.arange(K.LANES)] = valid[0]
    return _round(probes, rays, any_hit)[0].T


def _sorted_top3(w, tl):
    """Per ray, the (t, slot)-sorted top-3 of the tracked lanes as the
    round reports it: (m1, sl1, m2, sl2, m3) with a slot -1 where its t is
    not below 1e30, and 2e30 past the tracked lanes."""
    slots = w[4, K.LANES:2 * K.LANES]
    out = []
    for row in tl:
        lanes = sorted((t, s) for t, s in zip(row, slots) if t < BIG2)
        lanes += [(BIG2, -1.0)] * 3
        (t1, s1), (t2, s2), (t3, _) = lanes[:3]
        out.append((t1, s1 if t1 < np.float32(BIG) else -1.0, t2,
                    s2 if t2 < np.float32(BIG) else -1.0, t3))
    return np.array(out, np.float32).T


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_bw_round_is_a_sorted_top3_below_1e30(seed, any_hit):
    rng = np.random.default_rng(seed)
    rays = bw_rays(rng, 24, BIG if seed == 0 else 4.0)
    tw, far, dup = bw_blocks(seed)
    got_all = _round(tw, rays, any_hit)
    checked = ties = 0
    for b in range(tw.shape[0]):
        if b == far:                    # the reset case, below
            continue
        want = _sorted_top3(tw[b], _tracked(tw[b], rays, any_hit))
        got = np.stack([x[b] for x in got_all[:5]])
        below = got[0] < np.float32(BIG)
        if b == dup:
            # A slot repeated among the tracked lanes: the exclusion drops
            # both of its lanes, so the kernel reruns such a round in full.
            assert (got[:, below] != want[:, below]).any()
            continue
        np.testing.assert_array_equal(got[:, below], want[:, below])
        checked += int(below.sum())
        ties += int((((got[0] == got[2]) | (got[2] == got[4])) & below).sum())
    assert checked > 20 and ties > 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_bw_round_resets_slots_at_1e30(any_hit):
    """Lanes at t = 1e30 and just above it, with t_init = 1e30: m1 is not
    below 1e30, so sl1 resets to -1, the second pass excludes nothing and
    m2 == m1, and m3 is the second lane at m1, not the sorted third t."""
    rng = np.random.default_rng(2)
    rays = bw_rays(rng, 8, BIG)
    rays[:, 3:6] = [0.0, 0.0, 1.0]
    tw, far, _ = bw_blocks()
    w = tw[far]
    tl = _tracked(w, rays, any_hit)
    big = np.float32(BIG)
    assert (tl[:, 0] == big).all() and (tl[:, 1] == big).all()
    assert (tl[:, 2] > big).all() and (tl[:, 2] < BIG2).all()
    m1, sl1, m2, sl2, m3 = (x[0] for x in _round(w[None], rays, any_hit)[:5])
    np.testing.assert_array_equal(m1, big)
    np.testing.assert_array_equal(sl1, -1.0)
    np.testing.assert_array_equal(m2, m1)
    np.testing.assert_array_equal(sl2, -1.0)
    np.testing.assert_array_equal(m3, big)
    # The sorted reading would give the third lane's t: the kernel must
    # rerun such a round in the plain version's three passes.
    assert (_sorted_top3(w, tl)[4] > big).all()
