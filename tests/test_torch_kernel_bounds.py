"""The kernels' bound (ops/kernels.traversal_bound and its counts), the
resident walk's statistics, and the device the entry points pick."""
import pathlib
import re

import numpy as np
import pytest
import torch

from mobileraytracer_tpu_torch import Renderer, sampling
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch import scenes as tscenes
from mobileraytracer_tpu_torch import types
from mobileraytracer_tpu_torch.ops import block_traversal as tbt
from mobileraytracer_tpu_torch.ops import kernels as K
from mobileraytracer_tpu_torch.types import RenderConfig

torch.set_num_threads(2)

CSRC = pathlib.Path(K.__file__).resolve().parent.parent / "csrc"


def _ops_between(path, first, last, after="", skip=("const int",)):
    """f32 operators (' * ', ' + ', ' - ', ' / ') on the source lines from
    the one that starts with `first` (the first such after a line holding
    `after`) to the one that starts with `last`."""
    lines = [ln.strip() for ln in path.read_text().splitlines()]
    h = next(k for k, ln in enumerate(lines) if after in ln)
    i = next(k for k, ln in enumerate(lines) if k >= h
             and ln.startswith(first))
    j = next(k for k, ln in enumerate(lines) if k > i and ln.startswith(last))
    body = " ".join(ln for ln in lines[i:j + 1] if not ln.startswith(skip))
    return len(re.findall(r" [*+/-] ", body))


def _stmt_ops(path, *names):
    """f32 operators in the statements `const float <name> = ...;` (one
    line or several) of the source, summed."""
    text = path.read_text()
    n = 0
    for name in names:
        stmt = re.search(rf"const float {name} =(.*?);", text, re.S).group(1)
        n += len(re.findall(r" [*+/-] ", " ".join(stmt.split())))
    return n


def test_op_counts_are_the_sources():
    mt = CSRC / "mt.cuh"
    # mt_round, from p to the acceptance (where u + v is formed).
    assert _ops_between(mt, "const float px",
                        "(v >= 0.0f) && (u + v <= 1.0f)",
                        after="void mt_round(") == K.MT_OPS == 46
    # mt_test: the operations done before each of its returns.
    exits = ("if (!(fabsf(det) >= kEps)) return;",
             "if (!(u >= 0.0f && u <= 1.0f)) return;",
             "const float v =",
             "if (!(v >= 0.0f && u + v <= 1.0f)) return;",
             "if (t >= kEps && t < t_best)")
    assert [0] + [_ops_between(mt, "const float px", e, after="void mt_test(")
                  for e in exits] == list(K.MT_STAGE_OPS)
    assert K.MT_STAGE_OPS == (0, 14, 24, 39, 40, 46)
    # The Baldwin-Weber pair: the forms each exit of tile_plain's needs.
    bw = CSRC / "traverse_tilebw.cu"
    stages = [("nd", "det_s"), ("no", "inv_nd", "t"), ("uo", "ud", "u"),
              ("vo", "vd", "v"), ("uv",)]
    ops = np.cumsum([0] + [_stmt_ops(bw, *names) for names in stages])
    assert tuple(ops.tolist()) == K.BW_STAGE_OPS == (0, 6, 14, 27, 40, 41)
    assert K.BW_OPS == 41
    assert K.MT_BLOCK_BYTES == 5632 and K.BW_BLOCK_BYTES == 7680


def test_traversal_bound_against_hand_counts():
    # Tile-MT: 2,048 tiles at 5.5 rounds, split over the exits; 20 MB of
    # rays, outputs and lists and 3,000 distinct blocks: compute-bound.
    tests = 2048 * 11 // 2 * 128 * 128
    exits = [tests // 4, tests // 2, tests // 8, tests // 16, tests // 32,
             tests // 32]
    b = K.traversal_bound(exits, K.MT_STAGE_OPS, 20_000_000, 3000,
                          K.MT_BLOCK_BYTES)
    ops = (tests // 2 * 14 + tests // 8 * 24 + tests // 16 * 39
           + tests // 32 * (40 + 46))
    assert b["tests"] == tests and b["ops"] == ops
    assert b["bytes"] == 20_000_000 + 3000 * 5632
    assert b["by"] == "compute"
    assert b["ms"] == pytest.approx(ops / 67e12 * 1e3, rel=1e-12)
    assert b["unfused_ms"] == pytest.approx(2 * b["ms"], rel=1e-12)
    # Every pair forming t: the whole test, 46 operations each.
    b = K.traversal_bound([0, 0, 0, 0, 0, 8 * 16384], K.MT_STAGE_OPS, 1000,
                          2, K.MT_BLOCK_BYTES)
    assert b["tests"] == 8 * 128 * 128
    assert b["ms"] == pytest.approx(8 * 16384 * 46 / 67e12 * 1e3)
    # No pair past the lane check: only the bytes remain.
    b = K.traversal_bound([5, 0, 0, 0, 0, 0], K.BW_STAGE_OPS, 3_350_000, 0,
                          K.BW_BLOCK_BYTES)
    assert b["by"] == "bytes" and b["ms"] == pytest.approx(1e-3)
    assert b["ops"] == 0 and b["tests"] == 5
    with pytest.raises(ValueError):
        K.traversal_bound([1, 2], K.MT_STAGE_OPS, 0, 0, K.MT_BLOCK_BYTES)


C_BIG = 1.0e30                              # RAY_LENGTH_MAX


def _random_walk_inputs(rng, n_blocks, bp, rows, m):
    """A block table of random triangles with invalid lanes and degenerate
    (zero-area) ones, rays from near the origin with some previous slots
    set to lanes they face, and random candidate lists."""
    f32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
    tb = np.zeros((n_blocks, 16, K.LANES), np.float32)
    tb[:, 0:3] = rng.uniform(-1, 1, (n_blocks, 3, K.LANES))
    tb[:, 3:9] = rng.uniform(-0.8, 0.8, (n_blocks, 6, K.LANES))
    flat = tb[:, 6:9].reshape(n_blocks, 3, K.LANES)
    degenerate = rng.random((n_blocks, K.LANES)) < 0.1
    flat[:] = np.where(degenerate[:, None], 2 * tb[:, 3:6], flat)
    tb[:, 9] = rng.random((n_blocks, K.LANES)) > 0.1
    tb[:, 10] = np.arange(n_blocks * K.LANES).reshape(n_blocks, K.LANES)
    o = rng.uniform(-0.2, 0.2, (bp, 3))
    d = rng.normal(size=(bp, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    prev = np.where(rng.random(bp) < 0.3,
                    rng.integers(0, n_blocks * K.LANES, bp), -1)
    rays = np.concatenate([o, d, np.full((bp, 1), C_BIG), prev[:, None]], 1)
    cg = rng.integers(0, n_blocks, (rows, m)).astype(np.int32)
    ce = np.sort(rng.uniform(0, 1, (rows, m)), 1)
    return (f32(tb), torch.from_numpy(cg), f32(ce), f32(rays))


def _mt_test_exits(blk, ray):
    """mt_test (csrc/mt.cuh) followed return by return in numpy float32:
    one ray (8,) against one block (16, LANES); pair counts per exit."""
    one = np.float32(1.0)
    ox, oy, oz, dx, dy, dz, _, prev = ray
    pax, pay, paz, abx, aby, abz, acx, acy, acz, valid, slot = blk[:11]
    counts = [0] * 6
    left = np.ones(K.LANES, bool)

    def leave(reject, stage):
        counts[stage] += int((left & reject).sum())
        left[reject] = False

    leave(~(valid > 0.5) | (slot == prev), 0)
    px = dy * acz - dz * acy
    py = dz * acx - dx * acz
    pz = dx * acy - dy * acx
    det = abx * px + aby * py + abz * pz
    leave(~(np.abs(det) >= np.float32(1e-6)), 1)
    with np.errstate(all="ignore"):
        inv = one / det
        tvx, tvy, tvz = ox - pax, oy - pay, oz - paz
        u = inv * (tvx * px + tvy * py + tvz * pz)
        leave(~((u >= 0) & (u <= 1)), 2)
        qx = tvy * abz - tvz * aby
        qy = tvz * abx - tvx * abz
        qz = tvx * aby - tvy * abx
        v = inv * (dx * qx + dy * qy + dz * qz)
        leave(~(v >= 0), 3)
        leave(~(u + v <= 1), 4)
    counts[5] = int(left.sum())
    return np.array(counts)


@pytest.mark.parametrize("kind", ["tilemt", "banded"])
def test_plain_walk_exit_counts_follow_mt_test(kind):
    """The plain versions' pair counts per exit equal mt_test's returns,
    taken pair by pair in numpy over the blocks each list walked."""
    rng = np.random.default_rng(11)
    bp, m = 2 * K.TILE, 3
    per = K.TILE if kind == "tilemt" else K.ST
    tb, cg, ce, rays = _random_walk_inputs(rng, 6, bp, bp // per, m)
    if kind == "tilemt":
        out, exits = K.tilemt_plain(tb, cg, ce, rays, m, False, stats=True)
        assert torch.equal(out, K.tilemt_plain(tb, cg, ce, rays, m, False))
        rounds = out[:, 2]
    else:
        *out, exits = K.banded_plain(tb, cg, ce, rays, m, False, stats=True)
        for a, b in zip(out, K.banded_plain(tb, cg, ce, rays, m, False)):
            assert torch.equal(a, b)
        rounds = out[2]
    want = np.zeros(6, np.int64)
    tbn, raysn = tb.numpy(), rays.numpy()
    for i in range(bp):
        lst = i // per
        for r in range(int(rounds[i])):
            want += _mt_test_exits(tbn[int(cg[lst, r])], raysn[i])
    assert exits.tolist() == want.tolist()
    assert sum(want) == int(rounds.sum()) * K.LANES
    assert all(n > 0 for n in want), want    # every exit is reached


def test_tile_and_resident_exit_counts_cover_their_walks():
    rng = np.random.default_rng(12)
    bp, m = K.TILE, 3
    tb, cg, ce, rays = _random_walk_inputs(rng, 6, bp, 1, m)
    tw = torch.from_numpy(rng.uniform(-1, 1, (6, 8, 3 * K.LANES))
                          .astype(np.float32))
    tw[:, 4, :K.LANES] = 1.0                        # valid lanes
    out, exits = K.tile_plain(tw, cg, ce, rays, m, False, 1e-4, stats=True)
    assert torch.equal(out, K.tile_plain(tw, cg, ce, rays, m, False, 1e-4))
    assert len(exits) == len(K.BW_STAGE_OPS)
    assert int(exits.sum()) == int(out[:, 7].sum()) * K.LANES
    assert int(exits[1:].sum()) > 0

def test_visited_blocks_counts_distinct_walked_ids():
    gid = torch.tensor([[4, 7, 9], [7, 2, 2], [5, 5, 1]], dtype=torch.int32)
    assert K.visited_blocks(gid, [2, 3, 0]) == 3          # 4, 7, 2
    assert K.visited_blocks(gid, [5, 1, 1]) == 4          # 4, 7, 9, 5
    assert K.visited_blocks(gid, torch.zeros(3)) == 0


def test_resident_plain_stats_count_rounds_and_blocks():
    """Two programs of one partition: the program's rounds are the longest
    run among its bands while a ray is unoccluded, and the blocks are the
    distinct table rows read, dead bands' clamped reads included."""
    rng = np.random.default_rng(0)
    tb = torch.zeros((K.NBP, 16, K.LANES))
    rays = torch.zeros((2 * K.TILE, 8))
    rays[:, 3] = 1.0
    rays[:, 6] = torch.from_numpy(rng.uniform(1, 2, 2 * K.TILE)
                                  .astype(np.float32))
    rays[:, 7] = -1.0
    m = 4
    glist = torch.tensor([[3, 5, 8, 9]] * 16, dtype=torch.int32)
    starts = torch.zeros((16, 2), dtype=torch.int32)
    starts[:, 1] = torch.tensor([4, 2] + [1] * 14)
    starts[8:, 1] = 0                       # the second program lists none
    t, slot, rounds, blocks, exits = K.resident_plain(tb, starts, glist,
                                                      rays, m, 1, stats=True)
    t0, slot0 = K.resident_plain(tb, starts, glist, rays, m, 1)
    assert torch.equal(t, t0) and torch.equal(slot, slot0)
    assert rounds.tolist() == [[4, 0]]
    assert blocks == 4                      # rows 3, 5, 8 and 9
    # 4 rounds x 128 rays x 128 lanes, every lane of the zero table invalid.
    assert exits.tolist() == [4 * K.TILE * K.LANES, 0, 0, 0, 0, 0]


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    scene, cam = tscenes.load_builtin(0, 1.0)
    cfg = RenderConfig(width=16, height=16, spp=1, shader=1, accelerator=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(scene, cam, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbt.build(scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        types.entry_device("cuda:0")
    assert types.entry_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert types.entry_device() == torch.device("cuda")

    # On the CPU when asked: the frame render_frame gives on the same scene.
    r = Renderer(scene, cam, cfg, device="cpu")
    img = r.render()
    out = trend.render_frame(tbt.build(scene, device="cpu"), cam, cfg,
                             sampling.prng_key(cfg.seed))
    np.testing.assert_array_equal(img, out["image"].numpy())
    assert r.total_rays == int(out["rays"])
