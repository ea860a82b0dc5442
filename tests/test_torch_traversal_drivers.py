"""The traversal drivers of the PyTorch port (candidate windows, kernel,
exact refill, scene queries) and its naive oracle, held against the JAX
package and against the port's own oracle.  The "tilebw" and "resident"
modes are held in test_torch_traversal_modes.py with the helpers here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import constants as JC
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.ops import intersect as jnv
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import scenes as tscenes
from mobileraytracer_tpu_torch.ops import block_traversal as tbt
from mobileraytracer_tpu_torch.ops import intersect as tnv
from mobileraytracer_tpu_torch.types import Triangles
from test_torch_traversal import BIG, T_RTOL, _t, conference20k

torch.set_num_threads(2)

_SOUP = {}


def _assert_ids(ids, ref_ids, t, ref_t, tris, o, d):
    """Hit ids equal, except on coincident triangles (PARITY.md section 7):
    a differing id is accepted only where both triangles are hit at the
    bit-identical t."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    diff = np.nonzero(ids != ref_ids)[0]
    for i in diff:
        assert ids[i] >= 0 and ref_ids[i] >= 0, i
        pair = torch.tensor([ids[i], ref_ids[i]], dtype=torch.int32)
        tt = tnv.recompute_tri_t(tris, _t(o[[i, i]]), _t(d[[i, i]]), pair)
        assert tt[0] == tt[1], f"ray {i}: not a coincident-triangle tie"
    assert len(diff) <= 2
    hit = ref_ids >= 0
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(ref_t)[hit],
                               rtol=T_RTOL)


@pytest.mark.parametrize("mode", ["banded", "tilemt"])
def test_traversal_matches_jax_and_naive(mode):
    check_traversal(mode)


def check_traversal(mode):
    """Closest hit (any_hit=False: "resident" hands it to the banded
    driver), then any-hit, which runs each mode's own kernel."""
    jt2, jg, tt2, tg, o, d = conference20k()
    b = 256
    o, d = o[:b], d[:b]
    pk = np.zeros(b, np.int32)
    pi = np.full(b, -1, np.int32)
    t_p, id_p = tbt._TRAVERSALS[mode](tg, tt2, _t(o), _t(d), BIG, _t(pk),
                                      _t(pi), any_hit=False)
    t_n, id_n = tnv.closest_triangles(tt2, _t(o), _t(d),
                                      torch.full((b,), BIG), _t(pk), _t(pi))
    _assert_ids(id_p, id_n, t_p, t_n, tt2, o, d)
    t_j, id_j = jpb._TRAVERSALS[mode](jg, jt2, jnp.asarray(o), jnp.asarray(d),
                                      JC.RAY_LENGTH_MAX, jnp.asarray(pk),
                                      jnp.asarray(pi), any_hit=False)
    _assert_ids(id_p, id_j, t_p, t_j, tt2, o, d)
    assert (id_p.numpy() >= 0).sum() > b // 2

    # Any-hit with a self-hit guard on each ray's closest triangle.
    md = torch.full((b,), 600.0)
    pk2 = torch.full((b,), C.PRIM_TRIANGLE, dtype=torch.int32)
    _, id_a = tbt._TRAVERSALS[mode](tg, tt2, _t(o), _t(d), md, pk2, id_p,
                                    any_hit=True)
    _, id_an = tnv.closest_triangles(tt2, _t(o), _t(d), md, pk2, id_p)
    np.testing.assert_array_equal(id_a.numpy() >= 0, id_an.numpy() >= 0)
    _, id_aj = jpb._TRAVERSALS[mode](jg, jt2, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(md.numpy()),
                                     jnp.asarray(pk2.numpy()),
                                     jnp.asarray(id_p.numpy()), any_hit=True)
    np.testing.assert_array_equal(id_a.numpy() >= 0, np.asarray(id_aj) >= 0)


def test_scene_queries_match_jax_cornell2():
    """Whole-scene closest hit and occlusion (planes, spheres, area lights,
    triangles through the block traversal) on scene 2."""
    check_scene_queries("banded")


def check_scene_queries(mode):
    """A closest-hit query in mode "resident" gets any-hit answers in both
    packages (its default any_hit=True), so its hits are held against JAX
    only; occlusion in every mode against JAX and the oracle."""
    js, _ = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    ts, _ = tscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    jsp = jpb.build(js)
    tsp = tbt.build(ts, device="cpu")
    rng = np.random.default_rng(5)
    b = 256
    o = rng.uniform(-0.3, 0.3, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pk = np.zeros(b, np.int32)
    pi = np.full(b, -1, np.int32)
    jh = jpb.intersect_scene_pallas(jsp, *map(jnp.asarray, (o, d, pk, pi)),
                                    mode=mode)
    th = tbt.intersect_scene_blocks(tsp, *map(_t, (o, d, pk, pi)),
                                    mode=mode)
    np.testing.assert_array_equal(th.prim_kind.numpy(),
                                  np.asarray(jh.prim_kind))
    np.testing.assert_array_equal(th.prim_id.numpy(), np.asarray(jh.prim_id))
    np.testing.assert_array_equal(th.mat_id.numpy(), np.asarray(jh.mat_id))
    for f in ("t", "point", "normal", "uv", "light_le"):
        np.testing.assert_allclose(getattr(th, f).numpy(),
                                   np.asarray(getattr(jh, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    # The port's own naive oracle agrees with the traversal.
    if mode != "resident":
        tn = tnv.intersect_scene_naive(tsp, *map(_t, (o, d, pk, pi)))
        np.testing.assert_array_equal(th.prim_id.numpy(), tn.prim_id.numpy())
    jo = jpb.occluded_pallas(jsp, *map(jnp.asarray, (o, d)), 1.5,
                             jnp.asarray(pk), jnp.asarray(pi), mode=mode)
    to = tbt.occluded_blocks(tsp, _t(o), _t(d), 1.5, _t(pk), _t(pi),
                             mode=mode)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    on = tnv.occluded_naive(tsp, _t(o), _t(d), 1.5, _t(pk), _t(pi))
    np.testing.assert_array_equal(to.numpy(), on.numpy())


@pytest.mark.parametrize("scene_id", [0, 1, 2, 3])
def test_naive_oracle_matches_jax(scene_id):
    js, _ = jscenes.load_builtin(scene_id, 1.0)
    ts, _ = tscenes.load_builtin(scene_id, 1.0)
    rng = np.random.default_rng(scene_id)
    b = 300
    o = rng.uniform(-0.8, 0.8, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pk = np.where(np.arange(b) % 5 == 0, C.PRIM_SPHERE, 0).astype(np.int32)
    pi = np.where(pk > 0, 0, -1).astype(np.int32)
    jh = jnv.intersect_scene_naive(js, *map(jnp.asarray, (o, d, pk, pi)))
    th = tnv.intersect_scene_naive(ts, *map(_t, (o, d, pk, pi)))
    for f in ("prim_kind", "prim_id", "mat_id"):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)), err_msg=f)
    for f in ("t", "point", "normal", "uv", "light_le"):
        np.testing.assert_allclose(getattr(th, f).numpy(),
                                   np.asarray(getattr(jh, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    jo = jnv.occluded_naive(js, *map(jnp.asarray, (o, d)), 2.0,
                            jnp.asarray(pk), jnp.asarray(pi))
    to = tnv.occluded_naive(ts, _t(o), _t(d), 2.0, _t(pk), _t(pi))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _random_tris(n, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    return Triangles(
        point_a=f(rng.uniform(-1, 1, (n, 3))),
        ab=f(rng.uniform(-0.3, 0.3, (n, 3))),
        ac=f(rng.uniform(-0.3, 0.3, (n, 3))),
        normal_a=torch.zeros(n, 3), normal_b=torch.zeros(n, 3),
        normal_c=torch.zeros(n, 3), uv_a=torch.full((n, 2), -1.0),
        uv_b=torch.full((n, 2), -1.0), uv_c=torch.full((n, 2), -1.0),
        mat_id=torch.zeros(n, dtype=torch.int32),
        valid=torch.ones(n, dtype=torch.bool))


def soup():
    """(tris, grid, o, d, naive t, naive id, naive occluder id) of 120k
    random triangles (1,408 blocks, three resident partitions) and 256
    rays; any-hit queries use max distance 1.0."""
    b = 256
    pk = torch.zeros(b, dtype=torch.int32)
    pi = torch.full((b,), -1, dtype=torch.int32)
    md = torch.full((b,), 1.0)
    if "soup" not in _SOUP:
        # 60k triangles still resolve in the windowed refill; 120k stall.
        tris, grid = tbt.build_blocks(_random_tris(120000, seed=3))
        rng = np.random.default_rng(5)
        o = _t(rng.uniform(-2, 2, (b, 3)).astype(np.float32))
        d = rng.normal(size=(b, 3)).astype(np.float32)
        d = _t(d / np.linalg.norm(d, axis=1, keepdims=True))
        # The naive oracle's answers, shared by both modes.
        tn, idn = tnv.closest_triangles(tris, o, d, torch.full((b,), BIG),
                                        pk, pi)
        _, occ_n = tnv.closest_triangles(tris, o, d, md, pk, pi)
        _SOUP["soup"] = (tris, grid, o, d, tn, idn, occ_n)
    return _SOUP["soup"]


@pytest.mark.parametrize("mode", ["banded", "tilemt"])
def test_soup_reaches_dense_backstop_and_stays_exact(mode):
    check_soup(mode)


def check_soup(mode):
    """120k uniformly random overlapping triangles defeat the SAH windows:
    the windowed refill stalls and the dense naive backstop
    (pallas_bvh.py:703-727) must finish the walk exactly (closest hit
    with any_hit=False; "resident" hands it to the banded driver)."""
    b = 256
    md = torch.full((b,), 1.0)
    pk = torch.zeros(b, dtype=torch.int32)
    pi = torch.full((b,), -1, dtype=torch.int32)
    tris, grid, o, d, tn, idn, occ_n = soup()
    tbt.LOOPS.update(refill=0, dense=0)
    t, ids = tbt._TRAVERSALS[mode](grid, tris, o, d, BIG, pk, pi,
                                   any_hit=False)
    assert tbt.LOOPS["dense"] > 0
    np.testing.assert_array_equal(ids.numpy(), idn.numpy())
    np.testing.assert_array_equal(t.numpy(), torch.where(idn >= 0, tn,
                                                         BIG).numpy())
    _, ids2 = tbt._TRAVERSALS[mode](grid, tris, o, d, md, pk, pi,
                                    any_hit=True)
    np.testing.assert_array_equal(ids2.numpy() >= 0, occ_n.numpy() >= 0)



def _refill_rays(kind):
    """(tris, grid, o, d, t_max, prev_kind, prev_id) of one refill case:
    the 32x32 camera rays of the 20k-triangle conference proxy, 4,096
    cosine-weighted bounces off their hit points, or the random soup's
    rays, which reach the dense backstop."""
    if kind == "soup":
        tris, grid, o, d = soup()[:4]
        b = o.shape[0]
        return (tris, grid, o, d, BIG, torch.zeros(b, dtype=torch.int32),
                torch.full((b,), -1, dtype=torch.int32))
    _, _, tt2, tg, o, d = conference20k()
    o, d = _t(o), _t(d)
    b = o.shape[0]
    pk = torch.zeros(b, dtype=torch.int32)
    pi = torch.full((b,), -1, dtype=torch.int32)
    if kind == "primary":
        return tt2, tg, o, d, BIG, pk, pi
    from mobileraytracer_tpu_torch import sampling
    t, ids = tbt.traverse(tg, tt2, o, d, BIG, pk, pi)
    hit = torch.nonzero(ids >= 0).squeeze(1)
    lane = hit.repeat(4)
    n = (tg.tri_attr[ids[lane].long(), 9:12])
    n = n / n.norm(dim=1, keepdim=True)
    p = o[lane] + d[lane] * t[lane, None]
    keys = sampling.fold_in(sampling.prng_key(5, torch.device("cpu")),
                            torch.arange(lane.shape[0]))
    db = sampling.cosine_sample_hemisphere(keys, n)
    nb = lane.shape[0]
    return (tt2, tg, p, db, BIG, torch.full((nb,), C.PRIM_TRIANGLE,
                                            dtype=torch.int32),
            ids[lane].to(torch.int32))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", ["primary", "bounce", "soup"])
def test_refill_batches_keep_every_hit(kind, any_hit, monkeypatch):
    """The refill gathers every unresolved ray a loop (up to REFILL_CAP):
    per ray the same t and id as with the batch held at the old size
    (max(GROUP, min(2048, bp // ST // 4)) rays, here 8 to 64), never more
    loops, and one device read a loop plus one a query."""
    from mobileraytracer_tpu_torch.utils import metrics
    tris, grid, o, d, tmax, pk, pi = _refill_rays(kind)
    if any_hit:
        tmax = torch.full((o.shape[0],), 1.0 if kind == "soup" else 300.0)

    def run(cap):
        monkeypatch.setattr(tbt, "REFILL_CAP", cap)
        loops, syncs = tbt.LOOPS["refill"], metrics.SYNCS["traversal"]
        dense = tbt.LOOPS["dense"]
        t, ids = tbt.traverse(grid, tris, o, d, tmax, pk, pi,
                              any_hit=any_hit)
        return (t, ids, tbt.LOOPS["refill"] - loops,
                metrics.SYNCS["traversal"] - syncs,
                tbt.LOOPS["dense"] - dense)

    cap = tbt.REFILL_CAP
    bp = -(-o.shape[0] // (tbt.GROUP * tbt.ST)) * tbt.GROUP * tbt.ST
    t_old, id_old, loops_old, _, _ = run(
        max(tbt.GROUP, min(2048, bp // tbt.ST // 4)))
    t_new, id_new, loops_new, syncs_new, dense_new = run(cap)
    assert loops_new <= loops_old
    if kind == "bounce":
        assert loops_new < loops_old
    assert syncs_new == loops_new + 1
    if kind == "soup" and not any_hit:
        assert dense_new > 0
    if any_hit:
        np.testing.assert_array_equal(id_new.numpy() >= 0,
                                      id_old.numpy() >= 0)
    else:
        np.testing.assert_array_equal(t_new.numpy(), t_old.numpy())
        _assert_ids(id_new, id_old, t_new, t_old, tris, o.numpy(),
                    d.numpy())


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", ["primary", "bounce", "soup"])
def test_speculative_refill_matches_or_flags(kind, any_hit):
    """Inside a `Speculation` (a walk step's CUDA graph) the refill reads
    nothing and runs the loops of SPECULATIVE_BATCHES: where it reports
    every ray resolved, each ray's t and id are the read-driven refill's
    bit for bit, and settling it adds exactly the read-driven refill's
    LOOPS and REFILL counts, but for the lanes, which are its fixed
    loops'; the soup's closest hits, which need the dense backstop, are
    reported unresolved, and settling them counts nothing."""
    from mobileraytracer_tpu_torch.utils import metrics
    tris, grid, o, d, tmax, pk, pi = _refill_rays(kind)
    if any_hit:
        tmax = torch.full((o.shape[0],), 1.0 if kind == "soup" else 300.0)
    counts = lambda: (dict(tbt.LOOPS), dict(tbt.REFILL))
    before = counts()
    t_ref, id_ref = tbt.traverse(grid, tris, o, d, tmax, pk, pi,
                                 any_hit=any_hit)
    after = counts()
    change = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
    dense = change[0]["dense"]
    spec = tbt.Speculation(o.device)
    syncs = metrics.SYNCS["traversal"]
    with spec:
        t, ids = tbt.traverse(grid, tris, o, d, tmax, pk, pi,
                              any_hit=any_hit)
    assert metrics.SYNCS["traversal"] == syncs
    assert counts() == after
    read = spec.values.tolist()
    assert read[3] > 0
    unresolved = spec.settle(read)
    if kind == "soup" and not any_hit:
        assert dense > 0 and unresolved
    if unresolved:
        assert counts() == after
    else:
        assert dense == 0
        assert change[0]["refill"] <= len(tbt.SPECULATIVE_BATCHES)
        settled = counts()
        added = [{k: a[k] - b[k] for k in a} for a, b in zip(settled, after)]
        # The speculative loops launch their fixed lanes whatever they
        # gather; every other count is the read-driven refill's.
        assert added[0] == change[0]
        assert added[1] == change[1] | {"lanes": read[3]}
        np.testing.assert_array_equal(t.numpy(), t_ref.numpy())
        np.testing.assert_array_equal(ids.numpy(), id_ref.numpy())


def test_speculative_refill_flags_rays_it_leaves(monkeypatch):
    """Loops too small for the unresolved rays leave some: reported."""
    tris, grid, o, d, tmax, pk, pi = _refill_rays("bounce")
    monkeypatch.setattr(tbt, "SPECULATIVE_BATCHES", (tbt.GROUP,))
    spec = tbt.Speculation(o.device)
    with spec:
        tbt.traverse(grid, tris, o, d, tmax, pk, pi)
    read = spec.values.tolist()
    assert read[0] == 1 and read[2] == tbt.GROUP
    loops = dict(tbt.LOOPS), dict(tbt.REFILL)
    assert spec.settle(read)
    assert (dict(tbt.LOOPS), dict(tbt.REFILL)) == loops
