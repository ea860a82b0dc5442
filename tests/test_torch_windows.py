"""The candidate-window dispatch, the window kernel's wrapper checks, its
sort key and its bound, on the CPU (the kernel itself runs only on the
card: tests/test_torch_cuda.py).  Imports neither jax nor the JAX
package."""
import numpy as np
import pytest
import torch

from mobileraytracer_tpu_torch import bench_scenes, cameras, renderer
from mobileraytracer_tpu_torch.ops import block_traversal as bt
from mobileraytracer_tpu_torch.ops import kernels as K
from mobileraytracer_tpu_torch.types import RenderConfig

torch.set_num_threads(2)

_CACHE = {}


def proxy20k():
    """The 20,000-triangle proxy's block grid on the CPU and the camera's
    primary rays of a 32x32 image (1,024 rays, 64 subtiles)."""
    if "g" not in _CACHE:
        scene, cam, _ = bench_scenes.conference_proxy(target_prims=20000)
        _, grid = bt.build_blocks(scene.triangles)
        u, v, _, _ = renderer._pixel_order(RenderConfig(width=32, height=32))
        zero = torch.zeros_like(u)
        o, d = cameras.generate_rays(cam, u, v, zero, zero)
        _CACHE["g"] = grid, o, d
    return _CACHE["g"]


@pytest.mark.parametrize("bounds", ["none", "cap+floor"])
def test_cpu_tensors_take_the_plain_version(monkeypatch, bounds):
    grid, o, d = proxy20k()
    nt = o.shape[0] // K.ST
    rng = np.random.default_rng(5)
    kw = {} if bounds == "none" else {
        "cap": torch.from_numpy(rng.uniform(300, 1500, nt).astype(np.float32)),
        "floor": torch.from_numpy(rng.uniform(0, 600, nt).astype(np.float32))}

    def refuse(*args, **kwargs):
        raise AssertionError("CPU tensors reached the window kernel")
    monkeypatch.setattr(K, "candidate_windows", refuse)
    K.reset_launches()
    got = bt._candidates(grid, o, d, **kw)
    want = bt._candidates_plain(grid, o, d, **kw)
    assert K.LAUNCHES["window"] == 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _wrapper_args(**change):
    """Arguments of kernels.candidate_windows on a made-up table of 200
    supers of 16 blocks and 64 rays in 4 bundles, with `change` applied."""
    k1, bps = 200, 16
    a = dict(super_lo=torch.zeros(3, k1), super_hi=torch.ones(3, k1),
             blocks_packed=torch.zeros(k1, 8 * bps), nb=k1 * bps,
             o=torch.zeros(64, 3), d=torch.ones(64, 3), cap=torch.ones(4),
             floor=None, st=16, s=32, m=48)
    a.update(change)
    return a


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA tensors"),
    ("deep_s", "128"),
    ("deep_m", "128"),
    ("m_past_s_bps", "top_s BPS"),
    ("ragged_bundles", "whole number"),
    ("cap_shape", r"cap must be \(4,\)"),
    ("column_stride", "unit column stride"),
    ("packed_shape", "blocks_packed"),
])
def test_window_wrapper_refuses(case, match):
    change = {
        "cpu": {},
        "deep_s": {"s": 129, "m": 48},
        "deep_m": {"s": 32, "m": 129},
        "m_past_s_bps": {"s": 2, "m": 33},
        "ragged_bundles": {"o": torch.zeros(60, 3), "d": torch.ones(60, 3)},
        "cap_shape": {"cap": torch.ones(5)},
        "column_stride": {"o": torch.zeros(3, 64).t()},
        "packed_shape": {"blocks_packed": torch.zeros(200, 100)},
    }[case]
    with pytest.raises(ValueError, match=match):
        K.candidate_windows(**_wrapper_args(**change))


def window_key(v, idx):
    """numpy mirror of the window kernel's sort key (make_key in
    csrc/candidate_windows.cu): the float's bits made orderable, -0.0
    folded onto +0.0 and any NaN onto the top, above the index, and a last
    bit that remembers a -0.0."""
    v = np.asarray(v, np.float32)
    u = v.view(np.uint32).astype(np.uint64)
    neg_zero = (u == 0x80000000).astype(np.uint64)
    u = np.where(neg_zero == 1, np.uint64(0), u)
    order = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    order = np.where(np.isnan(v), np.uint64(0xFFFFFFFF), order)
    return ((order.astype(np.uint64) << np.uint64(32))
            | (np.asarray(idx, np.uint64) << np.uint64(1)) | neg_zero)


def window_key_value(k):
    """The value a key was made from (key_value in the kernel)."""
    k = np.asarray(k, np.uint64)
    order = k >> np.uint64(32)
    u = np.where(order & 0x80000000, order & 0x7FFFFFFF, ~order & 0xFFFFFFFF)
    v = u.astype(np.uint32).view(np.float32).copy()
    v[order == 0xFFFFFFFF] = np.nan
    v[(k & np.uint64(1)) == 1] = -0.0
    return v


def _key_case(case, rng):
    n = 777
    if case == "ties":
        return rng.integers(0, 6, n).astype(np.float32) * np.float32(0.25)
    if case == "signed_zeros":
        return rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), n)
    if case == "infinities":
        return rng.choice(np.array([np.inf, -np.inf, 3.0, 1e30, -2.0],
                                   np.float32), n)
    v = rng.normal(size=n).astype(np.float32)
    v[rng.integers(0, n, 200)] = rng.choice(np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 7.5],
        np.float32), 200)
    return v


@pytest.mark.parametrize("case", ["ties", "signed_zeros", "infinities",
                                  "mixed"])
def test_window_key_orders_as_stable_sort(case):
    v = _key_case(case, np.random.default_rng(len(case)))
    keys = window_key(v, np.arange(v.size))
    assert np.unique(keys).size == v.size
    vals, idx = torch.sort(torch.from_numpy(v), stable=True)
    np.testing.assert_array_equal(np.argsort(keys), idx.numpy())
    back = window_key_value(keys)
    finite = ~np.isnan(v)
    np.testing.assert_array_equal(back[finite].view(np.uint32),
                                  v[finite].view(np.uint32))
    assert np.isnan(back[~finite]).all()
    got = back[np.argsort(keys)]
    want = vals.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  want[ok].view(np.uint32))


def test_window_bound_counts_the_refill_call():
    """The refill's window call: 65,536 bundles of 16 rays over the
    conference proxy's 241 supers, 32 of them chosen, windows of 48."""
    b = K.window_bound(65536 * 16, 65536, 241, 32, 16, 48, 2)
    assert b["tests"] == 65536 * (241 + 32 * 16)
    assert b["ops"] == b["tests"] * 36 + 65536 * 16 * 3
    assert b["bytes"] == (65536 * 16 * 24 + 241 * 24 + 241 * 512
                          + 65536 * 8 + 65536 * (48 * 12 + 4))
    assert b["by"] == "compute" and 0.02 < b["ms"] < 0.04
