"""Scene data, cameras, lane order and film of the PyTorch port, held
against the JAX package on the same inputs."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import bench_scenes as jbs
from mobileraytracer_tpu import cameras as jcam
from mobileraytracer_tpu import film as jfilm
from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import bench_scenes as tbs
from mobileraytracer_tpu_torch import constants as TC
from mobileraytracer_tpu_torch import cameras as tcam
from mobileraytracer_tpu_torch import convert
from mobileraytracer_tpu_torch import film as tfilm
from mobileraytracer_tpu_torch import sampling as tsampling
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch import scenes as tscenes
from mobileraytracer_tpu_torch.parallel import mesh as tmesh
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig

torch.set_num_threads(2)


def arrays(obj):
    """Nested {field: numpy array} of a JAX-package dataclass."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        out[f.name] = (arrays(v) if dataclasses.is_dataclass(v)
                       else np.asarray(v))
    return out


def assert_same(jax_obj, port_obj, path="scene"):
    """Every array of the port's dataclass equals the JAX one, with the
    same dtype and shape (bool stays bool, ids stay int32)."""
    for f in dataclasses.fields(port_obj):
        p = getattr(port_obj, f.name)
        j = getattr(jax_obj, f.name)
        if p is None:
            assert j is None, f"{path}.{f.name}"
        elif dataclasses.is_dataclass(p):
            assert_same(j, p, f"{path}.{f.name}")
        else:
            ja = np.asarray(j)
            pa = p.cpu().numpy()
            assert ja.dtype == pa.dtype, f"{path}.{f.name}"
            np.testing.assert_array_equal(pa, ja, err_msg=f"{path}.{f.name}")


@pytest.mark.parametrize("scene_id", [0, 1, 2, 3])
def test_builtin_scenes_equal(scene_id):
    js, jc = jscenes.load_builtin(scene_id, 1.0)
    ts, tc = tscenes.load_builtin(scene_id, 1.0)
    assert_same(js, ts)
    assert_same(jc, tc, "camera")


def test_conference_proxy_equal(monkeypatch):
    # Both packages must take the same branch for the optional reference
    # .mtl/.cam files.
    monkeypatch.setattr(tbs, "CONFERENCE_DIR", jbs.CONFERENCE_DIR)
    js, jc, jinfo = jbs.conference_proxy()
    ts, tc, tinfo = tbs.conference_proxy()
    assert tinfo == jinfo
    assert int(ts.triangles.valid.sum()) == tbs.CONFERENCE_PRIMS
    assert_same(js, ts)
    assert_same(jc, tc, "camera")


def test_convert_roundtrip():
    js, jc = jscenes.load_builtin(2, 1.0)
    assert_same(js, convert.scene_from_arrays(arrays(js)))
    assert_same(jc, convert.camera_from_arrays(arrays(jc)), "camera")


def test_tensor_data_identity_covers_every_field():
    """A scene whose block grid differs only in `top_m` shares every
    tensor, in the same order, but has another identity; a copy of the
    scene on the same tensors has the same one."""
    from mobileraytracer_tpu_torch.ops import block_traversal as tbt
    ts, _ = tscenes.load_builtin(0, 1.0)
    scene = tbt.build(ts, device="cpu")
    other = scene.replace(bvh=dataclasses.replace(scene.bvh, top_m=24))
    assert other.bvh.top_m != scene.bvh.top_m
    mine, theirs = list(scene.tensors()), list(other.tensors())
    assert len(mine) == len(theirs) > 0
    assert all(a is b for a, b in zip(mine, theirs))
    assert other.identity() != scene.identity()
    assert scene.replace().identity() == scene.identity()
    hash(scene.identity())


@pytest.mark.parametrize("scene_id", [0, 1])   # perspective, orthographic
def test_generate_rays_match(scene_id):
    _, jc = jscenes.load_builtin(scene_id, 1.0)
    _, tc = tscenes.load_builtin(scene_id, 1.0)
    rng = np.random.default_rng(scene_id)
    u, v = (rng.uniform(0, 1, 777).astype(np.float32) for _ in range(2))
    du, dv = (rng.uniform(-1e-3, 1e-3, 777).astype(np.float32)
              for _ in range(2))
    jo, jd = jcam.generate_rays(jc, *map(jnp.asarray, (u, v, du, dv)))
    to, td = tcam.generate_rays(tc, *map(torch.from_numpy, (u, v, du, dv)))
    # rtol 1e-6: a few float32 ulps for XLA's fusion of the basis sums.
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture
def cold_orders(monkeypatch):
    """An empty lane-table cache for the test; the process's is put back."""
    monkeypatch.setattr(trend, "_orders", collections.OrderedDict())
    return trend._orders


def _assert_tables(tout, jout):
    for j, t in zip(jout, tout):
        assert t.dtype == (torch.float32 if j.dtype == jnp.float32
                           else torch.int32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("wh", [(64, 64), (48, 32)])
def test_pixel_order_equal(wh, cold_orders):
    """The tables built on a cold cache and handed out again both equal
    the JAX package's."""
    w, h = wh
    jout = jrend._pixel_order(JConfig(width=w, height=h))
    for _ in range(2):
        _assert_tables(trend._pixel_order(TConfig(width=w, height=h)), jout)


@pytest.mark.parametrize("w,h,subtile", [(16, 16, 16), (37, 23, 16),
                                         (48, 32, 16), (512, 512, 16),
                                         (48, 32, 32)])
def test_pixel_order_cache_equals_fresh_build(w, h, subtile, cold_orders,
                                              monkeypatch):
    """The first call builds the key's tables, the second hands out the
    same tensor objects; both equal a fresh build (the JAX package's) at
    the subtile in force."""
    monkeypatch.setattr(TC, "SUBTILE", subtile)
    monkeypatch.setattr(jrend.C, "SUBTILE", subtile)
    jout = jrend._pixel_order(JConfig(width=w, height=h))
    before = dict(trend.ORDER)
    first = trend._pixel_order(TConfig(width=w, height=h))
    assert trend.ORDER == {"built": before["built"] + 1,
                           "reused": before["reused"]}
    again = trend._pixel_order(TConfig(width=w, height=h))
    assert trend.ORDER == {"built": before["built"] + 1,
                           "reused": before["reused"] + 1}
    assert all(a is b for a, b in zip(first, again))
    _assert_tables(again, jout)


def test_pixel_order_subtile_is_part_of_the_key(cold_orders, monkeypatch):
    cfg = TConfig(width=48, height=32)
    at16 = trend._pixel_order(cfg)
    monkeypatch.setattr(TC, "SUBTILE", 32)
    at32 = trend._pixel_order(cfg)
    assert len(cold_orders) == 2
    assert not torch.equal(at16[2], at32[2])


def test_pixel_order_cpu_devices_share_one_entry(cold_orders):
    cfg = TConfig(width=16, height=8)
    before = dict(trend.ORDER)
    outs = [trend._pixel_order(cfg, d)
            for d in (None, "cpu", torch.device("cpu"))]
    assert len(cold_orders) == 1
    assert trend.ORDER == {"built": before["built"] + 1,
                           "reused": before["reused"] + 2}
    for out in outs[1:]:
        assert all(a is b for a, b in zip(outs[0], out))


def test_pixel_order_cache_evicts_least_recently_used(cold_orders):
    cfgs = [TConfig(width=8 * (i + 1), height=8)
            for i in range(trend.ORDERS_KEPT + 1)]
    first = trend._pixel_order(cfgs[0])
    for cfg in cfgs[1:-1]:
        trend._pixel_order(cfg)
    assert trend._pixel_order(cfgs[0])[0] is first[0]   # most recent now
    trend._pixel_order(cfgs[-1])                         # evicts cfgs[1]
    assert len(cold_orders) == trend.ORDERS_KEPT
    assert [k[0] for k in cold_orders] == \
        [c.width for c in cfgs[2:-1]] + [8, cfgs[-1].width]
    built = trend.ORDER["built"]
    assert trend._pixel_order(cfgs[0])[0] is first[0]
    assert trend.ORDER["built"] == built
    trend._pixel_order(cfgs[1])
    assert trend.ORDER["built"] == built + 1


def test_no_path_writes_into_the_shared_lane_tables(cold_orders):
    """A Whitted frame, two progressive samples and the training step's
    lane set-up read the cached tables and leave them as built; a frame
    rendered on a cold cache equals the one rendered on the warm cache."""
    ts, tc = tscenes.load_builtin(0, 1.0)
    cfg = TConfig(width=16, height=16, spp=1, shader=TC.SHADER_WHITTED,
                  accelerator=TC.ACC_NAIVE)
    key = tsampling.prng_key(0, "cpu")
    cold = trend.render_frame(ts, tc, cfg, key)
    tables = trend._pixel_order(cfg)
    snapshot = [t.clone() for t in tables]
    warm = trend.render_frame(ts, tc, cfg, key)
    r = trend.Renderer(ts, tc, dataclasses.replace(cfg, spp=2),
                       device="cpu")
    r.render()
    assert r.sample == 2
    tmesh.prepared(ts, tc, cfg, key, np.zeros((16, 16, 3), np.float32))
    assert len(cold_orders) == 1
    assert all(a is b for a, b in zip(trend._pixel_order(cfg), tables))
    for t, s in zip(tables, snapshot):
        assert torch.equal(t, s)
    _assert_tables(tables, jrend._pixel_order(JConfig(width=16, height=16)))
    for k in ("image", "bitmap", "rays"):
        assert torch.equal(cold[k], warm[k])


def test_film_equal():
    rng = np.random.default_rng(0)
    # Radiance is never negative (float -> uint32 of a negative value is
    # implementation-defined), but may exceed 1 and then clamps.
    rgb = rng.uniform(0.0, 1.3, (500, 3)).astype(np.float32)
    acc = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    q = tfilm.quantize_abgr(torch.from_numpy(rgb))
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jfilm.quantize_abgr(rgb)))
    np.testing.assert_array_equal(
        tfilm.unpack_abgr(q).numpy(), np.asarray(jfilm.unpack_abgr(q.numpy())))
    for k in (1, 3, 7):
        np.testing.assert_array_equal(
            tfilm.incremental_avg_float(torch.from_numpy(acc),
                                        torch.from_numpy(rgb), k).numpy(),
            np.asarray(jfilm.incremental_avg_float(acc, rgb, k)))
