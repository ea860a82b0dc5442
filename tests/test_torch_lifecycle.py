"""The port's Renderer lifecycle, checkpoints, guards and metrics:
test_lifecycle.py's and test_guards.py's cases on device="cpu", a bitwise
checkpoint resume, and checkpoints passed between the two packages."""
import dataclasses
import json
import time

import jax
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import sampling, scenes
from mobileraytracer_tpu_torch.renderer import (Renderer, STATE_BUSY,
                                                STATE_FINISHED, STATE_IDLE,
                                                STATE_STOPPED)
from mobileraytracer_tpu_torch.types import RenderConfig
from mobileraytracer_tpu_torch.utils import PhaseTimer, RunMetrics, guards
from test_torch_render import assert_frames_match

torch.set_num_threads(2)

TIMEOUT = 120


def _kw(spp=4, size=16):
    return dict(width=size, height=size, spp=spp, shader=C.SHADER_WHITTED,
                accelerator=C.ACC_NAIVE)


def _renderer(spp=4, size=16):
    scene, cam = scenes.load_builtin(C.SCENE_CORNELL, 1.0)
    return Renderer(scene, cam, RenderConfig(**_kw(spp, size)), device="cpu")


def _jax_renderer(spp=4, size=16):
    scene, cam = jscenes.load_builtin(C.SCENE_CORNELL, 1.0)
    return jrend.Renderer(scene, cam, JConfig(**_kw(spp, size)))


def test_state_machine_idle_busy_finished():
    r = _renderer(spp=2)
    assert r.state == STATE_IDLE
    seen = []
    r.render(callback=lambda rr: seen.append((rr.state, rr.sample)))
    assert seen == [(STATE_BUSY, 1), (STATE_BUSY, 2)]
    assert r.state == STATE_FINISHED and r.render_seconds > 0 and r.fps > 0


def test_state_machine_stopped():
    r = _renderer(spp=50)
    r.render(callback=lambda rr: rr.stop_render())
    assert r.state == STATE_STOPPED and r.sample == 1
    r.render()                        # stays stopped until reset
    assert r.state == STATE_STOPPED and r.sample == 1
    r.reset()
    assert (r.state, r.sample, r.total_rays) == (STATE_IDLE, 0, 0)
    assert not r.image.any()


def test_async_render_polls_whole_frames():
    """render_async returns at once, BUSY; every bitmap a poller reads is
    the whole frame at some sample count (one of a synchronous render's
    bitmaps), and the worker finishes."""
    sync = _renderer(spp=3)
    frames = [sync.bitmap]
    sync.render(callback=lambda rr: frames.append(rr.bitmap))
    r = _renderer(spp=3)
    t = r.render_async()
    assert r.state == STATE_BUSY
    polled = []
    deadline = time.time() + TIMEOUT
    while r.state == STATE_BUSY and time.time() < deadline:
        polled.append(r.bitmap)
        time.sleep(0.005)
    assert r.wait(TIMEOUT) == STATE_FINISHED
    assert not t.is_alive() and r.sample == 3
    polled.append(r.bitmap)
    for bm in polled:
        assert any(np.array_equal(bm, f) for f in frames)
    np.testing.assert_array_equal(r.bitmap, frames[-1])
    assert r.total_rays == sync.total_rays


def test_async_stop_render_concurrent():
    r = _renderer(spp=500)
    r.render_async()
    deadline = time.time() + TIMEOUT
    while r.sample < 2 and time.time() < deadline:
        time.sleep(0.005)
    assert r.sample >= 2, "render thread made no progress"
    r.stop_render()
    assert r.wait(TIMEOUT) == STATE_STOPPED
    assert not r._thread.is_alive()
    assert 2 <= r.sample < 500 and r.fps > 0


def test_async_double_start_rejected():
    r = _renderer(spp=200)
    r.render_async()
    try:
        with pytest.raises(RuntimeError):
            r.render_async()
    finally:
        r.stop_render()
        assert r.wait(TIMEOUT) == STATE_STOPPED


def test_async_error_reaches_wait():
    r = _renderer(spp=2)

    def boom(_):
        raise ValueError("callback failed")
    r.render_async(callback=boom)
    with pytest.raises(ValueError, match="callback failed"):
        r.wait(TIMEOUT)
    assert r.state == STATE_STOPPED


def test_stats_line_and_preview_match_jax():
    r = _renderer(spp=1, size=32)
    j = _jax_renderer(spp=1, size=32)
    r.render()
    j.render()
    j.fps = r.fps
    assert r.stats_line() == j.stats_line()
    assert "r:32x32" in r.stats_line() and "state:FINISHED" in r.stats_line()
    img = r.preview()
    assert img.shape == (32, 32, 3) and img.max() > 0.5
    assert_frames_match(img, j.preview())


def test_checkpoint_resume_bitwise(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    full = _renderer(spp=4)
    img_full = full.render()
    a = _renderer(spp=4)
    a.render(callback=lambda rr: rr.sample == 2 and rr.stop_render())
    assert a.sample == 2
    a.save_checkpoint(path)
    b = _renderer(spp=4)
    b.load_checkpoint(path)
    assert (b.sample, b.state) == (2, STATE_IDLE)
    np.testing.assert_array_equal(b.render(), img_full)
    assert b.total_rays == full.total_rays


def test_checkpoint_config_mismatch_rejected(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    _renderer(spp=4).save_checkpoint(path)
    with pytest.raises(ValueError):
        _renderer(spp=8).load_checkpoint(path)


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint the JAX Renderer wrote at sample 2 resumes in the port,
    and the port's in the JAX Renderer: each ends at the JAX package's
    uninterrupted frame within the frames' tolerance, with the same rays.
    Both files hold the same keys."""
    j_full = _jax_renderer(spp=4)
    img_full = j_full.render()
    stop2 = lambda rr: rr.sample == 2 and rr.stop_render()  # noqa: E731

    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j = _jax_renderer(spp=4)
    j.render(callback=stop2)
    j.save_checkpoint(jpath)
    t = _renderer(spp=4)
    t.render(callback=stop2)
    t.save_checkpoint(tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(bytes(a["config_json"])) == json.loads(
            bytes(b["config_json"]))

    t2 = _renderer(spp=4)
    t2.load_checkpoint(jpath)
    assert t2.sample == 2
    assert_frames_match(t2.render(), img_full)
    assert t2.total_rays == j_full.total_rays
    j2 = _jax_renderer(spp=4)
    j2.load_checkpoint(tpath)
    assert j2.sample == 2
    assert_frames_match(j2.render(), img_full)
    assert j2.total_rays == j_full.total_rays


def test_checkpoint_extras_cross_packages(tmp_path):
    """save_render_state(extra=) and load_render_state's 5-tuple: a JAX
    checkpoint's extras survive the port's loader, and the port's extras
    (numpy arrays and tensors) survive JAX's, exactly and with their
    dtypes."""
    from mobileraytracer_tpu.utils import checkpoint as jck
    from mobileraytracer_tpu_torch.utils import checkpoint as tck
    rng = np.random.default_rng(0)
    accum = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    extra = {"kd": rng.uniform(0, 1, (4, 3)).astype(np.float32),
             "step": np.asarray(7, np.int64),
             "mask": rng.uniform(0, 1, (5,)) > 0.5}
    cfg = _kw(spp=4, size=8)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jck.save_render_state(jpath, accum, 3, 123, JConfig(**cfg), extra=extra)
    acc, sample, rays, config, got = tck.load_render_state(jpath)
    np.testing.assert_array_equal(acc, accum)
    assert (sample, rays, config) == (3, 123, RenderConfig(**cfg))
    assert sorted(got) == sorted(extra)
    for k, v in extra.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v)

    tck.save_render_state(tpath, torch.from_numpy(accum), 3, 123,
                          RenderConfig(**cfg),
                          extra=dict(extra, kd=torch.from_numpy(extra["kd"])))
    acc, sample, rays, config, got = jck.load_render_state(tpath)
    np.testing.assert_array_equal(np.asarray(acc), accum)
    assert (sample, rays, config) == (3, 123, JConfig(**cfg))
    assert sorted(got) == sorted(extra)
    for k, v in extra.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v)
    # Without extras both files hold the same keys, and the dict is empty.
    jck.save_render_state(jpath, accum, 3, 123, JConfig(**cfg))
    tck.save_render_state(tpath, torch.from_numpy(accum), 3, 123,
                          RenderConfig(**cfg))
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
    assert tck.load_render_state(jpath)[4] == {}


def _replace(scene, part, **kw):
    return dataclasses.replace(
        scene, **{part: dataclasses.replace(getattr(scene, part), **kw)})


def test_validate_scene():
    for sid in range(4):
        guards.validate_scene(scenes.load_builtin(sid, 1.0)[0])
    scene, _ = scenes.load_builtin(C.SCENE_CORNELL, 1.0)
    pa = scene.triangles.point_a.clone()
    pa[0, 0] = float("nan")
    with pytest.raises(guards.SceneError, match="point_a"):
        guards.validate_scene(_replace(scene, "triangles", point_a=pa))
    r2 = scene.spheres.sq_radius.clone()
    r2[0] = 0.0
    with pytest.raises(guards.SceneError, match="sq_radius"):
        guards.validate_scene(_replace(scene, "spheres", sq_radius=r2))
    n = scene.planes.normal.clone()
    n[0] = 0.0
    with pytest.raises(guards.SceneError, match="planes.normal"):
        guards.validate_scene(_replace(scene, "planes", normal=n))


def test_checked_render():
    scene, cam = scenes.load_builtin(C.SCENE_CORNELL, 1.0)
    cfg = RenderConfig(width=16, height=16, shader=C.SHADER_NOSHADOWS)
    out = guards.checked_render(scene, cam, cfg, sampling.prng_key(0))
    assert torch.isfinite(out["image"]).all() and out["image"].max() > 0
    # Past the scene check (materials are checked there), a NaN in the
    # film still trips: Kd is clean, the light's radiance is not.
    le = scene.lights.radiance.clone()
    le[0] = float("nan")
    with pytest.raises(guards.RenderError, match="non-finite"):
        guards.checked_render(_replace(scene, "lights", radiance=le), cam,
                              RenderConfig(width=16, height=16),
                              sampling.prng_key(0))
    kd = scene.materials.kd.clone()
    kd[0] = float("nan")
    with pytest.raises(guards.SceneError, match="kd"):
        guards.checked_render(_replace(scene, "materials", kd=kd), cam, cfg,
                              sampling.prng_key(0))


def test_oom_guard():
    with pytest.raises(guards.LowDeviceMemoryError, match="allocation"):
        with guards.device_oom_guard():
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried")
    with pytest.raises(ValueError):
        with guards.device_oom_guard():
            raise ValueError("unrelated")


def test_metrics(tmp_path):
    timer = PhaseTimer()
    with timer.phase("loading"):
        time.sleep(0.01)
    with timer.phase("loading"):
        pass
    assert list(timer.seconds) == ["loading"]
    assert timer.seconds["loading"] >= 0.01
    path = tmp_path / "m.jsonl"
    m = RunMetrics(str(path))
    m.update(shader=1)
    assert m.rays_per_second(1000, 0.5) == 2000.0
    line = m.emit()
    m.emit()
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    assert rows == [json.loads(line)] * 2
    assert rows[0] == {"shader": 1, "total_rays": 1000, "render_seconds": 0.5,
                       "rays_per_second": 2000.0, "mrays_per_second": 0.002}
