"""render_frame_auto of the PyTorch port against the JAX package's: the
dispatch cost and the chunk geometry over a table of configs, the chunked
Whitted frame against the port's fused frame (float32 and int_parity), a
chunked PathTracer frame against JAX's chunked frame, and a frame whose
lane count is not a multiple of 128 (JAX leaves those tail lanes black;
the port renders them as one shorter chunk)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import convert, sampling
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
from test_torch_pathtracer import assert_pt_frames_match
from test_torch_render import arrays, assert_frames_match

torch.set_num_threads(2)

# (width, height, shader, accelerator, samples_light, spp, budget)
GEOMETRY = [
    (512, 512, C.SHADER_WHITTED, C.ACC_BVH, 1, 1, 4.0e6),      # BASELINE #3
    (512, 512, C.SHADER_PATHTRACER, C.ACC_BVH, 1, 16, 4.0e6),  # BASELINE #4
    (256, 256, C.SHADER_WHITTED, C.ACC_REGULAR_GRID, 1, 1, 4.0e6),
    (64, 64, C.SHADER_WHITTED, C.ACC_REGULAR_GRID, 1, 1, 4.0e6),
    (640, 480, C.SHADER_DIFFUSE, C.ACC_BVH, 1, 32, 4.0e6),
    (100, 67, C.SHADER_PATHTRACER, C.ACC_NAIVE, 1, 2, 3.0e4),
    (64, 64, C.SHADER_WHITTED, C.ACC_BVH, 2, 4, 1.0e4),
    (48, 48, C.SHADER_NOSHADOWS, C.ACC_NAIVE, 1, 1, 700.0),
    (33, 32, C.SHADER_WHITTED, C.ACC_NAIVE, 1, 1, 1.0),
    (17, 17, C.SHADER_DEPTHMAP, C.ACC_NAIVE, 1, 3, 100.0),
]


def _port(obj):
    from_arrays = (convert.scene_from_arrays if hasattr(obj, "triangles")
                   else convert.camera_from_arrays)
    return from_arrays(arrays(obj))


def _config(case, cls):
    w, h, shader, acc, spl, spp, _ = case
    return cls(width=w, height=h, shader=shader, accelerator=acc,
               samples_light=spl, spp=spp)


@pytest.mark.parametrize("case", GEOMETRY, ids=lambda c: "-".join(map(str, c)))
def test_dispatch_cost_and_chunks_equal_jax(case, monkeypatch):
    """The same cost, and above the budget the same chunks: each package's
    sampler replaced by one that records its batch and returns each lane's
    pixel id, so the film shows which lanes every chunk covered."""
    budget = case[-1]
    jcfg, tcfg = _config(case, JConfig), _config(case, TConfig)
    assert trend._dispatch_cost(tcfg) == jrend._dispatch_cost(jcfg)
    assert trend.DISPATCH_UNIT_BUDGET == jrend.DISPATCH_UNIT_BUDGET
    assert trend._SHADER_COST == jrend._SHADER_COST
    if trend._dispatch_cost(tcfg.rounded()) <= budget:
        return

    jbatches, tbatches = [], []

    def jfake(scene, camera, config, key, s, u, v, pids, max_point=None):
        jbatches.append(u.shape[0])          # once, while step traces
        rgb = jnp.broadcast_to(pids.astype(jnp.float32)[:, None],
                               (u.shape[0], 3))
        return rgb, jnp.int32(1)

    def tfake(scene, camera, config, key, s, u, v, pids, max_point=None):
        tbatches.append(u.shape[0])
        return pids.float()[:, None].repeat(1, 3), torch.tensor(
            1, dtype=torch.int32)

    monkeypatch.setattr(jrend, "sample_pixels", jfake)
    monkeypatch.setattr(trend, "sample_pixels", tfake)
    js, jc = jscenes.load_builtin(0, 1.0)
    jout = jrend.render_frame_auto(js, jc, jcfg, jax.random.PRNGKey(0),
                                   budget=budget)
    tout = trend.render_frame_auto(_port(js), _port(jc), tcfg,
                                   sampling.prng_key(0), budget=budget)

    cfg = tcfg.rounded()
    b = cfg.width * cfg.height
    n_chunks, chunk = trend._chunk_geometry(cfg, budget)
    assert jbatches == [chunk]
    assert int(jout["rays"]) == cfg.spp * n_chunks
    tail = b - n_chunks * chunk
    chunks = [chunk] * n_chunks + [tail] * (tail > 0)
    assert tbatches == [c for c in chunks for _ in range(cfg.spp)]
    assert int(tout["rays"]) == len(tbatches)

    pixel_id = np.arange(b, dtype=np.float32).reshape(cfg.height, cfg.width)
    timg, jimg = tout["image"].numpy(), np.asarray(jout["image"])
    assert (timg == pixel_id[..., None]).all()
    _, _, pids, _ = jrend._pixel_order(cfg)
    jtail = np.zeros(b, bool)
    jtail[np.asarray(pids)[n_chunks * chunk:]] = True
    jtail = jtail.reshape(cfg.height, cfg.width)
    assert (jimg[jtail] == 0).all()
    assert (jimg[~jtail] == timg[~jtail]).all()


@pytest.mark.parametrize("accumulation", ["float32", "int_parity"])
def test_chunked_whitted_frame_equals_fused(accumulation):
    """As the JAX package's test_engine.py holds its own: the smallest
    budget cuts the frame into 128-lane chunks, and the bitmap, image and
    rays equal the fused frame's; without a budget it is the fused frame."""
    scene, cam = map(_port, jscenes.load_builtin(0, 1.0))
    cfg = TConfig(width=32, height=32, spp=2, shader=C.SHADER_WHITTED,
                  accelerator=C.ACC_NAIVE, accumulation=accumulation)
    key = sampling.prng_key(0)
    assert trend._chunk_geometry(cfg, 1.0) == (8, 128)
    ref = trend.render_frame(scene, cam, cfg, key)
    for out in (trend.render_frame_auto(scene, cam, cfg, key, budget=1.0),
                trend.render_frame_auto(scene, cam, cfg, key)):
        for k in ("bitmap", "image", "rays"):
            assert torch.equal(out[k], ref[k]), k


def test_chunked_pathtracer_frame_matches_jax():
    """cornell2's PathTracer at 32x32, 2 spp, in four 256-lane chunks: the
    walker compacts and groups NEE within each chunk, so this frame differs
    from the fused one and only JAX's chunked frame can hold it."""
    kw = dict(width=32, height=32, spp=2, shader=C.SHADER_PATHTRACER,
              accelerator=C.ACC_NAIVE, nee_share=128,
              nee_share_secondary=True)
    budget = 6000.0
    assert trend._chunk_geometry(TConfig(**kw), budget) == (4, 256)
    js, jc = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    jout = jrend.render_frame_auto(js, jc, JConfig(**kw),
                                   jax.random.PRNGKey(0), budget=budget)
    scene, cam, key = _port(js), _port(jc), sampling.prng_key(0)
    tout = trend.render_frame_auto(scene, cam, TConfig(**kw), key,
                                   budget=budget)
    assert int(tout["rays"]) == int(jout["rays"])
    assert_pt_frames_match(tout["image"].numpy(), jout["image"])
    fused = trend.render_frame(scene, cam, TConfig(**kw), key)
    assert not torch.equal(fused["image"], tout["image"])


def test_tail_lanes_render_in_the_port_and_stay_black_in_jax():
    """33x32 = 1,056 lanes: eight 128-lane chunks and 32 tail lanes.  JAX's
    tail pixels stay zero; the port's frame equals its own fused frame,
    and on the other pixels JAX's."""
    kw = dict(width=33, height=32, spp=1, shader=C.SHADER_WHITTED,
              accelerator=C.ACC_NAIVE)
    js, jc = jscenes.load_builtin(0, 1.0)
    jout = jrend.render_frame_auto(js, jc, JConfig(**kw),
                                   jax.random.PRNGKey(0), budget=1.0)
    scene, cam = _port(js), _port(jc)
    key = sampling.prng_key(0)
    tout = trend.render_frame_auto(scene, cam, TConfig(**kw), key,
                                   budget=1.0)
    ref = trend.render_frame(scene, cam, TConfig(**kw), key)
    for k in ("bitmap", "image", "rays"):
        assert torch.equal(tout[k], ref[k]), k

    _, _, pids, _ = trend._pixel_order(TConfig(**kw))
    tail = np.zeros(33 * 32, bool)
    tail[pids[8 * 128:].numpy()] = True
    tail = tail.reshape(32, 33)
    jimg, timg = np.asarray(jout["image"]), tout["image"].numpy()
    assert (jimg[tail] == 0).all() and (timg[tail] > 0).any()
    assert_frames_match(timg[~tail], jimg[~tail])
    assert int(tout["rays"]) > int(jout["rays"])
