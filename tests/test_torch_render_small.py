"""A small frame of the PyTorch port against the JAX package: cornell at
16x16 (256 lanes, below the walker's 1,024-lane compaction threshold, so
the small-batch full loop runs) with 2 spp, so the "prng" pixel jitter
and the sample loop run too."""
import jax
import numpy as np
import torch

from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import Renderer, convert, sampling
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch import scenes as tscenes
from mobileraytracer_tpu_torch.shaders import engine
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
from test_torch_render import arrays, assert_frames_match

torch.set_num_threads(2)


def test_small_batch_jittered_frame_matches_jax():
    kw = dict(width=16, height=16, spp=2, shader=1, accelerator=3)
    js, jc = jscenes.load_builtin(0, 1.0)
    jout = jrend.render_frame(jpb.build(js), jc, JConfig(**kw),
                              jax.random.PRNGKey(3))

    ts, tc = tscenes.load_builtin(0, 1.0)
    cfg = TConfig(**kw)
    assert cfg.resolved_pixel_jitter()
    engine.WALK["steps"] = 0
    r = Renderer(ts, tc, TConfig(**kw, seed=3), device="cpu")
    img = r.render()
    # Full-batch steps only: two samples of at most max_walk_iters each,
    # more than one step each (the mirror sphere pushes children).
    assert 2 < engine.WALK["steps"] <= 2 * cfg.resolved_max_walk_iters()
    assert r.total_rays == int(jout["rays"])
    assert_frames_match(img, np.asarray(jout["image"]))

    # render_frame on the JAX-built scene gives the Renderer's frame.
    tout = trend.render_frame(convert.scene_from_arrays(arrays(jpb.build(js))),
                              convert.camera_from_arrays(arrays(jc)), cfg,
                              sampling.prng_key(3))
    assert int(tout["rays"]) == r.total_rays
    np.testing.assert_array_equal(tout["image"].numpy(), img)
