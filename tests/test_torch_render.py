"""Whole frames of the PyTorch port against the JAX package: cornell at
64x64, Whitted over the block BVH.  4,096 lanes take the walker's
compaction branch (tile-MT primary pass, banded tail and shadows)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import Renderer
from mobileraytracer_tpu_torch import convert
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch import sampling
from mobileraytracer_tpu_torch import scenes as tscenes
from mobileraytracer_tpu_torch.ops import kernels
from mobileraytracer_tpu_torch.types import RenderConfig as TConfig

torch.set_num_threads(2)

# Image tolerance: the JAX frame runs XLA's CPU code, which contracts
# products and sums into FMAs, while the port rounds each operation; the
# shading then differs by float32 ulps (measured max 1e-5).  A ray that
# grazes an edge may still flip, so 0.1% of pixels may differ more.
IMG_ATOL = 1e-4
IMG_FRACTION = 0.999


def arrays(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is not None:
            out[f.name] = (arrays(v) if dataclasses.is_dataclass(v)
                           else np.asarray(v))
    return out


def assert_frames_match(port_img, jax_img):
    err = np.abs(np.asarray(port_img) - np.asarray(jax_img)).max(-1)
    assert np.isfinite(port_img).all()
    assert (err <= IMG_ATOL).mean() >= IMG_FRACTION, err.max()


@pytest.mark.parametrize("share", [(16, False), (128, True)])
def test_cornell_frame_matches_jax(share):
    nee_share, share2 = share
    kw = dict(width=64, height=64, spp=1, shader=1, accelerator=3,
              nee_share=nee_share, nee_share_secondary=share2)
    js, jc = jscenes.load_builtin(0, 1.0)
    jsp = jpb.build(js)
    jout = jrend.render_frame(jsp, jc, JConfig(**kw), jax.random.PRNGKey(0))

    tsp = convert.scene_from_arrays(arrays(jsp))
    tc = convert.camera_from_arrays(arrays(jc))
    kernels.reset_launches()
    tout = trend.render_frame(tsp, tc, TConfig(**kw), sampling.prng_key(0))
    assert not any(kernels.LAUNCHES.values())   # CPU: plain versions
    assert int(tout["rays"]) == int(jout["rays"]) == 8225
    assert_frames_match(tout["image"].numpy(), jout["image"])
    np.testing.assert_array_equal(
        (tout["bitmap"].numpy() != np.asarray(jout["bitmap"])).mean() <= 0.001,
        True)

    # The Renderer entry point builds its own block grid from the port's
    # scene (bit-equal to the JAX build) and gives the same frame.
    ts, tc2 = tscenes.load_builtin(0, 1.0)
    r = Renderer(ts, tc2, TConfig(**kw), device="cpu")
    img = r.render()
    np.testing.assert_array_equal(img, tout["image"].numpy())
    assert r.total_rays == int(tout["rays"])
    assert r.bitmap.shape == (64, 64)
