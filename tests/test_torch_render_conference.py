"""Whole frames of the PyTorch port against the JAX package on the
20,000-triangle conference proxy at 64x64 with the bench's NEE settings
(nee_share=128, reversed shadows, with and without secondary sharing),
and the committed golden of that frame, which `chip_smoke.py` holds the
port against on the GPU."""
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import bench_scenes as jbs
from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import convert
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch import sampling
from test_torch_render import arrays, assert_frames_match

torch.set_num_threads(2)

GOLDEN = (pathlib.Path(__file__).parent / "data"
          / "torch_port_golden_conference64.npy")


@pytest.mark.parametrize("share2", [True, False])
def test_conference20k_frame_matches_jax(share2):
    kw = dict(width=64, height=64, spp=1, shader=1, accelerator=3,
              nee_share=128, nee_share_secondary=share2)
    js, jc, _ = jbs.conference_proxy(target_prims=20000)
    jsp = jpb.build(js)
    jout = jrend.render_frame(jsp, jc, JConfig(**kw), jax.random.PRNGKey(0))
    jimg = np.asarray(jout["image"])

    tsp = convert.scene_from_arrays(arrays(jsp))
    tc = convert.camera_from_arrays(arrays(jc))
    from mobileraytracer_tpu_torch.types import RenderConfig as TConfig
    tout = trend.render_frame(tsp, tc, TConfig(**kw), sampling.prng_key(0))
    assert int(tout["rays"]) == int(jout["rays"]) == 7658
    assert_frames_match(tout["image"].numpy(), jimg)

    # The golden is this JAX frame (bench settings); it must not go stale.
    # The same tolerance: another CPU may fuse XLA's arithmetic otherwise.
    if share2:
        golden = np.load(GOLDEN)
        assert golden.shape == (64, 64, 3) and golden.dtype == np.float32
        assert_frames_match(golden, jimg)
