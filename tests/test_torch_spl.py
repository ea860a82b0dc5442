"""Frames with two light samples per diffuse hit (samples_light=2, the
CLI's --spl) against the JAX package: the loop over light samples in
shaders.common.direct_lighting, on cornell2's area lights at 32x32."""
import jax
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu import scenes as jscenes
from mobileraytracer_tpu.types import RenderConfig as JConfig
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import sampling, scenes
from mobileraytracer_tpu_torch.renderer import render_frame
from mobileraytracer_tpu_torch.types import RenderConfig
from test_torch_pathtracer import assert_pt_frames_match
from test_torch_render import assert_frames_match

torch.set_num_threads(2)


@pytest.mark.parametrize("shader", [C.SHADER_WHITTED, C.SHADER_PATHTRACER])
def test_two_light_samples_match_jax(shader):
    kw = dict(width=32, height=32, spp=1, shader=shader, samples_light=2,
              accelerator=C.ACC_NAIVE)
    js, jc = jscenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    jout = jrend.render_frame(js, jc, JConfig(**kw), jax.random.PRNGKey(4))
    ts, tc = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    tout = render_frame(ts, tc, RenderConfig(**kw), sampling.prng_key(4))
    one = render_frame(ts, tc, RenderConfig(**dict(kw, samples_light=1)),
                       sampling.prng_key(4))
    assert int(tout["rays"]) == int(jout["rays"])
    # The second light sample casts its own shadow rays.
    assert int(tout["rays"]) > int(one["rays"])
    img = tout["image"].numpy()
    if shader == C.SHADER_PATHTRACER:
        assert_pt_frames_match(img, np.asarray(jout["image"]))
    else:
        assert_frames_match(img, np.asarray(jout["image"]))
    assert not np.array_equal(img, one["image"].numpy())
