"""Material recovery by differentiable rendering on one device (port of
`mobileraytracer_tpu/parallel/recover.py`, BASELINE.md config #4's
inverse form).

Each step renders the scene with the current materials, takes autograd's
gradient of the loss of parallel/mesh.py and applies
`torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)` (optax's `adam` up
to rounding: PyTorch takes the bias corrections in float64), then clamps
the parameters to their physical range: kd, ks, kt and ior to [0, 1], le
to >= 0.  Step s draws with `fold_in(key, s)`, so a run resumed from a
checkpoint (utils/checkpoint.py, the JAX package's layout) equals an
uninterrupted one.  A state is (params, optimizer).
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from .. import sampling
from ..types import Camera, RenderConfig, Scene
from . import mesh as pmesh

BETAS = (0.9, 0.999)
EPS = 1e-8


def make_state(params: dict, learning_rate: float):
    """(params as fresh leaf tensors, a new Adam over them)."""
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate,
                           betas=BETAS, eps=EPS)
    return params, opt


def make_recovery_step(scene: Scene, camera: Camera, config: RenderConfig,
                       group=None, params_subset: Iterable[str] = ("kd", "le"),
                       learning_rate: float = 0.05, max_point=None):
    """Returns (step_fn, init_state): `step_fn(state, key, target) ->
    (state, loss)` with state = (params, optimizer).  Only the fields in
    `params_subset` are optimized; the rest of the material table stays
    at the scene's values."""
    pmesh.check_group(group)
    full = pmesh.material_params(scene.materials)
    subset = tuple(params_subset)

    def step_fn(state, key, target):
        params, opt = state
        prep = pmesh.prepared(scene, camera, config, key, target, max_point)
        loss, grads = pmesh.loss_and_grads(dict(full, **params), scene,
                                           config, prep, subset)
        opt.zero_grad(set_to_none=True)
        for k in subset:
            params[k].grad = grads[k]
        opt.step()
        with torch.no_grad():
            for k in subset:
                params[k].clamp_(0.0, None if k == "le" else 1.0)
        return (params, opt), loss

    return step_fn, make_state({k: full[k] for k in subset}, learning_rate)


def recover_materials(scene: Scene, camera: Camera, config: RenderConfig,
                      target_image, group=None, steps: int = 200,
                      params_subset: Iterable[str] = ("kd",),
                      learning_rate: float = 0.05, base_key=None,
                      init_params: Optional[dict] = None,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 50, resume: bool = False,
                      max_point=None) -> Tuple[dict, np.ndarray]:
    """Runs the recovery loop; returns (recovered params, per-step losses).
    With `checkpoint_path` the state, step and losses are saved every
    `checkpoint_every` steps, and `resume=True` continues from that file."""
    from ..utils import checkpoint as ckpt

    step_fn, state = make_recovery_step(
        scene, camera, config, group, params_subset=params_subset,
        learning_rate=learning_rate, max_point=max_point)
    if init_params is not None:
        dev = scene.device
        state = make_state({k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                            for k, v in dict(init_params).items()},
                           learning_rate)
    key = (base_key if base_key is not None
           else sampling.prng_key(config.seed))
    start, losses = 0, []
    if resume and checkpoint_path:
        loaded = ckpt.load_opt_state(checkpoint_path, state)
        if loaded is not None:
            state, start, losses = loaded
    target = torch.as_tensor(target_image, dtype=torch.float32).to(
        scene.device)
    for s in range(start, steps):
        state, loss = step_fn(state, sampling.fold_in(key, s), target)
        losses.append(float(loss))
        if checkpoint_path and (s + 1) % checkpoint_every == 0:
            ckpt.save_opt_state(checkpoint_path, state, s + 1, losses)
    return {k: p.detach() for k, p in state[0].items()}, np.asarray(losses)
