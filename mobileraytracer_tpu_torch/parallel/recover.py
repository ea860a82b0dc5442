"""Material recovery by differentiable rendering (port of
`mobileraytracer_tpu/parallel/recover.py`, BASELINE.md config #4's inverse
form), on one device or sharded over a mesh (parallel/mesh.py).

Each step renders the scene with the current materials, takes autograd's
gradient of the loss of parallel/mesh.py (all-reduced over the mesh) and
applies `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)` (optax's
`adam` up to rounding: PyTorch takes the bias corrections in float64),
then clamps the parameters to their physical range: kd, ks, kt and ior to
[0, 1], le to >= 0.  Besides the material fields, "radiance", the lights'
radiance (scene.lights.radiance, (L, 3)), is recoverable, clamped to
>= 0 as le is: the emission of a scene whose emitters are area lights
(the JAX package recovers the material fields alone).  Over a mesh every
rank keeps its own Adam, fed the
same all-reduced gradient, and after each step the ranks compare a digest
of their parameters; where the backend's sum was not bitwise the same on
every rank, the mesh's first rank's state is broadcast.  Step s draws with
`fold_in(key, s)`, so a run resumed from a checkpoint (utils/checkpoint.py,
the JAX package's layout; over a mesh the first rank writes it and every
rank reads it) equals an uninterrupted one.  A state is (params,
optimizer).

Tracing (utils/metrics.py): a step is the unit span `recover.step`; in it
`recover.forward` (the loss's render), `recover.backward` (autograd) and
`recover.update` (Adam and the clamp).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from .. import sampling
from ..types import Camera, Materials, RenderConfig, Scene
from ..utils.metrics import span
from . import mesh as pmesh

BETAS = (0.9, 0.999)
EPS = 1e-8

# When a dict, the `recover.forward` and `recover.backward` spans of a step
# on a CUDA device also record CUDA events into it, {"forward": [(start,
# end), ...], "backward": [...]}, for a caller to read after a sync.
EVENTS = None


def make_state(params: dict, learning_rate: float):
    """(params as fresh leaf tensors, a new Adam over them)."""
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate,
                           betas=BETAS, eps=EPS)
    return params, opt


def agree(state, mesh) -> bool:
    """Makes every rank of the mesh hold the first rank's (params, Adam):
    compares a digest of the parameters and, where they differ, broadcasts
    the parameters and Adam's moments and step count.  Returns whether they
    had agreed already."""
    params, opt = state
    if pmesh.same_on_every_rank(params, mesh):
        return True
    with torch.no_grad():
        for k in sorted(params):
            pmesh.broadcast(params[k], mesh)
            st = opt.state[params[k]]
            for name in sorted(st):       # none before the first step
                st[name] = pmesh.broadcast(
                    st[name].to(params[k].device), mesh).to(st[name].device)
    return False


def make_recovery_step(scene: Scene, camera: Camera, config: RenderConfig,
                       mesh=None, params_subset: Iterable[str] = ("kd", "le"),
                       learning_rate: float = 0.05, max_point=None):
    """Returns (step_fn, init_state): `step_fn(state, key, target) ->
    (state, loss)` with state = (params, optimizer).  Only the fields in
    `params_subset` (material fields, and "radiance", the lights') are
    optimized; the rest stay at the scene's values.  After a step each
    parameter's `.grad` holds the gradient it took.  With `mesh`, each
    rank traces its shard and every rank returns the same state and
    loss."""
    full = pmesh.material_params(scene.materials, scene.lights)
    subset = tuple(params_subset)
    # The clamp's upper bound: 1 for the material fields but le; none for
    # le and for what is not a material field (the lights' radiance).
    bounded = {f.name for f in dataclasses.fields(Materials)} - {"le"}
    upper = {k: 1.0 if k in bounded else None for k in subset}

    @span("recover.step")
    def step_fn(state, key, target):
        params, opt = state
        prep = pmesh.prepared(scene, camera, config, key, target, max_point,
                              mesh)
        loss, grads = pmesh.loss_and_grads(dict(full, **params), scene,
                                           config, prep, subset, mesh,
                                           events=EVENTS)
        with span("recover.update"):
            opt.zero_grad(set_to_none=True)
            for k in subset:
                params[k].grad = grads[k]
            opt.step()
            with torch.no_grad():
                for k in subset:
                    params[k].clamp_(0.0, upper[k])
        if mesh is not None:
            agree((params, opt), mesh)
        return (params, opt), loss

    return step_fn, make_state({k: full[k] for k in subset}, learning_rate)


def recover_materials(scene: Scene, camera: Camera, config: RenderConfig,
                      target_image, mesh=None, steps: int = 200,
                      params_subset: Iterable[str] = ("kd",),
                      learning_rate: float = 0.05, base_key=None,
                      init_params: Optional[dict] = None,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 50, resume: bool = False,
                      max_point=None) -> Tuple[dict, np.ndarray]:
    """Runs the recovery loop; returns (recovered params, per-step losses).
    With `checkpoint_path` the state, step and losses are saved every
    `checkpoint_every` steps (over a mesh by its first rank, the others
    waiting at a barrier), and `resume=True` continues from that file."""
    from ..utils import checkpoint as ckpt

    step_fn, state = make_recovery_step(
        scene, camera, config, mesh, params_subset=params_subset,
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
            if mesh is None or pmesh._shard_index(mesh) == 0:
                ckpt.save_opt_state(checkpoint_path, state, s + 1, losses)
            if mesh is not None:
                pmesh.barrier(mesh)
    return {k: p.detach() for k, p in state[0].items()}, np.asarray(losses)
