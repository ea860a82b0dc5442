"""The training step of differentiable rendering on one device (port of the
one-device half of `mobileraytracer_tpu/parallel/mesh.py`).

The JAX package shards pixel lanes over a device mesh and all-reduces the
gradients.  Here `group=None` is its one-device mesh
(`make_mesh(n_devices=1)`): the loss is the per-shard sum of squared
errors divided by the global w * h * 3, and the gradient is autograd's.
Pixels run in the renderer's patch-major lane order, with the target
permuted into it.  Any other group raises NotImplementedError naming
ROADMAP.md Queue 1, item 14 (the sharded forms and the all-reduce).
"""
from __future__ import annotations

import torch

from .. import film
from ..renderer import _pixel_order, sample_pixels
from ..types import Camera, Materials, RenderConfig, Scene


def check_group(group) -> None:
    """Only the one-device mesh is ported."""
    if group is not None:
        raise NotImplementedError(
            "sharded training (a process group) is not ported yet "
            "(ROADMAP.md Queue 1, item 14); pass group=None")


def material_params(mat: Materials) -> dict:
    """The differentiable (float) part of the material table."""
    return {"le": mat.le, "kd": mat.kd, "ks": mat.ks, "kt": mat.kt,
            "ior": mat.ior}


def _scene_with_params(scene: Scene, params: dict) -> Scene:
    return scene.replace(materials=scene.materials.replace(**params))


def _lane_order(config: RenderConfig, device=None):
    """The renderer's patch-major lane order: (u, v, pixel ids, inverse)."""
    return _pixel_order(config, device)


def render_loss_fn(params: dict, scene: Scene, camera: Camera,
                   config: RenderConfig, key, target, u, v, pids, max_point):
    """Sum of squared errors between the sample mean of `config.spp`
    differentiable samples and `target` (lanes in the order of `pids`);
    on autograd's tape of `params`, the material fields it replaces."""
    scene = _scene_with_params(scene, params)
    accum = torch.zeros((u.shape[0], 3), dtype=torch.float32,
                        device=u.device)
    for s in range(config.spp):
        rgb, _ = sample_pixels(scene, camera, config, key, s, u, v, pids,
                               max_point=max_point, differentiable=True)
        accum = film.incremental_avg_float(accum, rgb, s + 1)
    return torch.sum((accum - target) ** 2)


def prepared(scene: Scene, camera: Camera, config: RenderConfig, base_key,
             target_image, max_point=None):
    """The lane order, the target in it, the camera, key and far point on
    the scene's device, and the loss divisor w * h * 3."""
    dev = scene.device
    w, h = config.width, config.height
    u, v, pids, _ = _lane_order(config, dev)
    target = torch.as_tensor(target_image, dtype=torch.float32).to(dev)
    target = target.reshape(w * h, 3)[pids.long()]
    if max_point is None:
        max_point = torch.ones(3)
    max_point = torch.as_tensor(max_point, dtype=torch.float32).to(dev)
    return dict(camera=camera.to(dev), key=base_key.to(dev), target=target,
                u=u, v=v, pids=pids, max_point=max_point,
                denom=float(w * h * 3))


def loss_and_grads(params: dict, scene: Scene, config: RenderConfig,
                   prep: dict, wrt):
    """(loss / denom, {name: d(loss / denom) / d params[name]} for the names
    in `wrt`), the loss detached."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in wrt}
    merged = dict(params, **leaves)
    loss = render_loss_fn(merged, scene, prep["camera"], config, prep["key"],
                          prep["target"], prep["u"], prep["v"], prep["pids"],
                          prep["max_point"])
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    denom = prep["denom"]
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g) / denom
             for k, g in zip(leaves, grads)}
    return loss.detach() / denom, grads


def train_step_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                       base_key, target_image, group=None, max_point=None):
    """One step of differentiable rendering: the forward render, the
    backward pass and, on one device, no reduction.  Returns (loss, grads
    over the five material fields)."""
    check_group(group)
    prep = prepared(scene, camera, config, base_key, target_image, max_point)
    params = material_params(scene.materials)
    return loss_and_grads(params, scene, config, prep, tuple(params))
