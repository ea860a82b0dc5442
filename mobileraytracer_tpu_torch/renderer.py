"""Frame rendering (port of `mobileraytracer_tpu/renderer.py`, float32
accumulation).

All pixels of a sample trace as one wavefront batch in patch-major lane
order; samples accumulate in a Python loop.  The asynchronous Renderer
lifecycle and checkpoints are not ported yet (ROADMAP.md Queue 1,
item 12).
"""
from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from . import film, sampling
from .cameras import generate_rays
from .ops import block_traversal, grid
from .shaders.engine import trace_image_sample
from .types import Camera, RenderConfig, Scene, entry_device


def _pixel_order(config: RenderConfig, device=None):
    """Lane order: 4x4 image patches, patch-major, so consecutive lanes
    form coherent ray tiles.  Returns (u, v, pixel_ids, inverse
    permutation) with u = x / width, v = y / height."""
    w, h = config.width, config.height
    ph, pw = max(C.SUBTILE // 4, 1), 4
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    order = np.lexsort((xs.ravel() % pw, ys.ravel() % ph,
                        xs.ravel() // pw, ys.ravel() // ph))
    pids = (ys.ravel() * w + xs.ravel())[order].astype(np.int32)
    inv = np.empty_like(pids)
    inv[pids] = np.arange(w * h, dtype=np.int32)
    u = (pids % w).astype(np.float32) / w
    v = (pids // w).astype(np.float32) / h
    t = lambda a: torch.from_numpy(a).to(device)
    return t(u), t(v), t(pids), t(inv)


def sample_pixels(scene: Scene, camera: Camera, config: RenderConfig,
                  base_key: torch.Tensor, sample_idx: int, u, v, pixel_ids,
                  max_point=None, differentiable: bool = False):
    """Traces one sample of a pixel subset; returns (rgb (B, 3), rays).
    `max_point` is DepthMap's far point ((1, 1, 1) when None)."""
    if differentiable:
        raise NotImplementedError(
            "differentiable rendering is not ported yet (ROADMAP.md Queue 1,"
            " item 13)")
    w, h = config.width, config.height
    keys = sampling.ray_key(base_key, pixel_ids, sample_idx)
    if config.resolved_pixel_jitter():
        if config.pixel_sampler != "prng":
            raise NotImplementedError(
                f'pixel sampler "{config.pixel_sampler}" is not ported yet '
                "(ROADMAP.md Queue 1, item 12)")
        jkeys = sampling.event_key(keys, 0, sampling.PURPOSE_PIXEL_JITTER)
        r = sampling.uniform(jkeys, 2)
        # deviation = (r - 0.5) * 2 * (0.5 / size)  (Renderer.cpp:137-140)
        dev_u = (r[:, 0] - 0.5) * 2.0 * (0.5 / w)
        dev_v = (r[:, 1] - 0.5) * 2.0 * (0.5 / h)
    else:
        # spp <= 1: the Constant(0.5) sampler, zero deviation.
        dev_u = torch.zeros_like(u)
        dev_v = torch.zeros_like(v)
    o, d = generate_rays(camera, u, v, dev_u, dev_v)
    return trace_image_sample(scene, config, o, d, keys, max_point)


def render_sample(scene: Scene, camera: Camera, config: RenderConfig,
                  base_key: torch.Tensor, sample_idx: int, max_point=None,
                  differentiable: bool = False):
    """One sample of every pixel in lane order; returns (rgb, rays)."""
    u, v, pixel_ids, _ = _pixel_order(config, scene.device)
    return sample_pixels(scene, camera, config, base_key, sample_idx, u, v,
                         pixel_ids, max_point=max_point,
                         differentiable=differentiable)


def render_frame(scene: Scene, camera: Camera, config: RenderConfig,
                 base_key: torch.Tensor, max_point=None):
    """Full frame at `config.spp` samples, on the scene's device.  Returns
    {"image": (H, W, 3) f32, "bitmap": (H, W) int32 ABGR, "rays": () int32
    total casted rays}."""
    if config.accumulation != "float32":
        raise NotImplementedError(
            "int_parity accumulation is not ported yet (ROADMAP.md Queue 1,"
            " item 12)")
    w, h = config.width, config.height
    dev = scene.device
    camera = camera.to(dev)
    base_key = base_key.to(dev)
    _, _, _, inv = _pixel_order(config, dev)
    accum = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int32, device=dev)
    for s in range(config.spp):
        rgb, r = render_sample(scene, camera, config, base_key, s,
                               max_point)
        accum = film.incremental_avg_float(accum, rgb, s + 1)
        rays = rays + r
    image = accum[inv.long()]
    return {"image": image.reshape(h, w, 3),
            "bitmap": film.quantize_abgr(image).reshape(h, w),
            "rays": rays}


class Renderer:
    """Synchronous progressive renderer: renders sample by sample and
    exposes the running image, bitmap and casted-ray total.  It runs on
    the CUDA card unless `device` names another (see types.entry_device:
    without a card it raises); on the CPU the traversal runs the kernels'
    plain versions.  With ACC_BVH the block grid, and with
    ACC_REGULAR_GRID the cell grid, is built on construction.
    `max_point` is DepthMap's far point ((1, 1, 1) when None)."""

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 max_point=None, device=None):
        device = entry_device(device)
        if config.accelerator == C.ACC_BVH and scene.bvh is None:
            scene = block_traversal.build(scene, device=device)
        elif config.accelerator == C.ACC_REGULAR_GRID and scene.bvh is None:
            scene = grid.build_grid(scene, device=device)
        self.scene = scene.to(device)
        self.camera = camera.to(device)
        self.config = config.rounded()
        self.max_point = max_point
        self.sample = 0
        self.total_rays = 0
        w, h = self.config.width, self.config.height
        self._accum = torch.zeros((w * h, 3), dtype=torch.float32,
                                  device=device)
        _, _, _, inv = _pixel_order(self.config, device)
        self._inv = inv.long()
        self._key = sampling.prng_key(self.config.seed, device)

    @property
    def image(self) -> np.ndarray:
        w, h = self.config.width, self.config.height
        return self._accum[self._inv].reshape(h, w, 3).cpu().numpy()

    @property
    def bitmap(self) -> np.ndarray:
        w, h = self.config.width, self.config.height
        return film.quantize_abgr(
            self._accum[self._inv]).reshape(h, w).cpu().numpy()

    def render(self) -> np.ndarray:
        """Runs the remaining samples; returns the image."""
        while self.sample < self.config.spp:
            rgb, rays = render_sample(self.scene, self.camera, self.config,
                                      self._key, self.sample, self.max_point)
            self._accum = film.incremental_avg_float(self._accum, rgb,
                                                     self.sample + 1)
            self.sample += 1
            self.total_rays += int(rays)
        return self.image
