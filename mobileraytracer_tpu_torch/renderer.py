"""Frame rendering and the progressive Renderer (port of
`mobileraytracer_tpu/renderer.py`).

All pixels of a sample trace as one wavefront batch in patch-major lane
order; samples accumulate in a Python loop, into a float32 film or, with
`accumulation="int_parity"`, into the reference's integer ABGR bitmap.
The Renderer keeps the reference's lifecycle (IDLE, BUSY, FINISHED,
STOPPED), renders synchronously or on a worker thread, and saves and
resumes its state as a checkpoint.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import constants as C
from . import film, samplers, sampling
from .cameras import generate_rays
from .ops import block_traversal, grid
from .shaders.engine import trace_image_sample
from .types import (Camera, RenderConfig, Scene, entry_device,
                    scene_num_primitives)

# Render lifecycle states (reference JNI_layer.hpp:12-14).
STATE_IDLE = "IDLE"
STATE_BUSY = "BUSY"
STATE_FINISHED = "FINISHED"
STATE_STOPPED = "STOPPED"


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
    `max_point` is DepthMap's far point ((1, 1, 1) when None).  With
    `differentiable` the radiance is on the autograd tape of the scene's
    tensors (the differentiable walk, shaders/engine.py)."""
    w, h = config.width, config.height
    keys = sampling.ray_key(base_key, pixel_ids, sample_idx)
    if config.resolved_pixel_jitter():
        if config.pixel_sampler in ("prng", "halton"):
            jkeys = sampling.event_key(keys, 0, sampling.PURPOSE_PIXEL_JITTER)
            r = sampling.uniform(jkeys, 2)
            if config.pixel_sampler == "halton":
                # (2, 3)-Halton over the sample index, rotated per pixel by
                # the prng draw (Cranley-Patterson).
                s = torch.full_like(pixel_ids, sample_idx)
                r = torch.stack(
                    [torch.remainder(sampling.halton(s, 2) + r[:, 0], 1.0),
                     torch.remainder(sampling.halton(s, 3) + r[:, 1], 1.0)],
                    -1)
        else:
            # One of the reference's eight samplers (samplers.py).
            r = samplers.pixel_jitter(config.pixel_sampler, base_key,
                                      pixel_ids, sample_idx, w * h)
        # deviation = (r - 0.5) * 2 * (0.5 / size)  (Renderer.cpp:137-140)
        dev_u = (r[:, 0] - 0.5) * 2.0 * (0.5 / w)
        dev_v = (r[:, 1] - 0.5) * 2.0 * (0.5 / h)
    else:
        # spp <= 1: the Constant(0.5) sampler, zero deviation.
        dev_u = torch.zeros_like(u)
        dev_v = torch.zeros_like(v)
    o, d = generate_rays(camera, u, v, dev_u, dev_v)
    return trace_image_sample(scene, config, o, d, keys, max_point,
                              differentiable=differentiable)


def render_sample(scene: Scene, camera: Camera, config: RenderConfig,
                  base_key: torch.Tensor, sample_idx: int, max_point=None,
                  differentiable: bool = False):
    """One sample of every pixel in lane order; returns (rgb, rays)."""
    u, v, pixel_ids, _ = _pixel_order(config, scene.device)
    return sample_pixels(scene, camera, config, base_key, sample_idx, u, v,
                         pixel_ids, max_point=max_point,
                         differentiable=differentiable)


def accumulate_samples(scene: Scene, camera: Camera, config: RenderConfig,
                       base_key: torch.Tensor, u, v, pixel_ids,
                       max_point=None):
    """The `config.spp` samples of the lanes (u, v, pixel_ids) averaged into
    a film: (float32 (B, 3) film, or with `accumulation="int_parity"` the
    reference's int32 ABGR bitmap (B,); casted rays, () int32)."""
    b = u.shape[0]
    if config.accumulation == "int_parity":
        accum = torch.zeros((b,), dtype=torch.int32, device=u.device)
        avg = film.incremental_avg_int
    else:
        accum = torch.zeros((b, 3), dtype=torch.float32, device=u.device)
        avg = film.incremental_avg_float
    rays = torch.zeros((), dtype=torch.int32, device=u.device)
    for s in range(config.spp):
        rgb, r = sample_pixels(scene, camera, config, base_key, s, u, v,
                               pixel_ids, max_point=max_point)
        accum = avg(accum, rgb, s + 1)
        rays = rays + r
    return accum, rays


def finish_frame(accum: torch.Tensor, rays: torch.Tensor, inv: torch.Tensor,
                 config: RenderConfig) -> dict:
    """render_frame's dict from the whole film in lane order."""
    w, h = config.width, config.height
    if config.accumulation == "int_parity":
        bitmap = accum[inv.long()]
        image = film.unpack_abgr(bitmap)
    else:
        image = accum[inv.long()]
        bitmap = film.quantize_abgr(image)
    return {"image": image.reshape(h, w, 3),
            "bitmap": bitmap.reshape(h, w),
            "rays": rays}


def render_frame(scene: Scene, camera: Camera, config: RenderConfig,
                 base_key: torch.Tensor, max_point=None):
    """Full frame at `config.spp` samples, on the scene's device.  Returns
    {"image": (H, W, 3) f32, "bitmap": (H, W) int32 ABGR, "rays": () int32
    total casted rays}.  With `accumulation="int_parity"` the samples
    average into the reference's integer bitmap and the image is that
    bitmap unpacked."""
    dev = scene.device
    u, v, pids, inv = _pixel_order(config, dev)
    accum, rays = accumulate_samples(scene, camera.to(dev), config,
                                     base_key.to(dev), u, v, pids, max_point)
    return finish_frame(accum, rays, inv, config)


# The JAX package's dispatch cost and budget, copied as they are: they
# decide which frames render in chunks and where the chunks split, and a
# PathTracer frame depends on its batch (the walker's compaction chunks and
# NEE groups follow it), so they decide what such a frame is.  Units are
# pixel-samples weighted by shader and accelerator.
DISPATCH_UNIT_BUDGET = 4.0e6

_SHADER_COST = {C.SHADER_NOSHADOWS: 1.0, C.SHADER_WHITTED: 2.0,
                C.SHADER_PATHTRACER: 20.0, C.SHADER_DEPTHMAP: 0.5,
                C.SHADER_DIFFUSE: 0.5}


def _dispatch_cost(config: RenderConfig) -> float:
    acc_w = 500.0 if config.accelerator == C.ACC_REGULAR_GRID else 1.0
    return (float(config.width * config.height) * config.spp
            * _SHADER_COST.get(config.shader, 2.0)
            * max(config.samples_light, 1) * acc_w)


def _chunk_geometry(config: RenderConfig, budget: float):
    """(n_chunks, chunk) of a frame over `budget`: one sample's lanes cut
    into n_chunks contiguous patch-major ranges of `chunk` lanes, a
    multiple of the 128-ray tile that divides the whole tiles exactly."""
    per_sample = _dispatch_cost(config) / config.spp
    n_chunks = max(1, int(-(-per_sample // budget)))
    unit = C.SUBTILE * max(1, 128 // C.SUBTILE)
    n_units = config.width * config.height // unit
    per = max(1, n_units // n_chunks)
    while n_units % per:
        per -= 1
    return n_units // per, per * unit


def render_frame_auto(scene: Scene, camera: Camera, config: RenderConfig,
                      base_key: torch.Tensor, max_point=None,
                      budget: float = DISPATCH_UNIT_BUDGET):
    """`render_frame` of `config.rounded()`, in lane chunks when the
    frame's dispatch cost exceeds `budget`; returns the same dict.  Each
    chunk's lanes trace as one batch per sample, as the JAX package's
    render_frame_auto traces them.  The lanes past the last whole chunk
    (w·h not a multiple of 128) render as one shorter chunk, which the
    JAX package never renders.  Chunks run one after another with all
    their samples: each lane sees its samples in order, so the film is
    the one a sample-major loop gives."""
    config = config.rounded()
    if _dispatch_cost(config) <= budget:
        return render_frame(scene, camera, config, base_key, max_point)
    dev = scene.device
    camera, base_key = camera.to(dev), base_key.to(dev)
    u, v, pids, inv = _pixel_order(config, dev)
    n_chunks, chunk = _chunk_geometry(config, budget)
    cuts = [i * chunk for i in range(n_chunks + 1)]
    if cuts[-1] < u.shape[0]:
        cuts.append(u.shape[0])
    films, rays = [], 0
    for lo, hi in zip(cuts, cuts[1:]):
        film_c, r = accumulate_samples(scene, camera, config, base_key,
                                       u[lo:hi], v[lo:hi], pids[lo:hi],
                                       max_point)
        films.append(film_c)
        rays = rays + r
    return finish_frame(torch.cat(films), rays, inv, config)


class Renderer:
    """Progressive renderer, the reference's render loop and lifecycle
    (C_wrapper.cpp RayTrace and the JNI layer): renders sample by
    sample into a float32 film, exposes the running image, bitmap, sample
    index and casted-ray total, and stops cooperatively between samples.
    It runs on the CUDA card unless `device` names another (see
    types.entry_device: without a card it raises); on the CPU the
    traversal runs the kernels' plain versions.  With ACC_BVH the block
    grid, and with ACC_REGULAR_GRID the cell grid, is built on
    construction.  `max_point` is DepthMap's far point ((1, 1, 1) when
    None)."""

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 max_point=None, device=None):
        device = entry_device(device)
        if config.accelerator == C.ACC_BVH and scene.bvh is None:
            scene = block_traversal.build(scene, device=device)
        elif config.accelerator == C.ACC_REGULAR_GRID and scene.bvh is None:
            scene = grid.build_grid(scene, device=device)
        self.device = device
        self.scene = scene.to(device)
        self.camera = camera.to(device)
        self.config = config.rounded()
        self.max_point = max_point
        self._key = sampling.prng_key(self.config.seed, device)
        _, _, _, inv = _pixel_order(self.config, device)
        self._inv = inv.long()
        self._thread = None
        self._error = None
        self.render_seconds = 0.0
        self.reset()

    def reset(self):
        self._stop = False
        self.sample = 0
        self.total_rays = 0
        self.state = STATE_IDLE
        self.fps = 0.0
        w, h = self.config.width, self.config.height
        self._accum = torch.zeros((w * h, 3), dtype=torch.float32,
                                  device=self.device)

    def stop_render(self):
        """Cooperative cancel (reference Renderer.cpp:93-99): the running
        render, synchronous or on the worker thread, schedules no further
        sample.  Safe to call from any thread."""
        self._stop = True

    @property
    def image(self) -> np.ndarray:
        w, h = self.config.width, self.config.height
        return self._accum[self._inv].reshape(h, w, 3).cpu().numpy()

    @property
    def bitmap(self) -> np.ndarray:
        w, h = self.config.width, self.config.height
        return film.quantize_abgr(
            self._accum[self._inv]).reshape(h, w).cpu().numpy()

    def render(self, callback: Optional[Callable] = None) -> np.ndarray:
        """Runs the remaining samples up to config.spp, unless stopped;
        `callback(renderer)` runs after each sample (the progressive
        display hook).  Returns the image."""
        t0 = time.perf_counter()
        self.state = STATE_BUSY
        while self.sample < self.config.spp and not self._stop:
            ts = time.perf_counter()
            rgb, rays = render_sample(self.scene, self.camera, self.config,
                                      self._key, self.sample, self.max_point)
            accum = film.incremental_avg_float(self._accum, rgb,
                                               self.sample + 1)
            rays = int(rays)     # waits for the sample, accum included
            # One reference swap: a poller sees a whole frame at some
            # sample count.
            self._accum = accum
            self.sample += 1
            self.total_rays += rays
            self.fps = 1.0 / max(time.perf_counter() - ts, 1e-9)
            if callback is not None:
                callback(self)
        self.render_seconds = time.perf_counter() - t0
        self.state = STATE_STOPPED if self._stop else STATE_FINISHED
        return self.image

    def render_async(self, callback: Optional[Callable] = None):
        """Renders on a worker thread, as the reference's
        RayTrace(config, async=true) (C_wrapper.cpp:283-290), and returns
        the thread at once.  The state is BUSY before this returns; while
        it lasts `sample`, `fps`, `image`, `bitmap` and `stats_line()` give
        live values.  The worker uses this thread's CUDA stream on the
        Renderer's device, so a poller's reads queue behind each finished
        sample.  `stop_render()` cancels; `wait()` joins."""
        if self.state == STATE_BUSY:
            raise RuntimeError("render already in progress")
        self.state = STATE_BUSY
        self._error = None
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def run():
            try:
                if stream is None:
                    self.render(callback)
                else:
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(stream):
                        self.render(callback)
            except Exception as e:   # re-raised by wait()
                self._error = e
                self.state = STATE_STOPPED

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self._thread

    def wait(self, timeout: Optional[float] = None) -> str:
        """Joins a render_async worker; returns the state.  Raises what the
        worker raised."""
        if self._thread is not None:
            self._thread.join(timeout)
        if self._error is not None:
            raise self._error
        return self.state

    def preview(self) -> np.ndarray:
        """One DiffuseMaterial sample of every pixel (flat Kd), the
        reference UI's quick preview."""
        cfg = dataclasses.replace(self.config, shader=C.SHADER_DIFFUSE,
                                  spp=1)
        out = render_frame(self.scene, self.camera, cfg, self._key,
                           self.max_point)
        return out["image"].cpu().numpy()

    def stats_line(self) -> str:
        """The live stats line of the reference UI (RenderTask.kt:169-260)."""
        prims = scene_num_primitives(self.scene)
        n_prims = prims["triangles"] + prims["spheres"] + prims["planes"]
        return (f"fps:{self.fps:.1f} r:{self.config.width}x"
                f"{self.config.height} spp:{self.config.spp} "
                f"sample:{self.sample} state:{self.state} "
                f"p:{n_prims} l:{prims['lights']}")

    def save_checkpoint(self, path: str) -> None:
        """The render state as the JAX package's .npz (utils/checkpoint)."""
        from .utils.checkpoint import save_render_state
        save_render_state(path, self._accum, self.sample, self.total_rays,
                          self.config)

    def load_checkpoint(self, path: str) -> None:
        """Resumes a render state saved by either package; its config must
        equal this renderer's."""
        from .utils.checkpoint import load_render_state
        accum, sample, rays, config, _ = load_render_state(path)
        if config != self.config:
            raise ValueError("checkpoint config does not match renderer "
                             f"config: {config} vs {self.config}")
        self._accum = torch.from_numpy(accum).to(self.device)
        self.sample = sample
        self.total_rays = rays
        self._stop = False
        self.state = STATE_IDLE
