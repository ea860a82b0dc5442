"""Meshes over torch.distributed, the sharded frame and the training step of
differentiable rendering (port of `mobileraytracer_tpu/parallel/mesh.py`).

A JAX mesh axis becomes one process (rank) per device, and a mesh a
`torch.distributed.device_mesh.DeviceMesh` with the same axis names
("rays", or ("hosts", "rays")).  Every rank holds the whole scene and
traces a contiguous range of the renderer's patch-major lanes, so every
128-ray tile and every `nee_share` group stays within one shard and the
per-(pixel, sample) keys do not change: the sharded frame is the
one-device frame.  Where JAX's shard_map sums with `psum`, the ranks
`all_reduce(SUM)`; where it returns a sharded output, they `all_gather`
their lane ranges, so every rank returns what JAX's single controller
returns.  Over a 2-D mesh the collectives run axis by axis, "rays" first.

The device type defaults to "cuda" and the backend of `distributed_init`
to "nccl"; ranks that share one card need `backend="gloo"`, and the CPU
tests ask for "cpu" and "gloo".  Nothing here switches backend or device
by itself.  `mesh=None` is the one-device form: no collective runs.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import film
from ..renderer import (_pixel_order, accumulate_samples, finish_frame,
                        sample_pixels)
from ..types import (Camera, Lights, Materials, RenderConfig, Scene,
                     TensorData)
from ..utils.metrics import span

RAY_AXIS = "rays"
HOST_AXIS = "hosts"


# ---------------------------------------------------------------------------
# Process groups and meshes.
# ---------------------------------------------------------------------------

def distributed_init(coordinator_address: str, num_processes: int,
                     process_id: int, backend: str = "nccl",
                     **kwargs) -> None:
    """Joins this process to the job as rank `process_id` of
    `num_processes` (JAX's signature): `dist.init_process_group` with the
    init method `tcp://coordinator_address`, or the address itself when it
    names a scheme (`file://...`).  Under torchrun pass its MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE and RANK.  `kwargs` go to init_process_group
    (`timeout=`)."""
    method = (coordinator_address if "://" in coordinator_address
              else f"tcp://{coordinator_address}")
    dist.init_process_group(backend=backend, init_method=method,
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: `cuda:{local rank % device count}` (the local
    rank is torchrun's LOCAL_RANK, else the global rank), so every rank of
    a one-card machine shares cuda:0; or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _device_mesh(device_type: str, ranks, names):
    from torch.distributed.device_mesh import DeviceMesh
    if device_type == "cuda":
        # Before the mesh: DeviceMesh would otherwise pick LOCAL_RANK
        # itself, which names no card when ranks share one.
        torch.cuda.set_device(rank_device(device_type))
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def _ranks(devices):
    """The ordered global ranks a mesh spans: `devices` (ranks, JAX's
    device list), or every rank of the job."""
    if devices is None:
        return list(range(dist.get_world_size()))
    return [int(r) for r in devices]


def make_mesh(n_devices: Optional[int] = None, devices=None,
              device_type: str = "cuda"):
    """1-D mesh named ("rays",) over `devices`, the ordered list of global
    ranks it spans (every rank by default), cut to its first `n_devices`.
    Shard i goes to the i-th rank of the list.  Every rank of the job
    calls it; a rank outside the mesh gets a mesh whose `get_coordinate()`
    is None and takes no part in its collectives."""
    ranks = _ranks(devices)
    if n_devices is not None:
        ranks = ranks[:n_devices]
    return _device_mesh(device_type, ranks, (RAY_AXIS,))


def make_mesh_2d(n_hosts: Optional[int] = None, devices=None,
                 device_type: str = "cuda"):
    """2-D (hosts, rays) mesh over `devices` (ordered global ranks, every
    rank by default): one row per host, its ranks along "rays".  `n_hosts`
    defaults to WORLD_SIZE // LOCAL_WORLD_SIZE, which torchrun sets;
    without torchrun pass it."""
    ranks = _ranks(devices)
    if n_hosts is None:
        if "LOCAL_WORLD_SIZE" not in os.environ:
            raise ValueError("make_mesh_2d: pass n_hosts (LOCAL_WORLD_SIZE "
                             "is unset, as torchrun did not start this job)")
        n_hosts = dist.get_world_size() // int(os.environ["LOCAL_WORLD_SIZE"])
    per_host = len(ranks) // n_hosts
    grid = np.asarray(ranks[:n_hosts * per_host]).reshape(n_hosts, per_host)
    return _device_mesh(device_type, grid.tolist(), (HOST_AXIS, RAY_AXIS))


def _shard_index(mesh) -> int:
    """This rank's row-major position over every mesh axis (the order of
    JAX's P(("hosts", "rays")))."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return int(np.ravel_multi_index(tuple(coord), tuple(mesh.mesh.shape)))


def _lane_slice(b: int, mesh) -> slice:
    """Shard i's patch-major lanes [i b / n, (i + 1) b / n)."""
    n = mesh.size()
    if b % n:
        raise ValueError(f"{b} lanes are not divisible by {n} devices")
    i = _shard_index(mesh)
    return slice(i * (b // n), (i + 1) * (b // n))


def _axis_groups(mesh):
    return [mesh.get_group(d) for d in reversed(range(mesh.ndim))]


def all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over every rank of the mesh, in place (and returned)."""
    for g in _axis_groups(mesh):
        dist.all_reduce(x, group=g)
    return x


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in shard order: along each
    axis in the order of the mesh's coordinates, which need not be the
    order of the axis group's ranks (make_mesh(devices=))."""
    x = x.contiguous()
    for d in reversed(range(mesh.ndim)):
        g = mesh.get_group(d)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, x, group=g)
        line = list(mesh.get_coordinate())
        line[d] = slice(None)
        x = torch.cat([parts[dist.get_group_rank(g, int(r))]
                       for r in mesh.mesh[tuple(line)].tolist()])
    return x


def broadcast(x: torch.Tensor, mesh) -> torch.Tensor:
    """x of the mesh's first rank (coordinate 0 on every axis) on every
    rank, in place: axis by axis, from the rank at 0 on that axis."""
    coord = list(mesh.get_coordinate())
    for d in range(mesh.ndim):
        src = list(coord)
        src[d] = 0
        dist.broadcast(x, src=int(mesh.mesh[tuple(src)]),
                       group=mesh.get_group(d))
    return x


def barrier(mesh) -> None:
    for g in _axis_groups(mesh):
        dist.barrier(group=g)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, TensorData):
        yield from obj.tensors()
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _tensors(obj[k])


def digest(obj) -> torch.Tensor:
    """Two int64 sums over the bits of every tensor in obj (a tensor, a
    tensor dataclass or a dict of them), plain and position-weighted:
    equal on two ranks when their tensors are (and almost surely only
    then)."""
    words = []
    for t in _tensors(obj):
        t = t.detach().reshape(-1)
        size = t.element_size()
        words.append(t.view({4: torch.int32, 8: torch.int64}[size])
                     .to(torch.int64) if size in (4, 8)
                     else t.to(torch.int64))
    bits = torch.cat(words)
    pos = torch.arange(1, bits.numel() + 1, device=bits.device) % 1000003
    return torch.stack([bits.sum(), (bits * pos).sum()])


def same_on_every_rank(obj, mesh) -> bool:
    """Whether every rank of the mesh holds bitwise the same obj (an
    all_gather of its digest)."""
    d = all_gather(digest(obj), mesh).reshape(-1, 2)
    return bool((d == d[0]).all())


def check_replicated(scene: Scene, mesh) -> None:
    """Raises unless every rank holds the same scene, block grid included:
    the sharded forms take it as replicated, as JAX's P() does."""
    if not same_on_every_rank(scene, mesh):
        raise RuntimeError("the ranks of the mesh hold different scenes")


# ---------------------------------------------------------------------------
# The sharded frame.
# ---------------------------------------------------------------------------

def render_frame_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                         base_key, mesh, max_point=None) -> dict:
    """renderer.render_frame with the pixels sharded over `mesh` and the
    scene replicated; every rank of the mesh calls it and gets the whole
    frame.  Equal to the one-device frame bit for bit when every shard
    holds a multiple of `nee_share` lanes and secondary NEE sharing is off
    or the frame has no secondary NEE (PathTracer frames chunk the walk by
    the shard's batch).  w * h must be a multiple of the mesh size."""
    dev = scene.device
    u, v, pids, inv = _pixel_order(config, dev)
    sl = _lane_slice(u.shape[0], mesh)
    accum, rays = accumulate_samples(scene, camera.to(dev), config,
                                     base_key.to(dev), u[sl], v[sl], pids[sl],
                                     max_point)
    # Ray counts are per shard; every rank returns the total.
    rays = all_reduce(rays, mesh)
    return finish_frame(all_gather(accum, mesh), rays, inv, config)


# ---------------------------------------------------------------------------
# Differentiable rendering and the gradient all-reduce: the training step.
# ---------------------------------------------------------------------------

def material_params(mat: Materials, lights: Optional[Lights] = None) -> dict:
    """The differentiable (float) part of the material table; with
    `lights`, also their radiance (L, 3) under "radiance", which NEE and
    light hits read (the JAX package recovers the material fields
    alone)."""
    out = {"le": mat.le, "kd": mat.kd, "ks": mat.ks, "kt": mat.kt,
           "ior": mat.ior}
    if lights is not None:
        out["radiance"] = lights.radiance
    return out


def _scene_with_params(scene: Scene, params: dict) -> Scene:
    mats = dict(params)
    radiance = mats.pop("radiance", None)
    scene = scene.replace(materials=scene.materials.replace(**mats))
    if radiance is not None:
        scene = scene.replace(lights=scene.lights.replace(radiance=radiance))
    return scene


def render_loss_fn(params: dict, scene: Scene, camera: Camera,
                   config: RenderConfig, key, target, u, v, pids, max_point):
    """Sum of squared errors between the sample mean of `config.spp`
    differentiable samples and `target` (lanes in the order of `pids`);
    on autograd's tape of `params`, the material fields (and the lights'
    "radiance") it replaces."""
    scene = _scene_with_params(scene, params)
    accum = torch.zeros((u.shape[0], 3), dtype=torch.float32,
                        device=u.device)
    for s in range(config.spp):
        rgb, _ = sample_pixels(scene, camera, config, key, s, u, v, pids,
                               max_point=max_point, differentiable=True)
        accum = film.incremental_avg_float(accum, rgb, s + 1)
    return torch.sum((accum - target) ** 2)


def prepared(scene: Scene, camera: Camera, config: RenderConfig, base_key,
             target_image, max_point=None, mesh=None):
    """This shard's lanes (all of them without a mesh) in the lane order,
    the target in it, the camera, key and far point on the scene's device,
    and the loss divisor w * h * 3."""
    dev = scene.device
    w, h = config.width, config.height
    u, v, pids, _ = _pixel_order(config, dev)
    target = torch.as_tensor(target_image, dtype=torch.float32).to(dev)
    target = target.reshape(w * h, 3)[pids.long()]
    if mesh is not None:
        sl = _lane_slice(w * h, mesh)
        u, v, pids, target = u[sl], v[sl], pids[sl], target[sl]
    if max_point is None:
        max_point = torch.ones(3)
    max_point = torch.as_tensor(max_point, dtype=torch.float32).to(dev)
    return dict(camera=camera.to(dev), key=base_key.to(dev), target=target,
                u=u, v=v, pids=pids, max_point=max_point,
                denom=float(w * h * 3))


def reduce_sums(sums: dict, mesh) -> dict:
    """The tensors of `sums` summed over the mesh, in one all_reduce."""
    flat = torch.cat([sums[k].reshape(-1) for k in sums])
    all_reduce(flat, mesh)
    out, at = {}, 0
    for k, t in sums.items():
        out[k] = flat[at:at + t.numel()].reshape(t.shape)
        at += t.numel()
    return out


def loss_and_grads(params: dict, scene: Scene, config: RenderConfig,
                   prep: dict, wrt, mesh=None, events: Optional[dict] = None):
    """(loss / denom, {name: d(loss / denom) / d params[name]} for the names
    in `wrt`), the loss detached.  With `mesh`, `prep` holds this shard's
    lanes and the shards' sums are all-reduced before the division, as
    JAX's psum is.  The forward render and autograd's backward run in the
    spans `recover.forward` and `recover.backward`, which on a CUDA device
    also record CUDA events into `events` (a dict) where one is given."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in wrt}
    merged = dict(params, **leaves)
    dev = prep["u"].device
    with span("recover.forward", events=events, device=dev):
        loss = render_loss_fn(merged, scene, prep["camera"], config,
                              prep["key"], prep["target"], prep["u"],
                              prep["v"], prep["pids"], prep["max_point"])
    with span("recover.backward", events=events, device=dev):
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    sums = {k: torch.zeros_like(leaves[k]) if g is None else g
            for k, g in zip(leaves, grads)}
    loss = loss.detach()
    if mesh is not None:
        sums = reduce_sums(dict(sums, _loss=loss), mesh)
        loss = sums.pop("_loss")
    denom = prep["denom"]
    return loss / denom, {k: g / denom for k, g in sums.items()}


def train_step_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                       base_key, target_image, mesh=None, max_point=None):
    """One step of differentiable rendering: the forward render and the
    backward pass over this rank's lanes, then the all-reduce of the loss
    and the gradients over `mesh` (none with mesh=None, one device).
    Returns (loss, grads over the five material fields) on every rank."""
    prep = prepared(scene, camera, config, base_key, target_image, max_point,
                    mesh)
    params = material_params(scene.materials)
    return loss_and_grads(params, scene, config, prep, tuple(params), mesh)
