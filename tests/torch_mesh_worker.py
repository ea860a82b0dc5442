"""One rank of a torch.distributed job that runs the PyTorch port's sharded
forms (parallel/mesh.py, parallel/recover.py, diff/geom.py with mesh=) and
saves what each returned on this rank, for tests/test_torch_mesh.py and
tests/test_torch_cuda.py to read:

    python tests/torch_mesh_worker.py WORLD RANK STORE OUT [DEVICE [CASES]]

STORE is the file of the job's `file://` rendezvous, OUT a directory
(rank r writes OUT/rank{r}.pt), DEVICE "cpu" (backend gloo, the default)
or "cuda" (gloo too: the ranks may share one card), CASES a comma list of
the names in CASES (all by default).  Imports torch and the port only,
never jax, as multihost_worker.py imports only the JAX package.  The
inputs (scenes, configs, targets, keys) are built here, so a test computes
the one-device results from the same functions.
"""
import datetime
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import sampling, scenes
from mobileraytracer_tpu_torch.builder import SceneBuilder
from mobileraytracer_tpu_torch.diff import geom
from mobileraytracer_tpu_torch.ops import block_traversal as bt
from mobileraytracer_tpu_torch.ops import kernels
from mobileraytracer_tpu_torch.parallel import mesh as pmesh
from mobileraytracer_tpu_torch.parallel import recover
from mobileraytracer_tpu_torch.types import RenderConfig, perspective_camera

LE0 = (1.5, 1.0, 0.5)
FRAME_KW = dict(width=32, height=32, spp=2, shader=C.SHADER_WHITTED,
                accelerator=C.ACC_BVH, scene_id=C.SCENE_CORNELL2)
PARITY_KW = dict(width=32, height=32, spp=3, shader=C.SHADER_WHITTED,
                 accelerator=C.ACC_NAIVE, accumulation="int_parity")
TRAIN_KW = dict(width=16, height=16, spp=1, shader=C.SHADER_WHITTED,
                accelerator=C.ACC_NAIVE, scene_id=C.SCENE_CORNELL2)
TRI_KW = dict(width=16, height=16, spp=1, shader=C.SHADER_DIFFUSE,
              accelerator=C.ACC_NAIVE)
TRI_VKW = dict(edge_samples=8, edge_eps=5e-4)
CHUNK_VKW = dict(edge_samples=8, shadow_edges=True, shadow_budget=32,
                 pixel_chunk=128)
RECOVER_KW = dict(steps=3, params_subset=("kd",), learning_rate=0.05,
                  checkpoint_every=2)
KD = (0.6, 0.3, 0.9)
TRI = ((-0.4, -0.3, 0.0), (0.5, -0.2, 0.0), (0.0, 0.45, 0.0))


def frame_scene(device="cpu"):
    s, c = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    return bt.build(s, device=device), c


def parity_scene(device="cpu"):
    s, c = scenes.load_builtin(C.SCENE_CORNELL, 1.0)
    return s.to(device), c


def train_scene(device="cpu"):
    """cornell2 with material 0 emissive, so that le has a gradient."""
    s, c = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    le = s.materials.le.clone()
    le[0] = torch.tensor(LE0)
    return s.replace(materials=s.materials.replace(le=le)).to(device), c


def train_target():
    return np.random.default_rng(0).uniform(
        0.0, 1.0, (TRAIN_KW["height"], TRAIN_KW["width"], 3)).astype(
            np.float32)


def triangle_scene(device="cpu"):
    b = SceneBuilder()
    b.add_triangle(*TRI, b.add_material(kd=KD))
    cam = perspective_camera((0, 0, -3.0), (0, 0, 1), (0, 1, 0), 45.0, 45.0)
    return b.build().to(device), cam


def chunk_kw(scene):
    return dict(CHUNK_VKW, edge_keep=geom.edge_topology(scene.triangles))


def recover_kw(scene, path, resume=False):
    kd0 = torch.full_like(scene.materials.kd, 0.5)
    return dict(RECOVER_KW, base_key=sampling.prng_key(5, scene.device),
                init_params={"kd": kd0}, checkpoint_path=str(path),
                resume=resume)


def _frame(mesh, device):
    s, c = frame_scene(device)
    pmesh.check_replicated(s, mesh)
    return pmesh.render_frame_sharded(s, c, RenderConfig(**FRAME_KW),
                                      sampling.prng_key(0, device), mesh)


def case_frame(m, device):
    """The 1-D frame, with the tile-MT and banded launches of this rank
    (none on the CPU, where the plain versions run)."""
    kernels.reset_launches()
    out = _frame(m["rays"], device)
    return dict(out, launches=torch.tensor(
        [kernels.LAUNCHES["tilemt"], kernels.LAUNCHES["banded"]]))


def case_parity(m, device):
    s, c = parity_scene(device)
    return pmesh.render_frame_sharded(s, c, RenderConfig(**PARITY_KW),
                                      sampling.prng_key(0, device), m["rays"])


def case_subset(m, device):
    if m["subset"].get_coordinate() is None:
        return {"outside": torch.tensor(True)}
    return _frame(m["subset"], device)


def case_mesh2d(m, device):
    return _frame(m["2d"], device)


def case_devices(m, device):
    """The 1-D frame on make_mesh(devices=) over the ranks in reverse
    order (2-rank job only): rank 1 takes shard 0."""
    if torch.distributed.get_world_size() != 2:
        return {}
    mesh = m["reversed"]
    return dict(_frame(mesh, device),
                shard=torch.tensor(pmesh._shard_index(mesh)))


def case_train(m, device):
    s, c = train_scene(device)
    loss, grads = pmesh.train_step_sharded(
        s, c, RenderConfig(**TRAIN_KW), sampling.prng_key(1, device),
        torch.from_numpy(train_target()), mesh=m["rays"])
    return dict(grads, loss=loss)


def case_recover(m, device, out):
    s, c = train_scene(device)
    cfg = RenderConfig(**TRAIN_KW)
    target = torch.from_numpy(train_target())
    ck = out / "recover.npz"
    p3, losses = recover.recover_materials(s, c, cfg, target, m["rays"],
                                           **recover_kw(s, ck))
    p3r, losses_r = recover.recover_materials(s, c, cfg, target, m["rays"],
                                              **recover_kw(s, ck, True))
    # A state that differs on one rank is repaired from the first rank's.
    state = recover.make_state(p3, 0.05)
    if pmesh._shard_index(m["rays"]) == 1:
        with torch.no_grad():
            state[0]["kd"].add_(1.0)
    agreed = recover.agree(state, m["rays"])
    return dict(kd=p3["kd"], losses=torch.from_numpy(losses),
                kd_resumed=p3r["kd"], losses_resumed=torch.from_numpy(losses_r),
                agreed_before=torch.tensor(agreed),
                kd_repaired=state[0]["kd"].detach())


def case_vgrad_tri(m, device):
    s, c = triangle_scene(device)
    loss, g = geom.vertex_grad(s, c, RenderConfig(**TRI_KW),
                               sampling.prng_key(3, device), mesh=m["rays"],
                               **TRI_VKW)
    return dict(g, loss=loss)


def case_vgrad_chunk(m, device):
    s, c = train_scene(device)
    loss, g = geom.vertex_grad(s, c, RenderConfig(**TRAIN_KW),
                               sampling.prng_key(3, device), mesh=m["rays"],
                               **chunk_kw(s))
    return dict(g, loss=loss)


CASES = {"frame": case_frame, "parity": case_parity, "subset": case_subset,
         "mesh2d": case_mesh2d, "devices": case_devices, "train": case_train,
         "recover": case_recover, "vgrad_tri": case_vgrad_tri,
         "vgrad_chunk": case_vgrad_chunk}


def main(world, rank, store, out, device="cpu", cases=None):
    torch.set_num_threads(1)
    out = pathlib.Path(out)
    pmesh.distributed_init(f"file://{store}", world, rank, backend="gloo",
                           timeout=datetime.timedelta(seconds=300))
    dev = pmesh.rank_device(device)
    meshes = {"rays": pmesh.make_mesh(device_type=device),
              "subset": pmesh.make_mesh(n_devices=2, device_type=device),
              "2d": pmesh.make_mesh_2d(n_hosts=2, device_type=device),
              "reversed": pmesh.make_mesh(
                  devices=list(reversed(range(world))), device_type=device)}
    results = {}
    for name in (cases or list(CASES)):
        args = (meshes, dev) + ((out,) if name == "recover" else ())
        res = CASES[name](*args)
        results[name] = {k: v.detach().cpu() for k, v in res.items()}
    torch.save(results, out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def start(world, out, device="cpu", cases=None):
    """Starts a job of `world` ranks, each a process running this file
    with its output in out/log{rank}.txt.  Returns the processes."""
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for r in range(world):
        with open(out / f"log{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(here / "torch_mesh_worker.py"),
                 str(world), str(r), str(out / "store"), str(out), device]
                + ([",".join(cases)] if cases else []), env=env,
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def finish(procs, out, timeout_s):
    """Waits for the job of `start`; fails with the log of a rank that
    failed.  Returns each rank's saved results."""
    deadline = time.monotonic() + timeout_s
    try:
        for r, p in enumerate(procs):
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            log = (out / f"log{r}.txt").read_text()
            assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    finally:
        stop(procs)
    return [torch.load(out / f"rank{r}.pt") for r in range(len(procs))]


def stop(procs):
    """Ends whichever of the job's processes still run."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]), int(a[1]), a[2], a[3], *(a[4:5] or ["cpu"]),
         a[5].split(",") if len(a) > 5 else None)
