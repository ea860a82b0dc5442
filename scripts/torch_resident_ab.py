#!/usr/bin/env python3
"""The resident-table kernel's time on chip_smoke.py phase 7's shadow batch
(the conference proxy's 512x512 primaries, their tile-MT hits, and the
reversed shared-light NEE segments toward the lights, nee_share=128, in
the banded windows) from several checkouts in turn on one NVIDIA GPU,
each in a process of its own, so that two versions of the kernel are
compared within one run.

    python scripts/torch_resident_ab.py PARENT CHANGE CHANGE PARENT

Each argument is a directory that holds a checkout's
mobileraytracer_tpu_torch/.  Prints one line per run: the kernel's ms at
its default 8 bands a program (three means of 10 calls by CUDA events,
each after a warm-up), its registers and spilled bytes, and the first 16
hex digits of the SHA-256 of its output, beside the card's name and power
limit (nvidia-smi).
"""
import hashlib
import pathlib
import subprocess
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402


def one(root, card):
    root = pathlib.Path(root).resolve()
    sys.path.insert(0, str(root))
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import bench_scenes, renderer, sampling
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.ops import _build
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.ops import kernels as K
    from mobileraytracer_tpu_torch.shaders import common
    if root not in pathlib.Path(mrt.__file__).resolve().parents:
        raise SystemExit(f"imported {mrt.__file__}, not from {root}")
    dev = torch.device("cuda:0")
    scene, cam, _ = bench_scenes.conference_proxy()
    scene = bt.build(scene, device=dev)
    cfg = mrt.RenderConfig(width=512, height=512, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                           nee_share=128, nee_share_secondary=True)
    key = sampling.prng_key(0, dev)
    o, d = chip_smoke.mrt_primaries(scene, cam, cfg)
    b = o.shape[0]
    pk = torch.zeros(b, dtype=torch.int32, device=dev)
    pi = torch.full((b,), -1, dtype=torch.int32, device=dev)
    hit = bt.intersect_scene_blocks(scene, o, d, pk, pi, mode="tilemt")
    pids = renderer._pixel_order(cfg, dev)[2]
    keys = sampling.event_key(sampling.ray_key(key, pids, 0), 0, 1)
    shadow = {}

    def occ(scene_, o_, d_, md, pk_, pi_, **_):
        shadow["rays"] = (o_, d_, torch.as_tensor(md, device=dev).expand(b),
                          pk_, pi_)
        return bt.occluded_blocks(scene_, o_, d_, md, pk_, pi_,
                                  mode="banded")

    common.direct_lighting(scene, hit, keys, cfg.samples_light, shadows=True,
                           occluded_fn=occ, mask=~hit.missed,
                           share_mask=None, share_width=cfg.nee_share,
                           reverse=True, share_all=True)
    so, sd, md, spk, spi = shadow["rays"]
    rays, bp = bt._pack_rays(so, sd, md, spk, spi, K.TILE)
    cap0 = rays[:, 6].reshape(bp // K.ST, K.ST).amax(1)
    cg, _, ce, _ = bt._candidates(scene.bvh, rays[:, 0:3], rays[:, 3:6],
                                  cap=cap0)
    tb_pad, starts, glist, n_parts = bt._resident_lists(scene.bvh, cg, ce)
    args = (tb_pad, starts, glist, rays, cg.shape[1], n_parts)
    out = torch.stack(K.traverse_resident(*args))
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
    ms = [chip_smoke.cuda_ms(lambda: K.traverse_resident(*args), 10)
          for _ in range(3)]
    ki = _build.kernel_info("resident")
    print(f"{root}: traverse_resident on the shadow batch ({bp} rays, "
          f"{n_parts} partitions, m {cg.shape[1]}): "
          + ", ".join(f"{x:.4f}" for x in ms)
          + f" ms (means of 10 calls by CUDA events); {ki['regs']} "
          f"registers, {ki['local_bytes']} spilled bytes, "
          f"{ki['static_smem'] + ki['dynamic_smem']} B of shared memory; "
          f"output {digest} [{card}]", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_resident_ab: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    if sys.argv[1] == "--one":
        one(sys.argv[2], card)
        return
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)


if __name__ == "__main__":
    main()
