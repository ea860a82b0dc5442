#!/usr/bin/env python3
"""The PyTorch port's conference Whitted frame (chip_smoke.py phase 6:
512x512, 1 spp, block BVH, nee_share=128, reversed NEE,
nee_share_secondary=True) from several checkouts in turn on one NVIDIA
GPU, each in a process of its own, so that two versions are compared
within one run.

    python scripts/torch_frame_ab.py [--digests] PARENT CHANGE CHANGE PARENT

Each argument is a directory that holds a checkout's
mobileraytracer_tpu_torch/.  Prints one line per run: ms/frame (the mean
of 5 frames by CUDA events after a warm-up), the host clock's median,
rays, and one frame's device busy time and device events under
torch.profiler, beside the card's name and power limit (nvidia-smi).
With --digests each run also prints the SHA-256 of the Whitted frame's
image and bitmap and of chip_smoke.py phase 8's frames (the 64x64
cornell2 PathTracer at 2 spp, the 20k proxy's DepthMap and
DiffuseMaterial at 64x64, the conference PathTracer at 512x512 and 1
spp) with their rays, so two checkouts' frames can be compared bit for
bit.
"""
import hashlib
import pathlib
import statistics
import subprocess
import sys
import time

import torch

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402


def digest(out):
    """SHA-256 (first 16 hex digits) of a frame's image and bitmap bytes,
    and its rays."""
    h = hashlib.sha256(out["image"].cpu().numpy().tobytes())
    h.update(out["bitmap"].cpu().numpy().tobytes())
    return f"{h.hexdigest()[:16]} ({int(out['rays'])} rays)"


def phase8_digests(mrt, scene, cam, key):
    """The digests of chip_smoke.py phase 8's frames."""
    from mobileraytracer_tpu_torch import bench_scenes, scenes
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    dev = key.device
    small, scam, _ = bench_scenes.conference_proxy(target_prims=20000)
    small = bt.build(small, device=dev)
    cornell2, c2cam = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    mp_obj = torch.from_numpy(scenes.DEPTHMAP_MAX_POINT[C.SCENE_OBJ])
    cases = {
        "pathtracer64": (bt.build(cornell2, device=dev), c2cam,
                         dict(shader=C.SHADER_PATHTRACER, spp=2,
                              nee_share=128, nee_share_secondary=True), None),
        "depthmap64": (small, scam, dict(shader=C.SHADER_DEPTHMAP), mp_obj),
        "diffuse64": (small, scam, dict(shader=C.SHADER_DIFFUSE), None),
    }
    out = {}
    for name, (sc, cm, kw, mp) in cases.items():
        cfg = mrt.RenderConfig(width=64, height=64, accelerator=C.ACC_BVH,
                               **kw)
        out[name] = digest(mrt.render_frame(sc, cm, cfg, key, mp))
    out["pathtracer512"] = digest(mrt.render_frame(
        scene, cam, chip_smoke.pt_config(1), key))
    return out


def one(root, card, digests=False):
    root = pathlib.Path(root).resolve()
    sys.path.insert(0, str(root))
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import bench_scenes, sampling
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    if root not in pathlib.Path(mrt.__file__).resolve().parents:
        raise SystemExit(f"imported {mrt.__file__}, not from {root}")
    dev = torch.device("cuda:0")
    scene, cam, _ = bench_scenes.conference_proxy()
    scene = bt.build(scene, device=dev)
    cfg = mrt.RenderConfig(width=512, height=512, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                           nee_share=128, nee_share_secondary=True)
    key = sampling.prng_key(0, dev)

    def frame():
        return mrt.render_frame(scene, cam, cfg, key)

    rays = int(frame()["rays"])
    ms = chip_smoke.cuda_ms(frame, chip_smoke.FRAMES)
    walls = []
    for _ in range(chip_smoke.FRAMES):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    busy, events, _, _ = chip_smoke.profile_device(frame)
    print(f"{root}: 512x512 Whitted frame {ms:.3f} ms/frame by CUDA events "
          f"(mean of {chip_smoke.FRAMES}), host clock median "
          f"{statistics.median(walls):.3f} ms, {rays} rays; one frame under "
          f"torch.profiler: device busy {busy:.3f} ms over {events} device "
          f"events [{card}]", flush=True)
    if digests:
        frames = {"whitted512": digest(frame()),
                  **phase8_digests(mrt, scene, cam, key)}
        print(f"{root}: frame digests " + "; ".join(
            f"{k} {v}" for k, v in frames.items()), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_frame_ab: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    args = sys.argv[1:]
    if args[0] == "--one":
        one(args[-1], card, digests="--digests" in args)
        return
    flags = [a for a in args if a == "--digests"]
    for root in (a for a in args if a != "--digests"):
        subprocess.run([sys.executable, __file__, "--one", *flags, root],
                       check=True)


if __name__ == "__main__":
    main()
