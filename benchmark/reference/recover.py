"""A plain step of material recovery: the loss of the mean of `spp`
PathTracer samples against a target image, autograd's gradient of it
with respect to every material's kD and every area light's radiance, and
Adam's update of both, written from MobileRT's PathTracer (through
pathtracer.py, whose sample it reuses) and the port's documented recovery
step (parallel/recover.py, parallel/mesh.py), in float32.  The check's
control shades in bfloat16: kD, the radiance, the path weights, each
node's contribution, the sample's radiance and the film are held in
bfloat16 (each product is rounded to it where it is stored), while rays,
hit searches and draws stay float32 (in bfloat16 the paths collapse onto
the walls they start from and every gradient is NaN).

What one step of base key K is:
  * sample s of pixel p draws with key fold_in(fold_in(K, s), p), as a
    frame's sample does (pathtracer.py);
  * the sample is traced in full-batch steps, as the port's
    differentiable walk traces it: every lane at every step, in lane
    order, so a lane's node index is the step's; a lane without a ray
    still advances and lends its NEE key to its group, and the NEE light
    samples are shared by each run of `share` consecutive lanes, reversed,
    on every step;
  * the film is the progressive mean of the samples (pathtracer.film);
    the loss is sum((film - target)^2) / (3 w h), with the target in lane
    order; the gradients are of that loss;
  * Adam (lr, betas (0.9, 0.999), eps 1e-8): m = b1 m + (1 - b1) g,
    v = b2 v + (1 - b2) g^2, t = t + 1, p = p - lr / (1 - b1^t) * m /
    (sqrt(v) / sqrt(1 - b2^t) + eps), the bias corrections in float64;
    then kD is clamped to [0, 1] and the radiance to >= 0.

Departures of this reference: the samples run in blocks of `block`
lanes (a multiple of `share`), one block's samples after another, each
block's loss and gradients added up in float64; the loss is a sum over
pixels, and a full-batch NEE group never spans two blocks, so the blocks
add up to the whole step exactly, up to the order of the sums.  Its
Adam takes the moments as the program kept them before the step (torch's
`exp_avg`, `exp_avg_sq`, `step`), and writes the update out rather than
in torch's fused order, which differs by rounding.  Only the scene's real
rows are compared: the program pads its tables to a capacity.  The
target and the state before the step (parameters, Adam's moments and
count) are the program's, read back as inputs of the step; the check
holds the target against pathtracer.py's film of its samples apart.
"""
from __future__ import annotations

import math

import torch

from . import pathtracer
from . import threefry as tf
from . import whitted
from .compare import PPM

BETAS = (0.9, 0.999)
EPS = 1e-8
BLOCK = 65536          # lanes a block of the reference's samples
NUMBERS = ("loss_rel", "grad_rel", "params_rel", "pixels_off_ppm")
NOT_FINITE = 1e30      # what a gap that is NaN or infinite reads


def _view(scene: pathtracer.Scene, kd, radiance, shade) -> pathtracer.Scene:
    """The scene with its kD table and lights' radiance replaced (rounded
    to the dtype `shade`, on autograd's tape of kd and radiance)."""
    view = type(scene).__new__(type(scene))
    view.__dict__.update(vars(scene))
    view.kd = kd.to(shade).to(scene.dtype)
    view.l_rad = radiance.to(shade).to(scene.dtype)
    return view


def full_batch_sample(view, keys, u, v, width: int, height: int,
                      share: int, shade=None):
    """One sample of the lanes (u, v) with keys `keys` in full-batch
    steps: their radiance (B, 3), on the tape.  With `shade` another
    dtype than the scene's, the path weights and each node's contribution
    are rounded to it after every step, and the radiance is returned in
    it."""
    b = u.shape[0]
    o, d = pathtracer.camera_rays(view, u, v, keys, width, height)
    paths = pathtracer._Paths(o, d, view.dtype)
    lanes = torch.arange(b, device=u.device)
    low = shade is not None and shade != view.dtype
    for n in range(pathtracer.MAX_NODES):
        live = paths.pending & (paths.node < pathtracer.MAX_NODES)
        if not bool(live.any()):
            break
        pathtracer._step(view, paths, lanes, keys, share, True, n == 0)
        if low:
            paths.weight = paths.weight.to(shade).to(view.dtype)
            paths.contrib = paths.contrib.to(shade).to(view.dtype)
    rgb = pathtracer._radiance(paths)
    return rgb.to(shade) if low else rgb


def loss_and_grads(scene: pathtracer.Scene, params: dict, base_key,
                   target, width: int, height: int, spp: int,
                   share: int = 128, block: int = BLOCK,
                   shade=None) -> dict:
    """The step's loss, its gradients for "kd" and "radiance" (float32,
    the shape of params') and the film in lane order (float32), for the
    float32 params {"kd": (M, 3), "radiance": (L, 3)} and
    the (H, W, 3) target; shaded in `shade` (the scene's dtype by
    default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if block % share:
        raise ValueError("a block holds whole NEE groups")
    dev = scene.device
    u, v, pids, _ = whitted.pixel_order(width, height)
    b = pids.shape[0]
    u = torch.from_numpy(u).to(dev).to(scene.dtype)
    v = torch.from_numpy(v).to(dev).to(scene.dtype)
    pids = torch.from_numpy(pids).to(dev).long()
    tgt = torch.as_tensor(target).to(dev).float().reshape(b, 3)[pids]
    kd = params["kd"].detach().float().clone().requires_grad_(True)
    rad = params["radiance"].detach().float().clone().requires_grad_(True)
    shade = shade or scene.dtype
    view = _view(scene, kd, rad, shade)
    key_s = [tf.fold_in(base_key.to(dev), s) for s in range(spp)]
    loss = 0.0
    g_kd = torch.zeros(kd.shape, dtype=torch.float64, device=dev)
    g_rad = torch.zeros(rad.shape, dtype=torch.float64, device=dev)
    film = torch.empty((b, 3), dtype=torch.float32, device=dev)
    for b0 in range(0, b, block):
        sl = slice(b0, min(b0 + block, b))
        samples = []
        for s in range(spp):
            keys = tf.fold_in(key_s[s], pids[sl])
            samples.append(full_batch_sample(view, keys, u[sl], v[sl],
                                             width, height, share, shade))
        acc = pathtracer.film(samples).float()
        part = torch.sum((acc - tgt[sl]) ** 2)
        gk, gr = torch.autograd.grad(part, [kd, rad], allow_unused=True)
        loss += float(part.detach())
        for acc64, g in ((g_kd, gk), (g_rad, gr)):
            if g is not None:
                acc64 += g.double()
        film[sl] = acc.detach()
    denom = float(width * height * 3)
    return {"loss": loss / denom,
            "grads": {"kd": (g_kd / denom).float(),
                      "radiance": (g_rad / denom).float()},
            "film": film}


def adam(params: dict, grads: dict, moments: dict, step: int, lr: float,
         upper: dict) -> dict:
    """Adam's update of each parameter from its moments ((m, v) float32,
    zeros before the first step) and the step count before this step,
    then the clamp to [0, upper[name]] (None: no upper bound)."""
    b1, b2 = BETAS
    t = step + 1
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    out = {}
    for k, p in params.items():
        g = grads[k].float()
        m, v = moments[k]
        m = b1 * m.float() + (1.0 - b1) * g
        v = b2 * v.float() + (1.0 - b2) * g * g
        q = p.float() - (lr / bc1) * m / (torch.sqrt(v) / math.sqrt(bc2)
                                          + EPS)
        out[k] = q.clamp(0.0, upper[k])
    return out


def _rows_rel(prog: dict, ref: dict) -> float:
    """The worst row's (r, g, b) gap between the program's and the
    reference's rows, over the larger of that row's and the median row's
    reference norm of the same parameter; the program's rows past the
    reference's (its tables' padding) are not compared."""
    worst = 0.0
    for k, r in ref.items():
        r = r.detach().float()
        p = prog[k].detach().float().to(r.device)[:r.shape[0]]
        rn = r.norm(dim=1)
        med = rn.sort().values[rn.shape[0] // 2]
        gap = (p - r).norm(dim=1) / torch.clamp(torch.maximum(rn, med),
                                                min=1e-30)
        if not bool(torch.isfinite(gap).all()):
            return math.inf
        worst = max(worst, float(gap.max()))
    return worst


def numbers(prog: dict, ref: dict) -> dict:
    """The check's numbers of one step: the loss's relative gap, the
    gradients' and the updated parameters' worst-row relative gaps, and
    the film's pixels off by more than 1e-4 (ppm)."""
    out = dict.fromkeys(NUMBERS[:3], 1.0)
    out["pixels_off_ppm"] = PPM
    r = float(ref["loss"])
    out["loss_rel"] = abs(float(prog["loss"]) - r) / max(abs(r), 1e-30)
    if all(k in prog.get("grads", {}) for k in ref["grads"]):
        out["grad_rel"] = _rows_rel(prog["grads"], ref["grads"])
    if all(k in prog.get("after", {}) for k in ref["after"]):
        out["params_rel"] = _rows_rel(prog["after"], ref["after"])
    if prog.get("film") is not None \
            and prog["film"].shape == ref["film"].shape:
        out["pixels_off_ppm"] = pathtracer.pixels_off(prog["film"],
                                                      ref["film"])
    return {k: v if math.isfinite(v) else NOT_FINITE for k, v in out.items()}
