"""The comparison that decides `correct`: a frame of the program against
the plain reference's frame of the same key, as shares of what differs,
in parts per million.

Each share is of the lanes (pixels) in which the two disagree by more
than rounding can explain: the camera ray's hit (kind, distance to 1e-4
of it, material, normal to 1e-3) per lane; the shadow ray's verdict per
lane that sends one; the pixel to 1e-4 per pixel; and the frame's ray
count, off by a share of the reference's.  The limits are in
benchmark/limits/, with the readings they were set from in PERF.md.
"""
from __future__ import annotations

import math

import torch

T_REL = 1e-4
NORMAL_ABS = 1e-3
PIXEL_ABS = 1e-4
PPM = 1e6


def frame_counts(prog: dict, ref: dict) -> dict:
    """{"hit_lanes_off_ppm", "shadow_lanes_off_ppm", "pixels_off_ppm",
    "rays_off_ppm"} of one frame.  `prog` holds the program's lane-order
    hit t, kind, material and normal of its camera rays, its shadow
    verdicts ("occ"), its image and ray count; `ref` the same and the
    lanes ("live") whose shadow ray counts.  Answers of another shape
    than the reference's count as missing."""
    dev = ref["t"].device
    p = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
         for k, v in prog.items()}
    if any(p[k].shape != ref[k].shape for k in ("t", "kind", "mat",
                                                 "normal", "occ", "image")):
        return missing_counts(ref)
    hit = ref["kind"] != 0
    t_ref = ref["t"].float()
    off = p["kind"].long() != ref["kind"].long()
    off |= hit & ((p["t"].float() - t_ref).abs()
                  > T_REL * t_ref.clamp(min=1.0))
    off |= hit & (p["mat"].long() != ref["mat"].long())
    off |= hit & ((p["normal"].float() - ref["normal"].float()).abs()
                  .amax(-1) > NORMAL_ABS)
    shadow = ref["live"] & (p["occ"].bool() != ref["occ"].bool())
    pix = ((p["image"].float() - ref["image"].float()).abs().amax(-1)
           > PIXEL_ABS)
    lanes = off.numel()
    return {"hit_lanes_off_ppm": PPM * int(off.sum()) / lanes,
            "shadow_lanes_off_ppm": PPM * int(shadow.sum())
            / max(int(ref["live"].sum()), 1),
            "pixels_off_ppm": PPM * int(pix.sum()) / pix.numel(),
            "rays_off_ppm": PPM * abs(int(p["rays"]) - int(ref["rays"]))
            / int(ref["rays"])}


def missing_counts(ref: dict) -> dict:
    """The shares of a frame whose answers never came: everything off."""
    return dict.fromkeys(("hit_lanes_off_ppm", "shadow_lanes_off_ppm",
                          "pixels_off_ppm", "rays_off_ppm"), PPM)


def _worst_leaf(prog: dict, ref: dict) -> float:
    """The worst leaf's gap between the program's gradient norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf.  Norms, not the norm of the difference: where a
    camera ray meets two coplanar triangles exactly on their shared edge,
    either may take the lane, and its gradient goes to that triangle's
    vertices with the same radiance."""
    norms = {k: float(ref[k].float().norm()) for k in ref}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(prog[k].float().norm()) - norms[k])
               / max(norms[k], med, 1e-30) for k in ref)


ROW_REL = 1e-3


def _rows_off(prog: dict, ref: dict) -> float:
    """The share, in ppm, of the triangle rows that carry a gradient on
    either side whose (va, vb, vc) gradient lies farther from the
    reference's than ROW_REL of the larger of that row's reference norm
    and the median carrying row's.  Unlike the norms, it sees a gradient
    moved between rows or flipped in sign on some of them; a row that is
    not finite is off."""
    names = ("va", "vb", "vc")
    r = torch.cat([ref[k].float() for k in names], 1)
    p = torch.cat([prog[k].float().to(r.device) for k in names], 1)
    rn, pn = r.norm(dim=1), p.norm(dim=1)
    carry = (rn > 0) | (pn != 0)
    if not bool(carry.any()):
        return 0.0
    med = rn[rn > 0].median() if bool((rn > 0).any()) else rn.new_tensor(0.0)
    close = (p - r).norm(dim=1) <= ROW_REL * torch.maximum(rn, med)
    return PPM * int((carry & ~close).sum()) / int(carry.sum())


GRAD_NUMBERS = ("loss_rel", "interior_rel", "edges_rel", "shadow_rel",
                "grad_rel", "grad_rows_off_ppm", "draws_off_ppm")


NOT_FINITE = 1e30      # what a gap that is NaN or infinite reads


def _with_edges(rec: dict) -> dict:
    """rec with "edges": the silhouette and shadow terms summed by leaf."""
    if "silhouette" not in rec or "shadow" not in rec:
        return rec
    sil, sh = rec["silhouette"], rec["shadow"]
    if any(sil[k].shape != sh[k].shape for k in sil):
        return rec
    return dict(rec, edges={k: sil[k] + sh[k].to(sil[k].device)
                            for k in sil})


def grad_numbers(prog: dict, ref: dict) -> dict:
    """The numbers of one vertex-gradient call: the loss's relative gap,
    each part's worst-leaf relative gap (interior, both edge terms
    summed, shadow edges, the whole gradient), the share of the whole gradient's
    carrying rows that are off, and the share of edge draws that
    differ.  A part the program never produced counts as all off, and a
    gap that is not finite reads NOT_FINITE.  The silhouette term is
    compared inside the edge terms' sum and the whole gradient: on about
    half the seeds no drawn silhouette edge sees a radiance jump inside
    the viewport, the term is zero on both sides, and no fault could move
    a number of its own there."""
    prog, ref = _with_edges(prog), _with_edges(ref)
    out = dict.fromkeys(GRAD_NUMBERS, 1.0)
    out["draws_off_ppm"] = out["grad_rows_off_ppm"] = PPM
    if "loss" in prog:
        r = float(ref["loss"])
        out["loss_rel"] = abs(float(prog["loss"]) - r) / max(abs(r), 1e-30)
    for part in ("interior", "edges", "shadow", "grads"):
        if part in prog and all(prog[part][k].shape == ref[part][k].shape
                                for k in ref[part]):
            key = "grad_rel" if part == "grads" else f"{part}_rel"
            out[key] = _worst_leaf(prog[part], ref[part])
            if part == "grads":
                out["grad_rows_off_ppm"] = _rows_off(prog[part], ref[part])
    if "draws" in prog and prog["draws"].shape == ref["draws"].shape:
        off = prog["draws"].to(ref["draws"].device) != ref["draws"]
        out["draws_off_ppm"] = PPM * float(off.float().mean())
    return {k: v if math.isfinite(v) else NOT_FINITE for k, v in out.items()}
