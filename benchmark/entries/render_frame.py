"""Drives `renderer.render_frame` of mobileraytracer_tpu_torch: one unit is
one frame at the configuration's size and the mix's shader and samples,
in a closed loop with one client (a viewer that asks for the next frame
when the last one is back).  Frame i has key fold_in(prng_key(seed), i)
and ends when its ray count is on the host.

Set-up builds the scene from the benchmark's arrays, attaches the block
grid (`block_traversal.build`, timed as the set-up metric
`setup.scene_build_s`) and renders one frame, which builds or loads the
kernel library.  For the check, the closest-hit and shadow queries of the
scene are wrapped: the frames that a seeded reservoir keeps, and the last
frame, keep their camera rays' hits, their shadow verdicts, their image
and their ray count, and after the window the plain reference renders the
same keys (benchmark/reference/)."""
from __future__ import annotations

import time

import torch

from benchmark import program_scene
from benchmark.harness import UnitDriver
from benchmark.reference import compare, proxy, whitted
from benchmark.reference import threefry as ref_tf
from benchmark.reference.trace import BIG

# Host spans of the traced sub-window: (module, function, span name), each
# a call into one layer of the port.
SPANS = (
    ("mobileraytracer_tpu_torch.renderer", "_pixel_order",
     "frame._pixel_order"),
    ("mobileraytracer_tpu_torch.renderer", "finish_frame",
     "frame.finish_frame"),
    ("mobileraytracer_tpu_torch.renderer", "trace_image_sample",
     "walker.trace_image_sample"),
    ("mobileraytracer_tpu_torch.shaders.common", "direct_lighting",
     "walker.direct_lighting"),
    ("mobileraytracer_tpu_torch.ops.block_traversal",
     "intersect_scene_blocks", "traversal.intersect_scene_blocks"),
    ("mobileraytracer_tpu_torch.ops.block_traversal", "occluded_blocks",
     "traversal.occluded_blocks"),
    ("mobileraytracer_tpu_torch.ops.block_traversal", "_candidates",
     "traversal._candidates"),
    ("mobileraytracer_tpu_torch.ops.block_traversal", "_refill_exact",
     "traversal._refill_exact"),
    ("mobileraytracer_tpu_torch.ops.kernels", "traverse_tilemt",
     "kernels.traverse_tilemt"),
    ("mobileraytracer_tpu_torch.ops.kernels", "traverse_banded",
     "kernels.traverse_banded"),
)


class Driver(UnitDriver):
    spans = SPANS
    _frame = None

    # -- set-up --------------------------------------------------------------
    def setup(self) -> dict:
        from mobileraytracer_tpu_torch import constants as C
        from mobileraytracer_tpu_torch import renderer
        from mobileraytracer_tpu_torch.ops import block_traversal
        from mobileraytracer_tpu_torch.types import RenderConfig

        cfg, tr = self.config, self.traffic
        sc = cfg["scene"]
        self.arrays = proxy.conference_proxy(sc["triangles"], sc["proxy_seed"])
        scene, camera = program_scene.port_scene(self.arrays)
        t0 = time.perf_counter()
        self.scene = block_traversal.build(scene, device=self.device)
        build_s = time.perf_counter() - t0
        self.camera = camera.to(self.device)
        self.render_config = RenderConfig(
            width=cfg["width"], height=cfg["height"], spp=tr["spp"],
            samples_light=cfg["samples_light"],
            shader=getattr(C, tr["shader"]),
            accelerator=getattr(C, cfg["accelerator"]),
            nee_share=cfg["nee_share"], nee_reverse=cfg["nee_reverse"],
            nee_share_secondary=cfg["nee_share_secondary"],
            accumulation=cfg["accumulation"])
        self._render = renderer
        self._wrap_queries(block_traversal)
        self.unit(0, keep=False)          # builds or loads the kernels
        return {"scene_build_s": build_s}

    def _wrap_queries(self, bt):
        closest, occluded = bt.intersect_scene_blocks, bt.occluded_blocks

        def closest_rec(scene, o, d, prev_kind, prev_id, *a, **k):
            hit = closest(scene, o, d, prev_kind, prev_id, *a, **k)
            if self._frame is not None:
                self._frame.setdefault("hit", hit)
            if self.queries is not None:
                self.queries.append((o, d, BIG, prev_kind, prev_id))
            return hit

        def occluded_rec(scene, o, d, max_dist, prev_kind, prev_id, *a, **k):
            occ = occluded(scene, o, d, max_dist, prev_kind, prev_id, *a, **k)
            if self._frame is not None:
                self._frame.setdefault("occ", occ)
            if self.queries is not None:
                self.queries.append((o, d, max_dist, prev_kind, prev_id))
            return occ

        bt.intersect_scene_blocks, bt.occluded_blocks = closest_rec, \
            occluded_rec

        def restore():
            bt.intersect_scene_blocks, bt.occluded_blocks = closest, occluded
        self._restore = restore

    # -- the timed unit ------------------------------------------------------
    def unit(self, i: int, keep: bool = True) -> int:
        """Frame i; returns its casted rays once they are on the host."""
        self._frame = {}
        out = self._render.render_frame(self.scene, self.camera,
                                        self.render_config,
                                        self.unit_key(i))
        rays = int(out["rays"])
        frame, self._frame = self._frame, None
        if keep:
            rec = {"i": i, "image": out["image"], "rays": rays}
            if "hit" in frame:
                h = frame["hit"]
                rec.update(t=h.t, kind=h.prim_kind, mat=h.mat_id,
                           normal=h.normal)
            if "occ" in frame:
                rec["occ"] = frame["occ"]
            self.keep(rec)
        return rays

    def samples_per_unit(self) -> int:
        return self.traffic["spp"]

    # -- the check -----------------------------------------------------------
    def reference_frame(self, i: int, dtype=torch.float32, scene=None):
        scene = scene or whitted.Scene(self.arrays, dtype=dtype,
                                       device=self.device)
        key = ref_tf.fold_in(ref_tf.prng_key(self.seed, self.device), i)
        return whitted.frame(scene, key, self.config["width"],
                             self.config["height"],
                             share=self.config["nee_share"])

    def control(self, i: int) -> dict:
        """The check's numbers of the reference in bfloat16 put in the
        program's place, for frame i."""
        return compare.frame_counts(
            self.reference_frame(i, dtype=torch.bfloat16),
            self.reference_frame(i))

    def check(self) -> dict:
        """The largest count of each kind over the checked frames."""
        scene = whitted.Scene(self.arrays, device=self.device)
        worst = {}
        for rec in self.units_to_check():
            ref = self.reference_frame(rec["i"], scene=scene)
            counts = (compare.frame_counts(rec, ref)
                      if "t" in rec and "occ" in rec
                      else compare.missing_counts(ref))
            for k, v in counts.items():
                worst[k] = max(worst.get(k, 0), v)
        return worst
