"""Drives `diff.geom.vertex_grad` of mobileraytracer_tpu_torch: one unit is
one call, the vertex-position gradient of the mean of a Whitted frame at
the configuration's size (interior by autograd, silhouette and shadow
edge terms by the mix's budgets of edge draws), in a closed loop with one
client (a training loop that asks for the next gradient when the last is
back).  Call i has base key fold_in(prng_key(seed), i) and ends when its
loss is on the host.

Set-up builds the scene from the benchmark's arrays, attaches the block
grid (`block_traversal.build`, the set-up metric `setup.scene_build_s`),
takes `edge_topology` of the built scene's triangles, the rows that
`vertex_grad` sees, and makes one call.  For the check, the call's parts
are wrapped: the calls that a seeded reservoir keeps, and the last call,
keep the loss, the interior, silhouette and shadow terms, the edge draws
and the whole gradient, and after the window the plain reference works
out the same keys (benchmark/reference/vgrad.py)."""
from __future__ import annotations

import time

import torch

from benchmark import program_scene
from benchmark.harness import UnitDriver
from benchmark.reference import compare, proxy, vgrad
from benchmark.reference import threefry as ref_tf

SPANS = (
    ("mobileraytracer_tpu_torch.diff.geom", "_interior", "gradients.interior"),
    ("mobileraytracer_tpu_torch.diff.geom", "_silhouette_term",
     "gradients.silhouette"),
    ("mobileraytracer_tpu_torch.diff.geom", "_shadow_boundary_term",
     "gradients.shadow"),
    ("mobileraytracer_tpu_torch.diff.geom", "_draw_edges",
     "gradients.draws"),
    ("mobileraytracer_tpu_torch.diff.geom", "trace_image_sample",
     "walker.trace_image_sample"),
    ("mobileraytracer_tpu_torch.ops.block_traversal",
     "intersect_scene_blocks", "traversal.intersect_scene_blocks"),
    ("mobileraytracer_tpu_torch.ops.block_traversal", "occluded_blocks",
     "traversal.occluded_blocks"),
    ("mobileraytracer_tpu_torch.ops.kernels", "traverse_banded",
     "kernels.traverse_banded"),
)
PARTS = {"_interior": "interior", "_silhouette_term": "silhouette",
         "_shadow_boundary_term": "shadow", "_draw_edges": "draws"}


class Driver(UnitDriver):
    spans = SPANS
    _call = None

    def setup(self) -> dict:
        from mobileraytracer_tpu_torch import constants as C
        from mobileraytracer_tpu_torch.diff import geom
        from mobileraytracer_tpu_torch.ops import block_traversal
        from mobileraytracer_tpu_torch.types import RenderConfig

        cfg, tr = self.config, self.traffic
        self.arrays = proxy.conference_proxy(cfg["scene"]["triangles"],
                                             cfg["scene"]["proxy_seed"])
        scene, camera = program_scene.port_scene(self.arrays)
        t0 = time.perf_counter()
        self.scene = block_traversal.build(scene, device=self.device)
        build_s = time.perf_counter() - t0
        edge_keep = geom.edge_topology(self.scene.triangles)
        self.camera = camera.to(self.device)
        self.render_config = RenderConfig(
            width=cfg["width"], height=cfg["height"], spp=1,
            shader=getattr(C, tr["shader"]),
            accelerator=getattr(C, cfg["accelerator"]),
            nee_share=cfg["nee_share"])
        self.kwargs = dict(edge_samples=tr["edge_samples"],
                           edge_keep=edge_keep,
                           edge_budget=tr["edge_budget"],
                           shadow_edges=tr["shadow_edges"],
                           shadow_budget=tr["shadow_budget"])
        self._geom = geom
        self._wrap_parts(geom)
        self.unit(0, keep=False)
        return {"scene_build_s": build_s}

    def _wrap_parts(self, geom):
        saved = {name: getattr(geom, name) for name in PARTS}

        def recorder(name):
            fn, part = saved[name], PARTS[name]

            def rec(*a, **k):
                out = fn(*a, **k)
                if self._call is not None:
                    self._call.setdefault(part, []).append(out)
                return out
            return rec
        for name in PARTS:
            setattr(geom, name, recorder(name))

        def restore():
            for name, fn in saved.items():
                setattr(geom, name, fn)
        self._restore = restore

    def unit(self, i: int, keep: bool = True) -> int:
        """Call i; returns its pixels once its loss is on the host."""
        self._call = {}
        loss, grads = self._geom.vertex_grad(
            self.scene, self.camera, self.render_config,
            self.unit_key(i), **self.kwargs)
        float(loss)
        call, self._call = self._call, None
        if keep:
            rec = {"i": i, "loss": loss, "grads": grads}
            if "interior" in call:
                rec["interior"] = call["interior"][0][1]
            for part in ("silhouette", "shadow"):
                if part in call:
                    rec[part] = call[part][0]
            if "draws" in call:
                rec["draws"] = torch.cat([sel for sel, _ in call["draws"]])
            self.keep(rec)
        return self.render_config.width * self.render_config.height

    def samples_per_unit(self) -> int:
        return 1

    def reference_call(self, i: int, shade=None, scene=None):
        scene = scene or vgrad.Scene(self.arrays, device=self.device,
                                     shade=shade)
        tr = self.traffic
        key = ref_tf.fold_in(ref_tf.prng_key(self.seed, self.device), i)
        return vgrad.vertex_grad(scene, key, self.config["width"],
                                 self.config["height"],
                                 samples=tr["edge_samples"],
                                 budget=tr["edge_budget"],
                                 shadow_budget=tr["shadow_budget"])

    def control(self, i: int) -> dict:
        """The check's numbers of the reference in bfloat16 put in the
        program's place, for call i: its rays and hit search in float32
        (in bfloat16 they collapse and every gradient is NaN), its
        shading, edge weights, draws' weights and gradients in bfloat16."""
        return compare.grad_numbers(
            self.reference_call(i, shade=torch.bfloat16),
            self.reference_call(i))

    def check(self) -> dict:
        scene = vgrad.Scene(self.arrays, device=self.device)
        worst = {}
        for rec in self.units_to_check():
            ref = self.reference_call(rec["i"], scene=scene)
            for k, v in compare.grad_numbers(rec, ref).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst
