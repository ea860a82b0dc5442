"""Drives the progressive `renderer.Renderer` of mobileraytracer_tpu_torch:
one unit is one sample of a frame at the configuration's size, shader and
samples, rendered by `Renderer.render` (its `frame.render_sample` span),
in a closed loop with one client (MobileRT's progressive viewer, which
asks for the next sample when the last one's bitmap is back).  Frame f is
one Renderer life with base key fold_in(prng_key(seed), f); unit i is
sample i mod spp of frame i // spp, and frame f + 1 starts after frame
f's last sample.  A unit ends when its ray count is on the host.

Set-up builds the scene from the benchmark's arrays, attaches the block
grid (`block_traversal.build`, timed as `setup.scene_build_s`) and renders
one sample in a Renderer of its own, which builds or loads the kernel
library.  For the check, the Renderer's sample function and the scene's
closest-hit query are wrapped: the samples that a seeded reservoir keeps,
and the last sample, keep their camera rays' hits, their radiance, their
ray count and the film after them, and after the window the plain
reference (benchmark/reference/pathtracer.py) renders the same keys.  The
walker's chunk order is wrapped too: each sample of the frame in flight
keeps the lanes of its chunk steps (int32, on the card), which the
reference follows, so that a lane that rightly differs (a tie between
coincident triangles) stays one pixel instead of moving every NEE group
behind it."""
from __future__ import annotations

import time

import torch

from benchmark import program_scene
from benchmark.harness import UnitDriver
from benchmark.reference import pathtracer, proxy
from benchmark.reference import threefry as ref_tf
from benchmark.reference.trace import BIG

# Host spans of the traced sub-window: (module, function, span name), each
# a call into one layer of the port.
SPANS = (
    ("mobileraytracer_tpu_torch.renderer", "_pixel_order",
     "frame._pixel_order"),
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
    _sample = None
    _life = None         # (frame, its Renderer)
    _layouts = None      # sample -> its chunk steps' lanes, in that frame

    def reseed(self, seed: int):
        super().reseed(seed)
        self._life = None

    # -- set-up --------------------------------------------------------------
    def setup(self) -> dict:
        from mobileraytracer_tpu_torch import constants as C
        from mobileraytracer_tpu_torch import renderer
        from mobileraytracer_tpu_torch.ops import block_traversal
        from mobileraytracer_tpu_torch.types import RenderConfig

        cfg = self.config
        sc = cfg["scene"]
        self.arrays = proxy.conference_proxy(sc["triangles"], sc["proxy_seed"])
        scene, camera = program_scene.port_scene(self.arrays)
        t0 = time.perf_counter()
        self.scene = block_traversal.build(scene, device=self.device)
        build_s = time.perf_counter() - t0
        self.camera = camera.to(self.device)
        self.render_config = RenderConfig(
            width=cfg["width"], height=cfg["height"], spp=cfg["spp"],
            samples_light=cfg["samples_light"],
            shader=getattr(C, cfg["shader"]),
            accelerator=getattr(C, cfg["accelerator"]),
            depth_min=cfg["depth_min"], depth_max=cfg["depth_max"],
            nee_share=cfg["nee_share"], nee_reverse=cfg["nee_reverse"],
            nee_share_secondary=cfg["nee_share_secondary"],
            accumulation=cfg["accumulation"])
        self._render = renderer
        self._wrap(renderer, block_traversal)
        self.unit(0, keep=False)          # builds or loads the kernels
        self._life = None
        return {"scene_build_s": build_s}

    def _wrap(self, rn, bt):
        from mobileraytracer_tpu_torch.shaders import engine
        render_sample, closest = rn.render_sample, bt.intersect_scene_blocks
        order = engine._coherence_order
        cfg = self.render_config
        chunk = pathtracer.chunk_lanes(cfg.width * cfg.height)

        def order_rec(state, live):
            idx = order(state, live)
            if self._sample is not None:
                self._sample.setdefault("layout", []).append(
                    idx[:chunk].to(torch.int32))
            return idx

        def sample_rec(*a, **k):
            rgb, rays = render_sample(*a, **k)
            if self._sample is not None:
                self._sample["rgb"] = rgb
            return rgb, rays

        # A query made while a walk step's CUDA graph is captured runs
        # again at each replay on the same tensors: it is kept, and the
        # replays' values of it are recorded after each replay.
        captured = []

        def query(q):
            if torch.cuda.is_available() and \
                    torch.cuda.is_current_stream_capturing():
                captured.append(q)
            elif self.queries is not None:
                self.queries.append(q)

        def closest_rec(scene, o, d, prev_kind, prev_id, *a, **k):
            hit = closest(scene, o, d, prev_kind, prev_id, *a, **k)
            if self._sample is not None:
                self._sample.setdefault("hit", hit)
            query((o, d, BIG, prev_kind, prev_id))
            return hit

        occluded = bt.occluded_blocks

        def occluded_rec(scene, o, d, max_dist, prev_kind, prev_id, *a, **k):
            occ = occluded(scene, o, d, max_dist, prev_kind, prev_id, *a, **k)
            query((o, d, max_dist, prev_kind, prev_id))
            return occ

        graph = getattr(engine, "_StepGraph", None)
        if graph is not None:
            init, run = graph.__init__, graph.run

            def init_rec(g, *a, **k):
                del captured[:]
                init(g, *a, **k)
                g.bench_queries = list(captured)
                del captured[:]

            def run_rec(g):
                out = run(g)
                if self.queries is not None and out is g.out:
                    self.queries.extend(
                        tuple(x.clone() if isinstance(x, torch.Tensor)
                              else x for x in q) for q in g.bench_queries)
                return out
            graph.__init__, graph.run = init_rec, run_rec

        rn.render_sample = sample_rec
        bt.intersect_scene_blocks = closest_rec
        bt.occluded_blocks = occluded_rec
        engine._coherence_order = order_rec

        def restore():
            rn.render_sample = render_sample
            bt.intersect_scene_blocks = closest
            bt.occluded_blocks = occluded
            engine._coherence_order = order
            if graph is not None:
                graph.__init__, graph.run = init, run
            getattr(engine, "clear_graphs", lambda: None)()
        self._restore = restore

    # -- the timed unit ------------------------------------------------------
    def _renderer(self, frame: int):
        """A new Renderer life for `frame`: its base key, an empty film."""
        r = self._render.Renderer(self.scene, self.camera, self.render_config,
                                  device=self.device)
        r._key = self.unit_key(frame)
        return r

    def unit(self, i: int, keep: bool = True) -> int:
        """Unit i, sample i mod spp of frame i // spp; returns its casted
        rays once they are on the host."""
        frame, s = divmod(i, self.render_config.spp)
        if self._life is None or self._life[0] != frame:
            self._life = (frame, self._renderer(frame))
            self._layouts = {}
        r = self._life[1]
        before = r.total_rays
        self._sample = {}
        r._stop = False                   # the last unit stopped it
        r.render(callback=lambda rr: rr.stop_render())
        sample, self._sample = self._sample, None
        rays = r.total_rays - before
        self._layouts[s] = sample.get("layout", [])
        if keep:
            rec = {"i": i, "frame": frame, "sample": s, "rays": rays,
                   "film": r._accum, "layouts": dict(self._layouts)}
            if "rgb" in sample:
                rec["rgb"] = sample["rgb"]
            if "hit" in sample:
                h = sample["hit"]
                rec.update(t=h.t, kind=h.prim_kind, mat=h.mat_id,
                           normal=h.normal)
            self.keep(rec)
        return rays

    def samples_per_unit(self) -> int:
        return 1

    # -- the check -----------------------------------------------------------
    def _reference(self, scene, frame: int, s: int, layout=None) -> dict:
        key = ref_tf.fold_in(ref_tf.prng_key(self.seed, self.device), frame)
        cfg = self.config
        return pathtracer.sample(scene, key, s, cfg["width"], cfg["height"],
                                 share=cfg["nee_share"],
                                 secondary=cfg["nee_share_secondary"],
                                 layout=layout)

    def _numbers(self, recs, scene) -> dict:
        """The largest count of each kind over the samples `recs`, and the
        film after the last of them, against the reference's, each
        reference sample on the program's chunk layout of that sample
        where one was kept; reference samples are worked out once each."""
        done = {}

        def ref(frame, s, layouts):
            if (frame, s) not in done:
                done[(frame, s)] = self._reference(scene, frame, s,
                                                   layouts.get(s))
            return done[(frame, s)]

        worst = {}
        for rec in recs:
            counts = pathtracer.sample_counts(
                rec, ref(rec["frame"], rec["sample"], rec.get("layouts", {})))
            for k, v in counts.items():
                worst[k] = max(worst.get(k, 0.0), v)
        last = recs[-1]
        layouts = last.get("layouts", {})
        film = pathtracer.film(ref(last["frame"], s, layouts)["rgb"]
                               for s in range(last["sample"] + 1))
        worst.update(pathtracer.film_counts(last.get("film"), film))
        return worst

    def check(self) -> dict:
        scene = pathtracer.Scene(self.arrays, device=self.device)
        return self._numbers(self.units_to_check(), scene)

    def control(self, i: int) -> dict:
        """The check's numbers of the reference in bfloat16 put in the
        program's place, for unit i (its sample, and the film of its frame
        up to it)."""
        frame, s = divmod(i, self.render_config.spp)
        low = pathtracer.Scene(self.arrays, dtype=torch.bfloat16,
                               device=self.device)
        recs = []
        for k in range(s + 1):
            rec = self._reference(low, frame, k)
            recs.append(dict(rec, frame=frame, sample=k))
        films = [r["rgb"] for r in recs]
        last = dict(recs[-1], film=pathtracer.film(films))
        scene = pathtracer.Scene(self.arrays, device=self.device)
        return self._numbers([last], scene)
