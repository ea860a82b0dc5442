"""Drives `parallel.recover.make_recovery_step` of mobileraytracer_tpu_torch:
one unit is one Adam step of material and emission recovery, the
configuration's `recovered` parameters (every material's kD and the area
lights' radiance) fitted to a target image.  A step renders the
configuration's samples of every pixel by the differentiable walk, takes
autograd's gradient of the image loss, applies Adam and clamps.  Steps run
in a closed loop with one client, as a training loop does: step i has base
key fold_in(prng_key(seed), i), the state (parameters and Adam's moments)
carries over from step to step, and a step ends when its loss is on the
host, as `recover_materials` reads it.

Set-up builds the scene from the benchmark's arrays, attaches the block
grid (`block_traversal.build`, timed as `setup.scene_build_s`), makes the
step function, renders the target (the port's `render_frame` at the true
materials and radiance, key fold_in(prng_key(seed), target_key_fold)) and
takes one warm step from the start values, whose state it then drops.
For the check, the step's samples are wrapped: the step that a seeded
reservoir keeps records the parameters and Adam's moments and count
before it, its loss and gradients, the parameters after it and its
samples' mean image; after the window the plain reference
(benchmark/reference/recover.py) works out the same step from that
state.  The target, an input of every step, is held apart against the
plain PathTracer's film of the same key (benchmark/reference/
pathtracer.py, on the chunk layouts that the target's samples took)."""
from __future__ import annotations

import time

import torch

from benchmark import program_scene
from benchmark.harness import UnitDriver
from benchmark.reference import pathtracer, proxy
from benchmark.reference import recover as ref_recover
from benchmark.reference import threefry as ref_tf
from benchmark.reference import whitted

# Host spans of the traced sub-window: (module, function, span name), each
# a call into one layer of the port.
SPANS = (
    ("mobileraytracer_tpu_torch.parallel.mesh", "render_loss_fn",
     "training.forward"),
    ("torch.autograd", "grad", "training.backward"),
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
    ("mobileraytracer_tpu_torch.ops.kernels", "traverse_banded",
     "kernels.traverse_banded"),
)


class Driver(UnitDriver):
    spans = SPANS
    _step = None         # the step in flight's samples, while recorded

    def reseed(self, seed: int):
        super().reseed(seed)
        self.state = self.target = self.target_layouts = None

    # -- set-up --------------------------------------------------------------
    def setup(self) -> dict:
        from mobileraytracer_tpu_torch import constants as C
        from mobileraytracer_tpu_torch.ops import block_traversal
        from mobileraytracer_tpu_torch.parallel import recover
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
        adam = cfg["adam"]
        if (tuple(adam["betas"]), adam["eps"]) != (recover.BETAS,
                                                   recover.EPS):
            raise ValueError("the program's Adam is not the configuration's")
        self._recover = recover
        # A program without the lights' radiance as a parameter fails here.
        self.step_fn, _ = recover.make_recovery_step(
            self.scene, self.camera, self.render_config,
            params_subset=tuple(cfg["recovered"]),
            learning_rate=adam["lr"])
        self._wrap()
        self.unit(0, keep=False)      # the target, the kernels, the memory
        self.state = None             # the window starts from the start
        return {"scene_build_s": build_s}

    def _wrap(self):
        from mobileraytracer_tpu_torch import film
        from mobileraytracer_tpu_torch.parallel import mesh
        sample_pixels = mesh.sample_pixels

        def sample_rec(*a, **k):
            rgb, rays = sample_pixels(*a, **k)
            rec = self._step
            if rec is not None:
                rec["n"] += 1
                acc = rec.get("film")
                if acc is None:
                    acc = torch.zeros_like(rgb, dtype=torch.float32)
                rec["film"] = film.incremental_avg_float(acc, rgb.detach(),
                                                         rec["n"])
            return rgb, rays
        mesh.sample_pixels = sample_rec

        def restore():
            from mobileraytracer_tpu_torch.shaders import engine
            mesh.sample_pixels = sample_pixels
            getattr(engine, "clear_graphs", lambda: None)()
        self._restore = restore

    # -- the state and the target ---------------------------------------------
    def _start_values(self) -> dict:
        """The configuration's start values of the recovered parameters:
        kD flat, the lights' radiance scaled."""
        st = self.config["start"]
        mats, lights = self.scene.materials, self.scene.lights
        start = {"kd": torch.full_like(mats.kd, st["kd"]),
                 "radiance": lights.radiance * st["radiance_scale"]}
        return {k: start[k] for k in self.config["recovered"]}

    def _target(self) -> torch.Tensor:
        """The seed's target image (H, W, 3), rendered once; the chunk
        steps' lanes of each of its samples are kept for the check."""
        if self.target is None:
            from mobileraytracer_tpu_torch import renderer, sampling
            from mobileraytracer_tpu_torch.shaders import engine
            key = sampling.fold_in(
                sampling.prng_key(self.seed, self.device),
                self.config["target_key_fold"])
            cfg = self.render_config
            chunk = pathtracer.chunk_lanes(cfg.width * cfg.height)
            sample_pixels, order = renderer.sample_pixels, \
                engine._coherence_order
            layouts = []

            def sample_rec(*a, **k):
                layouts.append([])
                return sample_pixels(*a, **k)

            def order_rec(state, live):
                idx = order(state, live)
                layouts[-1].append(idx[:chunk].to(torch.int32))
                return idx
            renderer.sample_pixels = sample_rec
            engine._coherence_order = order_rec
            try:
                self.target = renderer.render_frame(
                    self.scene, self.camera, cfg, key)["image"]
            finally:
                renderer.sample_pixels = sample_pixels
                engine._coherence_order = order
            self.target_layouts = layouts
            engine.clear_graphs()
        return self.target

    def _snapshot(self) -> dict:
        """The parameters and Adam's moments and count before a step."""
        params, opt = self.state
        out = {"params": {}, "m": {}, "v": {}, "step": 0}
        for k, p in params.items():
            st = opt.state.get(p, {})
            out["params"][k] = p.detach().clone()
            zero = torch.zeros_like(p)
            out["m"][k] = st["exp_avg"].clone() if st else zero
            out["v"][k] = st["exp_avg_sq"].clone() if st else zero
            if st:
                out["step"] = int(st["step"])
        return out

    # -- the timed unit ------------------------------------------------------
    def unit(self, i: int, keep: bool = True) -> int:
        """Step i; returns its pixels once its loss is on the host."""
        target = self._target()
        if self.state is None:
            self.state = self._recover.make_state(self._start_values(),
                                                  self.config["adam"]["lr"])
        before = self._snapshot() if keep else None
        self._step = {"n": 0} if keep else None
        self.state, loss = self.step_fn(self.state, self.unit_key(i), target)
        loss = float(loss)
        rec, self._step = self._step, None
        if keep:
            params = self.state[0]
            self.keep({
                "i": i, "loss": loss, "before": before,
                "grads": {k: p.grad.detach().clone()
                          for k, p in params.items()},
                "after": {k: p.detach().clone() for k, p in params.items()},
                "film": rec.get("film")})
        return self.render_config.width * self.render_config.height

    def samples_per_unit(self) -> int:
        return 1

    # -- the check -----------------------------------------------------------
    def _rows(self) -> dict:
        """The scene's real rows of each recovered parameter."""
        rows = {"kd": len(self.arrays["kd"]),
                "radiance": len(self.arrays["lights"])}
        return {k: rows[k] for k in self.config["recovered"]}

    def _reference(self, scene, i: int, before: dict, shade=None) -> dict:
        """The reference's step i from the state `before` (the program's
        rows, cut to the scene's), shaded in `shade` (float32 by
        default)."""
        cfg = self.config
        rows = self._rows()
        params = {k: before["params"][k][:n] for k, n in rows.items()}
        key = ref_tf.fold_in(ref_tf.prng_key(self.seed, self.device), i)
        out = ref_recover.loss_and_grads(
            scene, params, key, self._target(), cfg["width"], cfg["height"],
            cfg["spp"], share=cfg["nee_share"], shade=shade)
        return self._update(out, before)

    def _update(self, out: dict, before: dict) -> dict:
        """`out` with "after": Adam's update of the state `before` by
        out's gradients, and the clamp."""
        cfg = self.config
        rows = self._rows()
        params = {k: before["params"][k][:n] for k, n in rows.items()}
        moments = {k: (before["m"][k][:n], before["v"][k][:n])
                   for k, n in rows.items()}
        upper = {k: cfg["clamp"][k][1] for k in rows}
        out["after"] = ref_recover.adam(params, out["grads"], moments,
                                        before["step"], cfg["adam"]["lr"],
                                        upper)
        return out

    def _target_film(self, scene, layouts=None) -> torch.Tensor:
        """The plain PathTracer's film (lane order) of the target's key
        and samples, on `layouts` (each sample's chunk steps' lanes)
        where given."""
        cfg = self.config
        key = ref_tf.fold_in(ref_tf.prng_key(self.seed, self.device),
                             cfg["target_key_fold"])
        return pathtracer.film(
            pathtracer.sample(scene, key, s, cfg["width"], cfg["height"],
                              share=cfg["nee_share"],
                              secondary=cfg["nee_share_secondary"],
                              layout=layouts[s] if layouts else None)["rgb"]
            for s in range(cfg["spp"]))

    def _target_off(self, prog_film, scene) -> dict:
        """{"target_pixels_off_ppm"}: the pixels of `prog_film` (lane
        order) off the reference's film of the target by more than 1e-4."""
        ref = self._target_film(scene, self.target_layouts)
        return {"target_pixels_off_ppm": pathtracer.pixels_off(prog_film,
                                                               ref)}

    def check(self) -> dict:
        scene = pathtracer.Scene(self.arrays, device=self.device)
        worst = {}
        for rec in self.units_to_check():
            ref = self._reference(scene, rec["i"], rec["before"])
            for k, v in ref_recover.numbers(rec, ref).items():
                worst[k] = max(worst.get(k, 0.0), v)
        cfg = self.config
        _, _, pids, _ = whitted.pixel_order(cfg["width"], cfg["height"])
        lanes = torch.from_numpy(pids).to(self.device).long()
        worst.update(self._target_off(
            self._target().reshape(-1, 3)[lanes], scene))
        return worst

    def control(self, i: int) -> dict:
        """The check's numbers of the reference shaded in bfloat16
        (reference/recover.py; rays and hit searches in float32) put in the
        program's place, for step i + 1 of a run from the start values:
        the float32 reference takes step i, and both take the next one
        from the state it left, so that Adam's update depends on the
        gradients' sizes, as from the second step on, and not on their
        signs alone; and the target's film of the plain PathTracer whole
        in bfloat16 (pathtracer.py's control) in the program's target's
        place."""
        start = self._start_values()
        zero = {k: torch.zeros_like(p) for k, p in start.items()}
        scene = pathtracer.Scene(self.arrays, device=self.device)
        first = self._reference(scene, i, {"params": start, "m": zero,
                                           "v": zero, "step": 0})
        b1, b2 = ref_recover.BETAS
        g = first["grads"]
        second = {"params": first["after"], "step": 1,
                  "m": {k: (1 - b1) * g[k] for k in g},
                  "v": {k: (1 - b2) * g[k] * g[k] for k in g}}
        low = self._reference(scene, i + 1, second, shade=torch.bfloat16)
        out = ref_recover.numbers(low, self._reference(scene, i + 1, second))
        bf16 = pathtracer.Scene(self.arrays, dtype=torch.bfloat16,
                                device=self.device)
        out.update(self._target_off(self._target_film(bf16), scene))
        return out
