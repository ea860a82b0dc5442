"""Observability: phase timers, run metrics, structured JSONL logging
(port of `mobileraytracer_tpu/utils/metrics.py`).

Mirrors the reference's measurement surface (SURVEY.md §5.1/§5.5):
phase latencies for load / scene-fill / shader+accelerator build / render
(reference C_wrapper.cpp:103-130, 248-251), the casted-ray throughput
metric "Total Millions rays per second" (C_wrapper.cpp:256), and the live
stats-line fields (RenderTask.kt:169-260) — here as a metrics dict that
can be printed and appended to a JSONL file.
"""
from __future__ import annotations

import json
import logging
import time
from contextlib import contextmanager
from typing import Dict, Optional

logger = logging.getLogger("mobileraytracer_tpu_torch")


class PhaseTimer:
    """Named wall-clock phases (loading / filling / creating / rendering)."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0)

    def log(self):
        for name, secs in self.seconds.items():
            logger.info("Time in %s: %.3f secs", name, secs)


class RunMetrics:
    """Accumulates per-run metrics and emits them as one JSON object."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self.data: Dict[str, object] = {}
        self.jsonl_path = jsonl_path

    def update(self, **kwargs):
        self.data.update(kwargs)

    def rays_per_second(self, total_rays: int, render_seconds: float):
        rps = total_rays / max(render_seconds, 1e-12)
        self.update(total_rays=total_rays, render_seconds=render_seconds,
                    rays_per_second=rps,
                    mrays_per_second=rps / 1e6)
        # The reference's log line (C_wrapper.cpp:256).
        logger.info("Total Millions rays per second = %s", rps / 1e6)
        return rps

    def emit(self) -> str:
        line = json.dumps(self.data)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(line + "\n")
        return line
