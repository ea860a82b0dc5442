"""One run of one benchmark cell, driven by the names in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix, entry or metric
is a file of its own under benchmark/, found by name:

    configs/<config>.json   the configuration (the `file` of its entry)
    traffic/<mix>.json      the mix: which entry it drives and how
    entries/<entry>.py      the driver of one entry point of the program
    metrics/<metric>.py     the reader of one metric
    limits/<workload>.json  the limit of each number the check compares

A run sets up the cell's driver, warms up, measures whole units for the
window (a unit started before the deadline runs to its end), reads the
metrics, frees the program's state and checks the units it kept against
the plain reference.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parents[1]
# Top-level module names that no run may hold once its window has closed:
# JAX and the JAX package, whose port is the program under test.
FORBIDDEN = ("jax", "jaxlib", "flax", "mobileraytracer_tpu")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path, name: str):
    """Imports the file `path` as a module named `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metrics_for(metrics, workload):
    return [m for m in metrics
            if "workloads" not in m or workload in m["workloads"]]


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    root: Path

    def entry(self):
        return load_module(
            self.root / "benchmark" / "entries" / f"{self.traffic['entry']}.py",
            f"benchmark_entry_{self.traffic['entry']}")

    def reader(self, metric: str):
        return load_module(self.root / "benchmark" / "metrics" / f"{metric}.py",
                           f"benchmark_metric_{metric}")


class UnitDriver:
    """What every entry's driver shares: the seed's keys, a seeded
    reservoir of the units that the check compares (and the last unit),
    and the recording of scene queries for the traced sub-window.  An
    entry subclasses it with `setup`, `unit`, `samples_per_unit`, `check`
    and `control`, and sets `self._restore` to undo its wrapping."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import torch
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.scene = self.camera = None
        self.queries = None      # armed by record_queries
        self._restore = lambda: None
        self.reseed(seed)

    def reseed(self, seed: int):
        """Starts over with another seed: new unit keys and reservoir."""
        self.seed = seed
        self._rng = random.Random(seed)
        self.kept, self.last = [], None
        self.key = None          # made on first use, once torch has loaded

    def unit_key(self, i: int):
        """The base key of unit i: fold_in(prng_key(seed), i)."""
        if self.key is None:
            from mobileraytracer_tpu_torch import sampling
            self._fold_in = sampling.fold_in
            self.key = sampling.prng_key(self.seed, self.device)
        return self._fold_in(self.key, i)

    def keep(self, rec: dict):
        """A seeded reservoir of traffic["check"]["reservoir"] units, and
        the last unit."""
        k = self.traffic["check"]["reservoir"]
        if len(self.kept) < k:
            self.kept.append(rec)
        elif self._rng.random() < k / (rec["i"] + 1):
            self.kept[self._rng.randrange(k)] = rec
        self.last = rec

    def units_to_check(self) -> list:
        recs = {r["i"]: r for r in self.kept}
        if self.traffic["check"].get("last") and self.last is not None:
            recs[self.last["i"]] = self.last
        return [recs[i] for i in sorted(recs)]

    def record_queries(self, on: bool):
        """Keeps each later scene query's rays (for the roofline count)."""
        self.queries = [] if on else None

    def release(self):
        """Undoes the wrapping and frees the program's scene before the
        reference runs."""
        import torch
        self._restore()
        self.scene = self.camera = None
        self.queries = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def cell(name: str, root: Path = ROOT, spec: Optional[dict] = None) -> Cell:
    spec = spec or load_spec(root)
    w = _named(spec["workloads"], name, "workload")
    c = _named(spec["configs"], w["config"], "configuration")
    bench = root / "benchmark"
    return Cell(
        workload=w,
        config=json.loads((root / c["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        end_to_end=_metrics_for(spec["end_to_end"], name),
        per_layer=_metrics_for(spec["per_layer"], name),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        root=root)


@dataclasses.dataclass
class Run:
    """What one run measured, for the metric readers."""
    cell: Cell
    window_start: float = 0.0
    units: list = dataclasses.field(default_factory=list)  # (start, end, work)
    samples_per_unit: int = 1
    setup_s: float = 0.0
    setup: dict = dataclasses.field(default_factory=dict)
    deltas: dict = dataclasses.field(default_factory=dict)  # counters
    trace: Optional[dict] = None
    device_kind: str = "cpu"
    driver: object = None

    @property
    def samples(self) -> int:
        return len(self.units) * self.samples_per_unit


def measure(unit: Callable[[int], float], seconds: float,
            clock: Callable[[], float] = time.perf_counter):
    """Runs unit(0), unit(1), ... while the clock is before the deadline;
    the unit in flight at the deadline runs to its end.  Returns (window
    start, [(start, end, work)])."""
    t0 = clock()
    deadline = t0 + seconds
    units = []
    i = 0
    while True:
        s = clock()
        if s >= deadline:
            break
        work = unit(i)
        units.append((s, clock(), work))
        i += 1
    return t0, units


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell_: Cell, seed: int, seconds: float, traced: bool, device,
             started: float, device_kind: str = "cpu",
             profile: Optional[Callable] = None) -> dict:
    """One run of the cell on `device`; `started` is the process's start
    on the perf_counter clock.  Returns the result line's fields, the
    numbers compared under "checks" and the Run under "run"."""
    metrics = cell_.per_layer if traced else cell_.end_to_end
    readers = {m["name"]: cell_.reader(m["name"]) for m in metrics}
    driver = cell_.entry().Driver(cell_.config, cell_.traffic, seed, device)
    run = Run(cell=cell_, device_kind=device_kind, driver=driver)
    run.setup = driver.setup()
    run.samples_per_unit = driver.samples_per_unit()
    counters = {n: r.counter for n, r in readers.items()
                if hasattr(r, "counter")}
    before = {n: c() for n, c in counters.items()}
    run.window_start, run.units = measure(driver.unit, seconds)
    run.setup_s = run.window_start - started
    run.deltas = {n: c() - before[n] for n, c in counters.items()}
    memory_peak = _memory_peak(device)
    if traced and profile is not None:
        run.trace = profile(driver, len(run.units))
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    driver.release()
    numbers = driver.check()
    checks = {k: {"value": numbers[k], "limit": cell_.limits[k]}
              for k in cell_.limits}
    correct = all(numbers[k] <= cell_.limits[k] for k in cell_.limits)
    return {"correct": correct, "attempted": len(run.units), "failed": 0,
            "metrics": values, "memory_peak_bytes": memory_peak,
            "checks": checks, "run": run}


def _memory_peak(device) -> int:
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(dev))
