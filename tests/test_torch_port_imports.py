"""The PyTorch port imports without jax or flax installed."""
import json
import pathlib
import subprocess
import sys

import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "mobileraytracer_tpu_torch"


def _modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax():
    mods = _modules()
    assert len(mods) > 15
    assert {"mobileraytracer_tpu_torch.bench",
            "mobileraytracer_tpu_torch.bench_grad",
            "mobileraytracer_tpu_torch.diff.geom",
            "mobileraytracer_tpu_torch.ops.block_bvh",
            "mobileraytracer_tpu_torch.parallel.mesh",
            "mobileraytracer_tpu_torch.parallel.recover",
            "mobileraytracer_tpu_torch.sweep",
            "mobileraytracer_tpu_torch.utils.checkpoint"} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['flax'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.startswith('mobileraytracer_tpu.')"
            " or m == 'mobileraytracer_tpu']\n"
            "assert not bad, bad\n"
            "print('ok', len(" + repr(mods) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_jax_import_in_port_sources():
    for p in PKG.rglob("*.py"):
        text = p.read_text()
        for bad in ("import jax", "from jax", "import flax", "from flax",
                    "mobileraytracer_tpu.", "from mobileraytracer_tpu "):
            assert bad not in text, f"{p}: {bad}"


def test_cli_runs_as_module_without_jax():
    """`python -m mobileraytracer_tpu_torch.cli --cpu` renders and prints
    its metrics line with jax and the JAX package unimportable."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['flax'] = None\n"
            "sys.modules['mobileraytracer_tpu'] = None\n"
            "sys.argv = ['cli', '--cpu', '--width', '16', '--height', '16',"
            " '--acc', '1']\n"
            "runpy.run_module('mobileraytracer_tpu_torch.cli',"
            " run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["total_rays"] >= 16 * 16
    assert metrics["rays_per_second"] > 0
