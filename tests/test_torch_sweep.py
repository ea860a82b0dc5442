"""The port's sweep, python -m mobileraytracer_tpu_torch.sweep, against the
JAX package's scripts/sweep.py at 16x16 on the CPU: the same
configurations, ray counts and .dat file, with the JAX Renderer's ray
counts taken from the JAX sweep's own Renderers."""
import contextlib
import io
import re
import runpy
import subprocess
import sys

import pytest
import torch

from mobileraytracer_tpu import renderer as jrend
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import sweep
from test_torch_port_imports import ROOT

torch.set_num_threads(2)

FLAGS = ["--cpu", "--size", "16", "--reps", "1"]
SCENES = (C.SCENE_CORNELL, C.SCENE_CORNELL2)
SHADERS = (C.SHADER_WHITTED, C.SHADER_PATHTRACER)
CONFIGS = [(s, sh, acc) for s in SCENES for sh in SHADERS
           for acc in (C.ACC_NAIVE, C.ACC_BVH)]


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Both sweeps at their default scenes, shaders and accelerators:
    {"port"/"jax": (.dat text, stdout lines)}, the port's rows by
    configuration, and the JAX Renderer's total_rays after the last
    reset() + render() of each configuration."""
    tmp = tmp_path_factory.mktemp("sweep")
    jax_rays = {}

    class Recorded(jrend.Renderer):
        def render(self, *args, **kwargs):
            img = super().render(*args, **kwargs)
            c = self.config
            jax_rays[(c.scene_id, c.shader, c.accelerator)] = self.total_rays
            return img

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrend, "Renderer", Recorded)
        mp.setattr(sys, "argv", ["sweep.py", *FLAGS, "--out",
                                 str(tmp / "jax.dat")])
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            runpy.run_path(str(ROOT / "scripts" / "sweep.py"),
                           run_name="__main__")
        out["jax"] = ((tmp / "jax.dat").read_text(),
                      buf.getvalue().splitlines())
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rows = sweep.main([*FLAGS, "--out", str(tmp / "port.dat")])
    out["port"] = ((tmp / "port.dat").read_text(),
                   buf.getvalue().splitlines())
    by_config = {(r.scene, r.shader, r.accelerator): r for r in rows}
    return out, by_config, jax_rays, tmp


@pytest.mark.parametrize("config", CONFIGS)
def test_ray_counts_equal_the_jax_renderers(sweeps, config):
    _, rows, jax_rays, _ = sweeps
    assert list(rows) == CONFIGS
    assert rows[config].total_rays == jax_rays[config] > 16 * 16


@pytest.mark.parametrize("scene, shader", [(s, sh) for s in SCENES
                                           for sh in SHADERS])
def test_bvh_rows_equal_the_jax_naive_rows(sweeps, scene, shader):
    """The JAX Renderer's ACC_BVH on a CPU is ops/block_bvh.py, whose
    budget can miss hits; the port's block traversal is exact, so its
    ACC_BVH rows equal the naive scan's."""
    _, rows, jax_rays, _ = sweeps
    assert (rows[(scene, shader, C.ACC_BVH)].total_rays
            == jax_rays[(scene, shader, C.ACC_NAIVE)])


def _masked(lines, tmp):
    return [re.sub(r"\d+\.\d{3}", "X", ln).replace(str(tmp), "DIR")
            .replace("jax.dat", "F").replace("port.dat", "F") for ln in lines]


def test_dat_file_and_lines_are_the_jax_sweeps(sweeps):
    out, rows, _, tmp = sweeps
    (port, port_lines), (jax, jax_lines) = out["port"], out["jax"]
    port, jax = port.splitlines(), jax.splitlines()
    assert port[0] == jax[0] == sweep.HEADER.rstrip("\n")
    assert len(port) == len(jax) == 1 + len(CONFIGS)
    fmt = re.compile(r"^(-?\d+ ){8}\d+\.\d{4} \d+\.\d{4}$")
    for p, j, row in zip(port[1:], jax[1:], rows.values()):
        assert fmt.match(p) and fmt.match(j), (p, j)
        assert p.split()[:8] == j.split()[:8]
        assert p.split()[:8] == [str(x) for x in row[:8]]
        assert p.split()[8:] == [f"{row.render_s:.4f}", f"{row.mrays_s:.4f}"]
    assert _masked(port_lines, tmp) == _masked(jax_lines, tmp)
    assert port_lines[-1].startswith("wrote ")


def test_needs_the_card_unless_cpu(tmp_path):
    """Without --cpu the sweep runs on the card: on a machine without one
    it raises before it renders or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py runs the sweep")
    with pytest.raises(RuntimeError, match="is_available"):
        sweep.sweep([0], [1], [1], 16, 1, 1, 1)
    run = subprocess.run(
        [sys.executable, "-m", "mobileraytracer_tpu_torch.sweep", "--out",
         str(tmp_path / "s.dat")], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert run.returncode != 0 and not run.stdout
    assert "torch.cuda.is_available() is false" in run.stderr
    assert not (tmp_path / "s.dat").exists()


def test_sweep_runs_as_module_without_jax(tmp_path):
    """python -m mobileraytracer_tpu_torch.sweep --cpu writes its eight
    rows with jax and the JAX package unimportable."""
    path = tmp_path / "s.dat"
    code = ("import runpy, sys, torch\n"
            "torch.set_num_threads(2)\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['flax'] = None\n"
            "sys.modules['mobileraytracer_tpu'] = None\n"
            f"sys.argv = ['sweep', *{FLAGS!r}, '--out', {str(path)!r}]\n"
            "runpy.run_module('mobileraytracer_tpu_torch.sweep',"
            " run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 + len(CONFIGS)
    assert lines[-1] == f"wrote {path}"
    rows = path.read_text().splitlines()
    assert rows[0] == sweep.HEADER.rstrip("\n") and len(rows) == 9
    assert [tuple(map(int, r.split()[:3])) for r in rows[1:]] == CONFIGS
