"""The port's measuring commands, python -m mobileraytracer_tpu_torch.bench
and .bench_grad: the JAX scripts' flags plus --cpu, one JSON line each,
and the work they time is the port's render_frame and vertex_grad."""
import json
import re
import subprocess
import sys

import pytest
import torch

from mobileraytracer_tpu_torch import bench, bench_grad, sampling, scenes
from mobileraytracer_tpu_torch import constants as C
from mobileraytracer_tpu_torch import renderer as trend
from mobileraytracer_tpu_torch.bench_scenes import conference_proxy
from mobileraytracer_tpu_torch.diff.geom import vertex_grad
from mobileraytracer_tpu_torch.ops import block_traversal
from mobileraytracer_tpu_torch.types import RenderConfig
from test_torch_port_imports import ROOT

torch.set_num_threads(2)


def _options(help_text):
    return set(re.findall(r"(--[a-z0-9][a-z0-9-]*)", help_text)) - {"--help"}


@pytest.mark.parametrize("script, port", [("bench.py", bench),
                                          ("bench_grad.py", bench_grad)])
def test_flags_are_the_jax_scripts_plus_cpu(script, port):
    jax_help = subprocess.run([sys.executable, script, "--help"], cwd=ROOT,
                              capture_output=True, text=True, timeout=120)
    assert jax_help.returncode == 0, jax_help.stderr
    want = _options(jax_help.stdout)
    assert want
    assert _options(port.build_parser().format_help()) == want | {"--cpu"}


def _line(out):
    lines = out.strip().splitlines()
    return json.loads(lines[-1]), lines


def test_bench_line_and_rays_per_frame(capsys):
    rays, dt, out = bench.main(["--cpu", "--size", "16", "--reps", "2"])
    line, lines = _line(capsys.readouterr().out)
    assert len(lines) == 1
    assert line["metric"] == "rays_per_second" and line["unit"] == "rays/s"
    assert line["vs_baseline"] is None and line["device"] == "cpu"
    assert line["value"] == rays / dt > 0
    assert line["rays_per_frame"] == rays
    assert line["seconds_per_frame"] == dt

    scene, cam, _ = conference_proxy()
    scene = block_traversal.build(scene, device="cpu")
    cfg = RenderConfig(width=16, height=16, shader=C.SHADER_WHITTED,
                       accelerator=C.ACC_BVH, nee_share=128,
                       nee_share_secondary=True)
    key = sampling.prng_key(0)
    ref = [trend.render_frame(scene, cam, cfg, sampling.fold_in(key, i))
           for i in range(2)]
    assert rays == (int(ref[0]["rays"]) + int(ref[1]["rays"])) // 2
    assert rays > 16 * 16
    assert torch.equal(out["image"], ref[1]["image"])


def test_bench_grad_line_and_loss(capsys):
    loss, grads, dt, cfg = bench_grad.main(["--cpu", "--small", "--size",
                                            "16"])
    line, lines = _line(capsys.readouterr().out)
    assert len(lines) == 1            # --small prints no edge count
    assert line["metric"] == "mpixel_grads_per_second"
    assert line["unit"] == "Mpixel-grads/s"
    assert line["value"] == line["vs_baseline"] == 16 * 16 / dt / 1e6
    assert line["seconds_per_call"] == dt
    assert line["peak_memory_bytes"] is None and line["device"] == "cpu"

    scene, cam = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    want = RenderConfig(width=16, height=16, shader=C.SHADER_WHITTED,
                        accelerator=C.ACC_NAIVE, scene_id=C.SCENE_CORNELL2)
    assert cfg == want
    ref_loss, ref_grads = vertex_grad(
        scene, cam, want, sampling.fold_in(sampling.prng_key(0), 4),
        edge_samples=8)
    assert torch.equal(loss, ref_loss)
    for k in ("va", "vb", "vc"):
        assert torch.equal(grads[k], ref_grads[k]), k


def test_commands_need_the_card_unless_cpu():
    """Without --cpu both commands run on the card: on a machine without
    one they raise before they measure anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py runs the commands")
    for mod in ("bench", "bench_grad"):
        run = subprocess.run(
            [sys.executable, "-m", f"mobileraytracer_tpu_torch.{mod}"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert run.returncode != 0 and not run.stdout
        assert "torch.cuda.is_available() is false" in run.stderr
