"""The port's command line against the JAX package's: the same arguments,
named and in the reference's 15-value positional form, at 32x32 on the
CPU, on a builtin scene and on an OBJ the test writes.  Ray counts equal,
PNGs within one 8-bit step on 99.9% of pixels, and the same metrics keys."""
import json

import numpy as np
import pytest
import torch

from mobileraytracer_tpu import cli as jcli
from mobileraytracer_tpu_torch import cli
from test_torch_loaders import _textured_obj

torch.set_num_threads(2)

PIL = pytest.importorskip("PIL.Image")


def _run(main, args, tmp_path, tag):
    """Runs one CLI with --cpu, its PNG to <tag>.png and its metrics to
    <tag>.jsonl; returns (metrics, image as uint8)."""
    out, metrics = tmp_path / f"{tag}.png", tmp_path / f"{tag}.jsonl"
    if args[0].startswith("--"):
        args = args + ["--out", str(out)]
    else:                                     # SHOWIMAGE slot = out path
        args = args[:-1] + [str(out)]
    assert main(args + ["--cpu", "--metrics-jsonl", str(metrics)]) == 0
    (line,) = metrics.read_text().splitlines()
    return json.loads(line), np.asarray(PIL.open(out))


def _compare(args, tmp_path):
    tm, timg = _run(cli.main, args, tmp_path, "port")
    jm, jimg = _run(jcli.main, args, tmp_path, "jax")
    assert sorted(tm) == sorted(jm)
    assert tm["total_rays"] == jm["total_rays"] > 0
    assert tm["rays_per_second"] > 0
    for k in ("shader", "scene", "spp", "spl", "width", "height",
              "accelerator", "repeats", "triangles", "lights", "materials",
              "textures", "builtin"):
        assert tm.get(k) == jm.get(k), k
    assert timg.shape == jimg.shape == (32, 32, 3)
    close = (np.abs(timg.astype(int) - jimg.astype(int)) <= 1).all(-1)
    assert close.mean() >= 0.999
    return tm


def test_positional_builtin_scene(tmp_path):
    """THREADS SHADER SCENE SPP SPL WIDTH HEIGHT ACC REP OBJ MTL CAM PRINT
    ASYNC SHOWIMAGE: cornell, Whitted, 1 spp over the block BVH."""
    m = _compare(["1", "1", "0", "1", "1", "32", "32", "3", "1", "-", "-",
                  "-", "true", "false", "out.png"], tmp_path)
    assert m["builtin"] == 0 and m["accelerator"] == 3


def test_named_obj_scene(tmp_path, capsys):
    """An OBJ+MTL with a texture and an emissive face, Whitted at 2 spp and
    2 light samples over the naive scan; the metrics line is printed."""
    obj = _textured_obj(tmp_path)
    m = _compare(["--scene", "4", "--obj", obj, "--shader", "1", "--spp",
                  "2", "--spl", "2", "--width", "32", "--height", "32",
                  "--acc", "1"], tmp_path)
    assert (m["triangles"], m["lights"], m["textures"]) == (2, 1, 1)
    assert m["parse_seconds"] > 0 and m["fill_seconds"] > 0
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert m in printed


def test_png_skipped_without_pil(tmp_path, monkeypatch, caplog):
    """Where PIL is missing the render still runs
    and the PNG is skipped with a warning."""
    import logging
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    out = tmp_path / "x.png"
    with caplog.at_level(logging.WARNING, logger="mobileraytracer_tpu_torch"):
        assert cli.main(["--cpu", "--width", "16", "--height", "16",
                         "--acc", "1", "--quiet", "--out", str(out)]) == 0
    assert not out.exists()
    assert any("PIL missing" in r.message for r in caplog.records)


def test_positional_contract_errors(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["1", "1", "0"])
    with pytest.raises(SystemExit, match="no --obj"):
        cli.main(["--scene", "4", "--cpu"])


def test_card_is_the_default(tmp_path):
    """Without --cpu the CLI renders on the card, and without one it
    raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py drives the CLI")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--width", "16", "--height", "16", "--quiet"])
