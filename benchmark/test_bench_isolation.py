"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program."""
import ast
import json
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "mobileraytracer_tpu"}


def imported_top_names(path: pathlib.Path) -> set:
    """Top-level names of the absolute imports of a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 15
    for p in files:
        bad = imported_top_names(p) & JAX_NAMES
        assert not bad, f"{p}: imports {bad}"


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for p in files:
        names = imported_top_names(p)
        assert "mobileraytracer_tpu_torch" not in names, p
        assert names <= {"__future__", "math", "numpy", "torch"}, \
            (p, names)


def test_a_harness_import_loads_no_jax():
    code = f"""
import json, sys
from benchmark import calibrate, harness, roofline, run, trace
from benchmark import program_scene
spec = harness.load_spec()
for w in spec["workloads"]:
    cell = harness.cell(w["name"])
    cell.entry()
    for m in cell.end_to_end + cell.per_layer:
        cell.reader(m["name"])
import mobileraytracer_tpu_torch.renderer
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_level_names():
    from benchmark import harness
    mods = {"mobileraytracer_tpu_torch": 1, "mobileraytracer_tpu_torch.ops":
            1, "jaxtyping": 1, "torch": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "mobileraytracer_tpu.ops": 1})
    assert harness.forbidden_modules(mods) == ["jax.numpy",
                                               "mobileraytracer_tpu.ops"]
