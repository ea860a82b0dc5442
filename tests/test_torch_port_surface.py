"""The port's public surface against the JAX package's: every public
top-level name of every module of mobileraytracer_tpu/ (found by reading
the source, so nothing of JAX is imported) has a counterpart in the port,
either the same name in the port module at the same path or an entry of
the map below, which names the port's counterpart or the decision that
leaves the name out.  Then parameter by parameter: every parameter of
every public JAX function, and of every public method of a public class
(properties included, which take none), is a parameter of the same name
of its counterpart, or an entry of PARAM_COUNTERPARTS, which names the
port's parameter and why it differs.  A new public JAX name or parameter
without a counterpart fails, and so does an entry whose JAX name or port
target is gone."""
import ast
import importlib
import inspect

import pytest
import torch

from mobileraytracer_tpu import sampling as jsampling
from mobileraytracer_tpu_torch import sampling
from test_torch_port_imports import ROOT

torch.set_num_threads(2)

JAX_PKG = ROOT / "mobileraytracer_tpu"
PORT = "mobileraytracer_tpu_torch"
DECISIONS = "ROADMAP.md, \"Decisions that stand\""

# JAX name (module path under mobileraytracer_tpu, then the name) -> the
# port's counterpart (module path under mobileraytracer_tpu_torch, then the
# name) where it sits under another name or in another module.
COUNTERPARTS = {
    "types.BVH": "ops.bvh.BVHNodes",
    "sampling.uniform": "threefry.uniform",
    # The Pallas drivers: the block traversal's drivers and scene queries,
    # and the kernels' wrappers beneath them.
    "ops.pallas_bvh.PallasGrid": "ops.block_traversal.BlockGrid",
    "ops.pallas_bvh.build": "ops.block_traversal.build",
    "ops.pallas_bvh.build_blocks": "ops.block_traversal.build_blocks",
    "ops.pallas_bvh.traverse": "ops.block_traversal.traverse",
    "ops.pallas_bvh.traverse_tilemt": "ops.block_traversal.traverse_tilemt",
    "ops.pallas_bvh.traverse_tile": "ops.block_traversal.traverse_tile",
    "ops.pallas_bvh.traverse_resident":
        "ops.block_traversal.traverse_resident",
    "ops.pallas_bvh.intersect_scene_pallas":
        "ops.block_traversal.intersect_scene_blocks",
    "ops.pallas_bvh.occluded_pallas": "ops.block_traversal.occluded_blocks",
    "ops.pallas_bvh.DEFAULT_BPS": "ops.block_traversal.DEFAULT_BPS",
    "ops.pallas_bvh.DEFAULT_MODE": "ops.block_traversal.DEFAULT_MODE",
    "ops.pallas_bvh.DEFAULT_TOP_M": "ops.block_traversal.DEFAULT_TOP_M",
    "ops.pallas_bvh.DEFAULT_TOP_S": "ops.block_traversal.DEFAULT_TOP_S",
    "ops.pallas_bvh.TILE_TOP_M": "ops.block_traversal.TILE_TOP_M",
    "ops.pallas_bvh.TILE_TOP_S": "ops.block_traversal.TILE_TOP_S",
    "ops.pallas_bvh.GROUP": "ops.kernels.GROUP",
    "ops.pallas_bvh.LANES": "ops.kernels.LANES",
    "ops.pallas_bvh.ST": "ops.kernels.ST",
    "ops.pallas_bvh.TILE": "ops.kernels.TILE",
    "ops.pallas_bvh.NBP": "ops.kernels.NBP",
    "ops.pallas_bvh.SHADOW_SEL": "ops.block_traversal.SHADOW_SEL",
}

# JAX parameter ("module.function.parameter", or "module.Class.method.
# parameter") -> (the port counterpart's parameter, why it is renamed).
_BATCHED = ("the port's samplers take one threefry key per lane (a (B, 2) "
            "tensor), where JAX's take one key and draw a batch")
PARAM_COUNTERPARTS = {
    "sampling.uniform.key": ("keys", _BATCHED),
    "sampling.uniform.shape": ("n", "the number of draws per lane; the "
                                    "batch is the keys' first axis"),
    "sampling.cosine_sample_hemisphere.key": ("keys", _BATCHED),
    "sampling.pick_light.key": ("keys", _BATCHED),
    "sampling.sample_triangle_point.key": ("keys", _BATCHED),
}

# JAX module or name -> the decision that leaves it out of the port.
LEFT_OUT = {
    "__graft_entry__": f"its entry() and dryrun_multichip stay JAX-only; "
                       f"chip_smoke.py phases 4 and 11 play their part "
                       f"({DECISIONS})",
    "ops.grid.MAX_ITEMS_PER_CELL_TEST": f"defined at grid.py:37 and read "
                                        f"nowhere in the JAX package; the "
                                        f"port's DDA tests each cell's "
                                        f"whole item list in one batch "
                                        f"({DECISIONS})",
}


def public_names(source, is_init=False):
    """The public names a module's source defines at its top level
    (functions, classes, assigned names, and in a package's __init__ its
    imported names), including those inside top-level if/try blocks."""
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names.update(e.id for t in targets for e in ast.walk(t)
                             if isinstance(e, ast.Name))
            elif is_init and isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in node.names)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                for part in (node.body, node.orelse, node.finalbody,
                             *(h.body for h in node.handlers)):
                    visit(part)

    visit(ast.parse(source).body)
    return {n for n in names if not n.startswith("_")}


def jax_modules():
    """{module path under mobileraytracer_tpu ("" for the package): public
    names}, plus the repository's __graft_entry__."""
    mods = {}
    for p in sorted(JAX_PKG.rglob("*.py")):
        parts = list(p.relative_to(JAX_PKG).with_suffix("").parts)
        is_init = parts[-1] == "__init__"
        mods[".".join(parts[:-1] if is_init else parts)] = public_names(
            p.read_text(), is_init)
    mods["__graft_entry__"] = public_names(
        (ROOT / "__graft_entry__.py").read_text())
    return mods


def port_attr(path):
    """The port's object at "module.path.name" (or the module itself at
    "module.path"), or None."""
    mod, _, name = path.rpartition(".")
    for module, attr in ((path, None), (mod, name)):
        try:
            m = importlib.import_module(f"{PORT}.{module}" if module
                                        else PORT)
        except ModuleNotFoundError:
            continue
        return m if attr is None else getattr(m, attr, None)
    return None


def unmatched(module, names, counterparts, left_out):
    """The public names of JAX module `module` with no counterpart."""
    if module in left_out:
        return []
    missing = []
    for name in sorted(names):
        qual = f"{module}.{name}" if module else name
        if qual in left_out:
            continue
        target = counterparts.get(qual, qual)
        if port_attr(target) is None:
            missing.append(f"{qual} (looked for {PORT}.{target})")
    return missing


def stale(mods, counterparts, left_out):
    """Map entries whose JAX name is gone, whose port target is gone, or
    that leave out a name the port has at the same path."""
    def in_jax(qual):
        if qual in mods:
            return True
        mod, _, name = qual.rpartition(".")
        return name in mods.get(mod, ())

    bad = [f"{q}: no such public JAX name" for q in (*counterparts,
                                                      *left_out)
           if not in_jax(q)]
    bad += [f"{q} -> {t}: no such port name" for q, t in counterparts.items()
            if port_attr(t) is None]
    bad += [f"{q}: left out, but the port has it" for q in left_out
            if port_attr(q) is not None]
    return bad


MODULES = jax_modules()


@pytest.mark.parametrize("module", sorted(MODULES))
def test_every_public_jax_name_has_a_counterpart(module):
    assert MODULES[module] or module == "ops", module
    missing = unmatched(module, MODULES[module], COUNTERPARTS, LEFT_OUT)
    assert not missing, missing


def test_every_map_entry_is_live():
    assert "ops.pallas_bvh" in MODULES and "__graft_entry__" in MODULES
    assert not stale(MODULES, COUNTERPARTS, LEFT_OUT)


def test_the_check_fails_on_an_unmapped_name_and_a_stale_entry():
    """A JAX module that gains a public name the port lacks, a map entry
    whose target is gone, one whose JAX name is gone, and a left-out name
    the port has: each is reported."""
    src = ("import numpy as np\n"
           "from .x import hidden\n"
           "NEW_KNOB = 1\n"
           "ray_key = None\n"
           "def _private():\n    pass\n"
           "if True:\n    def new_entry_point():\n        pass\n")
    names = public_names(src)
    assert names == {"NEW_KNOB", "ray_key", "new_entry_point"}
    assert public_names(src, is_init=True) == names | {"np", "hidden"}
    missing = unmatched("sampling", names, COUNTERPARTS, LEFT_OUT)
    assert [m.split()[0] for m in missing] == ["sampling.NEW_KNOB",
                                               "sampling.new_entry_point"]
    assert not unmatched("sampling", names, COUNTERPARTS,
                         {**LEFT_OUT, "sampling.NEW_KNOB": "why",
                          "sampling.new_entry_point": "why"})
    mods = {**MODULES, "sampling": MODULES["sampling"] | names}
    bad = stale(mods, {**COUNTERPARTS,
                       "types.BVH": "ops.bvh.NoSuchNodes",
                       "sampling.gone": "threefry.uniform"},
                {**LEFT_OUT, "sampling.ray_key": "why"})
    assert bad == ["sampling.gone: no such public JAX name",
                   "types.BVH -> ops.bvh.NoSuchNodes: no such port name",
                   "sampling.ray_key: left out, but the port has it"]


def test_purpose_tags_are_the_jax_packages():
    tags = {n for n in MODULES["sampling"] if n.startswith("PURPOSE_")}
    assert len(tags) == 6
    for name in sorted(tags):
        assert getattr(sampling, name) == getattr(jsampling, name), name
    assert sorted(getattr(sampling, n) for n in tags) == list(range(6))


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------

def _params(args: ast.arguments):
    names = [a.arg for a in args.posonlyargs + args.args]
    if args.vararg:
        names.append("*" + args.vararg.arg)
    names += [a.arg for a in args.kwonlyargs]
    if args.kwarg:
        names.append("**" + args.kwarg.arg)
    return names


def public_signatures(source):
    """{qualified name: parameter names} of the public functions a
    module's source defines at its top level (inside top-level if/try
    blocks too) and of the public methods and properties of its public
    classes ("Class.method"; self or cls left out; *args and **kwargs
    with their stars)."""
    sigs = {}

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not node.name.startswith("_"):
                    sigs[node.name] = _params(node.args)
            elif isinstance(node, ast.ClassDef):
                if node.name.startswith("_"):
                    continue
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)) \
                            and not sub.name.startswith("_"):
                        ps = _params(sub.args)
                        static = any(isinstance(dec, ast.Name)
                                     and dec.id == "staticmethod"
                                     for dec in sub.decorator_list)
                        sigs[f"{node.name}.{sub.name}"] = (
                            ps if static else ps[1:])
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                for part in (node.body, node.orelse, node.finalbody,
                             *(h.body for h in node.handlers)):
                    visit(part)

    visit(ast.parse(source).body)
    return sigs


def jax_signatures():
    """{module path under mobileraytracer_tpu: public_signatures}."""
    sigs = {}
    for p in sorted(JAX_PKG.rglob("*.py")):
        parts = list(p.relative_to(JAX_PKG).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        sigs[".".join(parts)] = public_signatures(p.read_text())
    return sigs


def port_target(module, name, counterparts):
    """The port's object for JAX's `name` ("f" or "Class.method") of
    `module`: the counterpart of the function or class, then the method
    on it (a property object for a property).  None when it is missing."""
    head, _, meth = name.partition(".")
    qual = f"{module}.{head}" if module else head
    obj = port_attr(counterparts.get(qual, qual))
    if obj is None or not meth:
        return obj
    return inspect.getattr_static(obj, meth, None)


def port_params(obj):
    """The parameter names of a port function or method (self and cls
    left out, stars kept); [] for a property."""
    if isinstance(obj, property):
        return []
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    names = []
    for p in inspect.signature(obj).parameters.values():
        names.append({p.VAR_POSITIONAL: "*",
                      p.VAR_KEYWORD: "**"}.get(p.kind, "") + p.name)
    return names[1:] if names and names[0] in ("self", "cls") else names


def unmatched_params(module, sigs, counterparts, left_out, param_map):
    """The public JAX functions and methods of `module` whose port
    counterpart is missing, and their parameters that have no counterpart
    parameter."""
    if module in left_out:
        return []
    missing = []
    for name, params in sorted(sigs.items()):
        qual = f"{module}.{name}" if module else name
        if any(qual == q or qual.startswith(q + ".") for q in left_out):
            continue
        obj = port_target(module, name, counterparts)
        if obj is None:
            missing.append(f"{qual}: no port counterpart")
            continue
        have = port_params(obj)
        for p in params:
            want = param_map.get(f"{qual}.{p.lstrip('*')}", (p,))[0]
            if want not in have:
                missing.append(f"{qual}({p}): the port's has {have}")
    return missing


def stale_params(sigs, counterparts, param_map):
    """PARAM_COUNTERPARTS entries whose JAX parameter or port parameter is
    gone, or that rename a parameter the port has under JAX's name."""
    bad = []
    for key, (port_name, _) in sorted(param_map.items()):
        qual, _, param = key.rpartition(".")
        module, name = _split(qual, sigs)
        params = [p.lstrip("*") for p in sigs.get(module, {}).get(name, ())]
        if param not in params:
            bad.append(f"{key}: no such JAX parameter")
            continue
        obj = port_target(module, name, counterparts)
        have = port_params(obj) if obj is not None else []
        if port_name not in have:
            bad.append(f"{key} -> {port_name}: no such port parameter")
        elif param in have:
            bad.append(f"{key}: renamed, but the port has {param}")
    return bad


def _split(qual, sigs):
    """("module", "name") of a qualified JAX function or method."""
    for module in sorted(sigs, key=len, reverse=True):
        if module and qual.startswith(module + "."):
            return module, qual[len(module) + 1:]
    return "", qual


SIGNATURES = jax_signatures()


@pytest.mark.parametrize("module", sorted(SIGNATURES))
def test_every_jax_parameter_has_a_counterpart(module):
    missing = unmatched_params(module, SIGNATURES[module], COUNTERPARTS,
                               LEFT_OUT, PARAM_COUNTERPARTS)
    assert not missing, missing


def test_every_param_map_entry_is_live():
    assert "ops.block_bvh" in SIGNATURES and SIGNATURES["ops.block_bvh"]
    assert not stale_params(SIGNATURES, COUNTERPARTS, PARAM_COUNTERPARTS)
    for key, (_, why) in PARAM_COUNTERPARTS.items():
        assert why, key


def test_the_param_check_fails_on_a_missing_parameter_and_a_stale_entry():
    """A JAX function that gains a parameter the port lacks, a method
    without a port counterpart, and map entries whose JAX parameter is
    gone, whose port parameter is gone, or that rename a parameter the
    port has under JAX's name: each is reported.  Properties, static
    methods, self and the stars of *args and **kwargs are read right."""
    src = ("def uniform(key, shape, minval=0.0, *, new_knob=1, **kw):\n"
           "    pass\n"
           "def _private(x):\n    pass\n"
           "class Hit:\n"
           "    @property\n    def missed(self):\n        pass\n"
           "    @staticmethod\n    def make(n, *rest):\n        pass\n"
           "    def gone(self, x):\n        pass\n")
    sigs = public_signatures(src)
    assert sigs == {"uniform": ["key", "shape", "minval", "new_knob",
                                "**kw"],
                    "Hit.missed": [], "Hit.make": ["n", "*rest"],
                    "Hit.gone": ["x"]}
    missing = unmatched_params("sampling", {"uniform": sigs["uniform"]},
                               COUNTERPARTS, LEFT_OUT, PARAM_COUNTERPARTS)
    assert [m.split(":")[0] for m in missing] == [
        "sampling.uniform(minval)", "sampling.uniform(new_knob)",
        "sampling.uniform(**kw)"]
    missing = unmatched_params("types", {"Hit.missed": [],
                                         "Hit.gone": ["x"]},
                               COUNTERPARTS, LEFT_OUT, PARAM_COUNTERPARTS)
    assert missing == ["types.Hit.gone: no port counterpart"]
    mods = {**SIGNATURES, "sampling": {**SIGNATURES["sampling"],
                                       "uniform": sigs["uniform"]}}
    bad = stale_params(mods, COUNTERPARTS, {
        **PARAM_COUNTERPARTS,
        "sampling.uniform.gone": ("keys", "why"),
        "sampling.uniform.minval": ("no_such", "why"),
        "sampling.pick_light.num_lights": ("num_lights", "why")})
    assert bad == [
        "sampling.pick_light.num_lights: renamed, but the port has "
        "num_lights",
        "sampling.uniform.gone: no such JAX parameter",
        "sampling.uniform.minval -> no_such: no such port parameter"]
