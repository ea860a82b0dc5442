"""Checkpoint and resume of a progressive render and of a recovery run
(port of `mobileraytracer_tpu/utils/checkpoint.py`).

A render's state is the float32 film in lane order, the sample index, the
casted-ray total, the RenderConfig as JSON and any caller's extra arrays
(`extra_<name>` entries).  A recovery's state is
(params, torch.optim.Adam) stored as the JAX package stores its (params,
optax state) pytree: `leaf_i` in the order of JAX's leaves (the material
params by sorted name, then Adam's count, mu by name and nu by name), then
`opt_step` and `losses`.  Each package resumes the other's files, and
per-(pixel, sample) and per-step RNG keys make a resumed run bitwise
equal to an uninterrupted one.  A param that is not a material field
(the lights' "radiance", which the JAX package does not recover) goes
under its own names beside them (`radiance`, `radiance_mu`,
`radiance_nu`), so the leaves stay JAX's.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..types import Materials, RenderConfig


def save_render_state(path: str, accum: torch.Tensor, sample: int,
                      total_rays: int, config: RenderConfig,
                      extra: Optional[dict] = None) -> None:
    """Writes the render state; each entry of `extra` (arrays or tensors)
    goes in as `extra_<name>`."""
    payload = {
        "accum": accum.detach().cpu().numpy(),
        "sample": np.asarray(sample, np.int64),
        "total_rays": np.asarray(total_rays, np.int64),
        "config_json": np.frombuffer(
            json.dumps(dataclasses.asdict(config)).encode(), dtype=np.uint8),
    }
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = (v.detach().cpu().numpy()
                                 if torch.is_tensor(v) else np.asarray(v))
    np.savez(path, **payload)


def load_render_state(path: str) -> Tuple[np.ndarray, int, int,
                                          RenderConfig, dict]:
    """(accum as numpy, sample, total rays, config, extra): extra maps each
    `extra_<name>` entry's name to its numpy array."""
    with np.load(path) as data:
        config = RenderConfig(**json.loads(bytes(data["config_json"])))
        extra = {k[len("extra_"):]: data[k] for k in data.files
                 if k.startswith("extra_")}
        return (data["accum"], int(data["sample"]), int(data["total_rays"]),
                config, extra)


def _split(params: dict):
    """(the material fields' names, sorted: JAX's leaves; the others')."""
    fields = {f.name for f in dataclasses.fields(Materials)}
    names = sorted(params)
    return ([k for k in names if k in fields],
            [k for k in names if k not in fields])


def save_opt_state(path: str, state, step: int, losses) -> None:
    """Saves a recovery state (params, Adam), the step cursor and the
    loss history as one .npz in the JAX package's layout (the lights'
    radiance under its own names)."""
    from ..convert import adam_to_optax
    params, opt = state
    names, extra = _split(params)
    count, mu, nu = adam_to_optax(opt, params)
    value = {k: params[k].detach().cpu().numpy() for k in params}
    leaves = ([value[k] for k in names] + [count]
              + [mu[k] for k in names] + [nu[k] for k in names])
    payload = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    for k in extra:
        payload[k], payload[f"{k}_mu"], payload[f"{k}_nu"] = (value[k], mu[k],
                                                              nu[k])
    payload["opt_step"] = np.asarray(step, np.int64)
    payload["losses"] = np.asarray(losses, np.float64)
    np.savez(path, **payload)


def load_opt_state(path: str, template):
    """Restores a state saved by either package into `template`, a fresh
    (params, Adam) state whose params give the names and device.  Returns
    ((params, Adam), step, losses), or None when no file exists."""
    from ..convert import adam_from_optax
    if not os.path.exists(path):
        return None
    params, opt = template
    names, extra = _split(params)
    n = len(names)
    with np.load(path) as data:
        leaf = [data[f"leaf_{i}"] for i in range(3 * n + 1)]
        value = dict(zip(names, leaf[:n]))
        mu = dict(zip(names, leaf[n + 1:2 * n + 1]))
        nu = dict(zip(names, leaf[2 * n + 1:]))
        for k in extra:
            value[k], mu[k], nu[k] = data[k], data[f"{k}_mu"], data[f"{k}_nu"]
        step, losses = int(data["opt_step"]), list(data["losses"])
    with torch.no_grad():
        for k, a in value.items():
            params[k].copy_(torch.from_numpy(np.asarray(a)))
    adam_from_optax(opt, params, leaf[n], mu, nu)
    return (params, opt), step, losses
