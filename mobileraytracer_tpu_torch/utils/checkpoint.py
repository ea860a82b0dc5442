"""Checkpoint and resume of a progressive render (port of the render-state
half of `mobileraytracer_tpu/utils/checkpoint.py`).

The state is the float32 film in lane order, the sample index, the
casted-ray total and the RenderConfig as JSON, in one .npz with the JAX
package's keys, so each package resumes the other's file.  Per-(pixel,
sample) RNG keys make a resumed render bitwise equal to an uninterrupted
one.  The optimizer state waits for the port's gradients.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np
import torch

from ..types import RenderConfig


def save_render_state(path: str, accum: torch.Tensor, sample: int,
                      total_rays: int, config: RenderConfig) -> None:
    payload = {
        "accum": accum.detach().cpu().numpy(),
        "sample": np.asarray(sample, np.int64),
        "total_rays": np.asarray(total_rays, np.int64),
        "config_json": np.frombuffer(
            json.dumps(dataclasses.asdict(config)).encode(), dtype=np.uint8),
    }
    np.savez(path, **payload)


def load_render_state(path: str) -> Tuple[np.ndarray, int, int,
                                          RenderConfig]:
    """(accum as numpy, sample, total rays, config)."""
    with np.load(path) as data:
        config = RenderConfig(**json.loads(bytes(data["config_json"])))
        return (data["accum"], int(data["sample"]), int(data["total_rays"]),
                config)
