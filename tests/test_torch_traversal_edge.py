"""A shadow ray whose blocker lies one float32 ulp before the end of its
segment, from the 512x512 conference proxy's reversed shared-light NEE
batch (the 128-ray tile that holds it, saved from a run on the GPU).

The tile-granular modes ("tilemt", "tilebw") miss that blocker in the JAX
package: the ray's own slab-entry lower bound for the blocker's super
rounds up to exactly the segment's end, so the refill's cap drops the
super, while the Moller-Trumbore t rounds one ulp below it.  The subtile
modes ("banded", "resident") list the block from a wider hull and find it.
The port must give the JAX package's answer in every mode."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu import bench_scenes as jbs
from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu_torch import bench_scenes as tbs
from mobileraytracer_tpu_torch.ops import block_traversal as tbt
from mobileraytracer_tpu_torch.ops import intersect as tnv

torch.set_num_threads(2)

# Rows [o, d, max distance, previous kind, previous id] of one tile.
DATA = (pathlib.Path(__file__).parent / "data"
        / "torch_port_shadow_tile_edge.npy")
EDGE_LANE = 43          # the ray with the blocker one ulp before its end

_CACHE = {}


def _conference():
    if "c" not in _CACHE:
        js, _, _ = jbs.conference_proxy()
        ts, _, _ = tbs.conference_proxy()
        _CACHE["c"] = jpb.build_blocks(js.triangles) + \
            tbt.build_blocks(ts.triangles)
    return _CACHE["c"]


@pytest.mark.parametrize("mode", ["banded", "tilemt", "tilebw", "resident"])
def test_blocker_one_ulp_before_the_end_as_in_jax(mode):
    a = np.load(DATA)
    o, d, md = a[:, 0:3], a[:, 3:6], a[:, 6]
    pk, pi = a[:, 7].astype(np.int32), a[:, 8].astype(np.int32)
    jt2, jg, tt2, tg = _conference()
    tin = [torch.from_numpy(x) for x in (o, d, md, pk, pi)]
    _, id_p = tbt._TRAVERSALS[mode](tg, tt2, *tin, any_hit=True)
    _, id_j = jpb._TRAVERSALS[mode](jg, jt2, *map(jnp.asarray,
                                                  (o, d, md, pk, pi)),
                                    any_hit=True)
    occ = id_p.numpy() >= 0
    np.testing.assert_array_equal(occ, np.asarray(id_j) >= 0)

    t_n, id_n = tnv.closest_triangles(tt2, *tin)
    assert np.float32(md[EDGE_LANE]) == np.nextafter(
        np.float32(t_n[EDGE_LANE]), np.float32(np.inf))
    wrong = np.nonzero(occ != (id_n.numpy() >= 0))[0]
    expect = [EDGE_LANE] if mode in ("tilemt", "tilebw") else []
    np.testing.assert_array_equal(wrong, expect)
