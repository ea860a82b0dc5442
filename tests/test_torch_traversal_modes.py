"""The "tilebw" (Baldwin-Weber tile) and "resident" (resident-table
any-hit) traversal modes of the PyTorch port: drivers and scene queries
against the JAX package and the naive oracle, the 120k-triangle soup, and
the resident kernel's plain version against the Pallas kernel in
interpret mode on a table of several partitions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobileraytracer_tpu.ops import pallas_bvh as jpb
from mobileraytracer_tpu_torch.ops import block_traversal as tbt
from mobileraytracer_tpu_torch.ops import kernels as K
from test_torch_traversal import T_RTOL
from test_torch_traversal_drivers import (check_scene_queries, check_soup,
                                          check_traversal, soup)

torch.set_num_threads(2)

MODES = ["tilebw", "resident"]


@pytest.mark.parametrize("mode", MODES)
def test_traversal_matches_jax_and_naive(mode):
    check_traversal(mode)


@pytest.mark.parametrize("mode", MODES)
def test_scene_queries_match_jax_cornell2(mode):
    check_scene_queries(mode)


@pytest.mark.parametrize("mode", MODES)
def test_soup_reaches_dense_backstop_and_stays_exact(mode):
    check_soup(mode)


def test_resident_plain_matches_pallas():
    """Per-partition t and slot of the resident-table walk on the soup's
    three partitions: slot exact, t within T_RTOL (XLA's CPU code contracts
    the Moller-Trumbore arithmetic into FMAs)."""
    _, grid, o, d, _, _, _ = soup()
    b = o.shape[0]
    t0 = torch.full((b, 1), 1.0)
    prev = torch.full((b, 1), -1.0)
    prev[::7] = 5.0
    rays = torch.cat([o, d, t0, prev], 1)
    cap0 = rays[:, 6].reshape(b // K.ST, K.ST).amax(1)
    cg, _, ce, _ = tbt._candidates(grid, o, d, cap=cap0)
    m = cg.shape[1]
    tb_pad, starts, glist, n_parts = tbt._resident_lists(grid, cg, ce)
    assert n_parts == 3
    ng = b // K.TILE
    jt, js = (np.asarray(a)[:, :, 0] for a in jpb._traverse_resident_padded(
        jnp.asarray(tb_pad.numpy()),
        jnp.asarray(starts.numpy().reshape(ng, 1, -1)),
        jnp.asarray(glist.numpy().reshape(ng, 1, -1)),
        jnp.asarray(rays.numpy()), m, n_parts, True))
    tt, ts = K.resident_plain(tb_pad, starts, glist, rays, m, n_parts)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=T_RTOL)
    # Every partition occludes some ray, and some band's run in a later
    # partition starts at the end of its list (the clamped list read).
    assert ((jt < 1.0).sum(1) > 0).all()
    assert (starts[:, 1:-1] == m).any()
