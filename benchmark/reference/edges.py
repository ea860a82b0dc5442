"""Which triangle edges can carry a silhouette: MobileRT's scene has none
in the interior of a flat, single-material surface.  A shared edge whose
two faces are coplanar with equal normals and the same material is
dropped from both faces; boundary edges, creases and material seams
stay, as do only the edges of valid, non-degenerate faces.  Edge slots
are [ab x N | bc x N | ca x N].  A frozen copy of the port's
`diff.geom.edge_topology` (numpy)."""
from __future__ import annotations

import numpy as np


def edge_keep(point_a, ab, ac, mat_id, valid,
              quantum: float = 1e-5) -> np.ndarray:
    va = np.asarray(point_a, np.float32)
    ab = np.asarray(ab, np.float32)
    ac = np.asarray(ac, np.float32)
    vb, vc = va + ab, va + ac
    n = va.shape[0]
    nrm = np.cross(ab, ac)
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.maximum(ln, 1e-30)
    mat = np.asarray(mat_id)

    def key_of(p):
        return np.round(p / quantum).astype(np.int64)

    ka, kb, kc = key_of(va), key_of(vb), key_of(vc)
    allk = np.concatenate([np.concatenate([np.minimum(p, q), np.maximum(p, q)],
                                          axis=1)
                           for p, q in ((ka, kb), (kb, kc), (kc, ka))], 0)
    order = np.lexsort(allk.T)
    sk = allk[order]
    same_prev = np.concatenate([[False], np.all(sk[1:] == sk[:-1], axis=1)])
    same_next = np.concatenate([same_prev[1:], [False]])
    mate_sorted = np.full(3 * n, -1, np.int64)
    prev_idx = np.nonzero(same_prev)[0]
    mate_sorted[prev_idx] = order[prev_idx - 1]
    next_idx = np.nonzero(same_next)[0]
    mate_sorted[next_idx] = order[next_idx + 1]
    mate = np.full(3 * n, -1, np.int64)
    mate[order] = mate_sorted
    tri_of = np.tile(np.arange(n), 3)
    has_mate = mate >= 0
    m_tri = tri_of[np.maximum(mate, 0)]
    coplanar = np.abs(np.einsum("ij,ij->i", nrm[tri_of],
                                nrm[m_tri])) > 1.0 - 1e-6
    same_nrm = np.linalg.norm(nrm[tri_of] - nrm[m_tri], axis=-1) < 1e-6
    same_mat = mat[tri_of] == mat[m_tri]
    keep = ~(has_mate & coplanar & same_nrm & same_mat)
    keep &= np.tile(np.asarray(valid, bool), 3)
    keep &= np.tile(ln[:, 0] > 1e-20, 3)
    return keep
