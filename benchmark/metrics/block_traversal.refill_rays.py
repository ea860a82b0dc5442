"""block_traversal.refill_rays: the unresolved rays that the traversal's
exact refill gathered a loop (`block_traversal.REFILL`: rays over loops)
over the window.  None where the program has no such counter."""
import numpy as np


def _refill():
    from mobileraytracer_tpu_torch.ops import block_traversal
    return getattr(block_traversal, "REFILL", None)


def counter():
    r = _refill()
    return np.zeros(2) if r is None else np.array([r["rays"], r["loops"]],
                                                  np.float64)


def read(run):
    rays, loops = run.deltas["block_traversal.refill_rays"]
    if _refill() is None or not loops:
        return None
    return float(rays / loops)
