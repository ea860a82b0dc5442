"""traversal_roofline: the least time that the traced frames' traversal
queries need on the card (benchmark/roofline.py: the needed pairs'
Moller-Trumbore operations over the float32 peak, or the bytes over the
HBM peak, whichever is larger), over the device time of the port's
traversal kernels (tile-MT and banded) in those frames, in percent."""
from benchmark import roofline

KERNELS = ("tilemt_kernel", "banded_kernel")


def read(run):
    tr = run.trace
    if not tr or not tr.get("queries"):
        return None
    kernel_s = sum(s for name, s in tr["device_by_name"].items()
                   if any(k in name for k in KERNELS))
    if kernel_s <= 0:
        return None
    bound = roofline.bound_seconds(tr["queries"], run.driver.scene.bvh.tb,
                                   run.device_kind)
    return None if bound is None else 100.0 * bound / kernel_s
