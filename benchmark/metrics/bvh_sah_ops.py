"""``bvh_sah_ops``: the surface-area cost of the tree the program built,
in FP32 operations for a ray through its root's box (12 the root's box, 24
each internal node, 34 each triangle of a leaf, each weighted by the
node's box area over the root's): the last build's ``sah_ops`` in the
program's ``accel/bvh.LBVH_BUILDS``, in the run's own process. None where
the program records none."""

import sys


def read(ctx):
    bvh = sys.modules.get("ray_tracing_extended_tpu_torch.accel.bvh")
    sah = getattr(getattr(bvh, "LBVH_BUILDS", None), "sah_ops", None)
    return float(sah[-1]) if sah else None
