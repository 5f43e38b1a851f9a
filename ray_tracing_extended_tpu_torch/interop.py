"""Hand-off from the JAX package's scene and camera to the port's tensors.

The JAX package (``ray_tracing_extended_tpu``) keeps its scene as
dataclasses of arrays. These functions read each leaf once with
``np.asarray`` and put it on ``device`` (the card unless the caller asks
for the CPU), so both packages can render the same scene and the port can
be held against the reference. They use only
attribute access and numpy: nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.geometry import (
    BVH,
    Environment,
    Materials,
    MeshChunks,
    Scene,
    Spheres,
    Triangles,
)
from .ops.camera import Camera, camera_from_numpy
from .utils.device import DEFAULT_DEVICE, resolve_device


def _copy(cls, src):
    """``cls`` with every field read from the same-named attribute of
    ``src`` (a JAX-package dataclass with array leaves), on the CPU."""
    return cls(
        **{
            name: torch.from_numpy(np.array(np.asarray(getattr(src, name))))
            for name in cls.__dataclass_fields__
        }
    )


def _copy_bvh(bvh):
    return None if bvh is None else _copy(BVH, bvh)


def scene_from_arrays(scene, device=DEFAULT_DEVICE) -> Scene:
    """A port ``Scene`` on ``device`` from a JAX-package ``Scene``, with its
    BVHs. Its packed TPU tables are left behind: the port does not use
    them."""
    dev = resolve_device(device)
    return Scene(
        spheres=_copy(Spheres, scene.spheres),
        triangles=_copy(Triangles, scene.triangles),
        chunks=_copy(MeshChunks, scene.chunks),
        materials=_copy(Materials, scene.materials),
        env=_copy(Environment, scene.env),
        tri_bvh=_copy_bvh(scene.tri_bvh),
        sphere_bvh=_copy_bvh(scene.sphere_bvh),
    ).to(dev)


def camera_from_arrays(cam, device=DEFAULT_DEVICE) -> Camera:
    """A port ``Camera`` on ``device`` from a JAX-package ``Camera``."""
    return camera_from_numpy(
        *(np.asarray(getattr(cam, name)) for name in Camera.__dataclass_fields__),
        device=device,
    )
