"""Checkpoint / resume for progressive renders.

Counterpart of ``ray_tracing_extended_tpu/utils/checkpoint.py``, with the
same file: one ``.npz`` holding ``accum`` (the (H, W, 3) f32 running
average), ``frame`` (the next frame index) and ``fingerprint``, written
atomically. A resume continues the running average exactly, since the
1/(frame + 1) weighting makes it independent of where it stopped, and is
refused when the fingerprint of the scene, camera and config differs.

The fingerprint is the JAX package's, computed without JAX: a sha256 over
the config's fields as sorted JSON, then over every array of the scene and
camera in field order (dtype, shape, bytes). The port's dataclasses have
the JAX package's fields in its order, so the two packages agree on a
checkpoint of the same render, and a checkpoint the JAX package wrote
resumes here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from ..models.geometry import BVH
from .config import RenderConfig


def tree_leaves(tree):
    """The arrays of a dataclass tree or a sequence of them, in field order
    (the JAX package's pytree leaf order). ``Scene.has_triangles`` is a
    cached property of the arrays, not data, and is skipped; so are BVHs,
    which derive from the scene (the JAX package's fingerprint excludes
    them too)."""
    if isinstance(tree, (list, tuple)):
        for item in tree:
            yield from tree_leaves(item)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            value = getattr(tree, f.name)
            if value is not None and not isinstance(value, (bool, BVH)):
                yield from tree_leaves(value)
    else:
        yield tree


def hash_tree(tree) -> str:
    """Exact byte hash over a tree's arrays (dtype, shape, raw bytes)."""
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        a = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:32]


def state_hash(scene, camera, cfg: RenderConfig) -> str:
    """Fingerprint of everything that decides a frame: the config, the
    scene and the camera (or a sequence of cameras)."""
    h = hashlib.sha256()
    h.update(json.dumps(cfg.__dict__, sort_keys=True).encode())
    h.update(hash_tree(scene).encode())
    h.update(hash_tree(camera).encode())
    return h.hexdigest()[:32]


def save(path, accum, frame: int, fingerprint: str) -> None:
    """Write the running average and the next frame index, atomically: a
    crash never leaves a torn checkpoint."""
    if torch.is_tensor(accum):
        accum = accum.detach().cpu().numpy()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            accum=np.asarray(accum, np.float32),
            frame=np.int64(frame),
            fingerprint=np.bytes_(fingerprint.encode()),
        )
    tmp.replace(path)


def load(path, fingerprint: str | None = None):
    """Returns ``(accum (H, W, 3) np.float32, frame int)``. Raises
    ValueError on a fingerprint mismatch (resuming a different render)."""
    with np.load(path) as z:
        accum = z["accum"].astype(np.float32)
        frame = int(z["frame"])
        saved_fp = bytes(z["fingerprint"]).decode()
    if fingerprint is not None and saved_fp != fingerprint:
        raise ValueError(
            "checkpoint fingerprint mismatch: the checkpoint was produced by "
            "a different scene/camera/config (refusing to average unrelated "
            f"renders; saved={saved_fp}, current={fingerprint})"
        )
    return accum, frame
