"""Camera model and per-pixel ray generation.

Mirrors ``ray_tracing_extended_tpu/ops/camera.py`` (UpdateCameraParams,
RayTracingManager.cs:126-133, and the ray setup in frag,
RayTracing.shader:364-382). Row 0 is the image BOTTOM; pixel centres sit at
``(x + 0.5) / width``; ``pixel_index = y * width + x``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device
from . import rng as rng_ops
from . import vecmath as vm


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole + thin-lens camera. ``rotation`` is local-to-world with
    columns (right, up, forward)."""

    position: torch.Tensor  # (3,) f32
    rotation: torch.Tensor  # (3, 3) f32
    fov_y_deg: torch.Tensor  # () f32
    focus_distance: torch.Tensor  # () f32
    defocus_strength: torch.Tensor  # () f32
    diverge_strength: torch.Tensor  # () f32

    def to(self, device) -> "Camera":
        return Camera(
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )

    def replace(self, **fields) -> "Camera":
        """A copy with some fields set; plain numbers become f32 tensors on
        the camera's device."""
        dev = self.position.device
        return dataclasses.replace(
            self,
            **{
                k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in fields.items()
            },
        )


def camera_from_numpy(
    position, rotation, fov_y_deg, focus_distance, defocus_strength,
    diverge_strength, device=DEFAULT_DEVICE,
) -> Camera:
    """Camera on ``device`` from array-likes, every field as f32."""
    dev = resolve_device(device)

    def f32(v):
        return torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)

    return Camera(
        position=f32(position),
        rotation=f32(rotation),
        fov_y_deg=f32(fov_y_deg),
        focus_distance=f32(focus_distance),
        defocus_strength=f32(defocus_strength),
        diverge_strength=f32(diverge_strength),
    )


def look_at(
    position,
    target,
    up=(0.0, 1.0, 0.0),
    fov_y_deg=60.0,
    focus_distance=1.0,
    defocus_strength=0.0,
    diverge_strength=0.3,
    device=DEFAULT_DEVICE,
) -> Camera:
    """A camera looking from ``position`` toward ``target``, built in numpy
    exactly as the JAX package builds it (defaults mirror
    RayTracingManager.cs:12-16), on ``device``."""
    position = np.asarray(position, np.float32)
    target = np.asarray(target, np.float32)
    up_hint = np.asarray(up, np.float32)

    def _nrm(v):
        n = float(np.linalg.norm(v))
        if n < 1e-12:
            raise ValueError(
                "look_at: degenerate basis (is `up` parallel to the view "
                "direction?)"
            )
        return v / n

    fwd = _nrm(target - position)
    right = _nrm(np.cross(up_hint, fwd))
    up_v = np.cross(fwd, right)
    rotation = np.stack([right, up_v, fwd], axis=-1).astype(np.float32)
    return camera_from_numpy(
        position, rotation, fov_y_deg, focus_distance, defocus_strength,
        diverge_strength, device,
    )


def camera_from_matrix(
    position,
    rotation,
    fov_y_deg=60.0,
    focus_distance=1.0,
    defocus_strength=0.0,
    diverge_strength=0.3,
    device=DEFAULT_DEVICE,
) -> Camera:
    """A camera from an explicit local-to-world rotation (columns right,
    up, forward), as scene files store it, on ``device``."""
    return camera_from_numpy(
        position, rotation, fov_y_deg, focus_distance, defocus_strength,
        diverge_strength, device,
    )


def camera_params(cam: Camera, width: int, height: int) -> torch.Tensor:
    """The per-frame camera scalars, (5,) f32 on the camera's device:
    ``[plane_w, plane_h, focus_distance, defocus_scale, diverge_scale]``.

    The plain path and the CUDA kernel both take their plane size from
    here, so on one device they start from the same bits (a ``tan`` that
    rounded differently would shift every focus point)."""
    half_fov = cam.fov_y_deg * float(np.float32(math.pi / 360.0))
    plane_h = cam.focus_distance * torch.tan(half_fov) * 2.0
    plane_w = plane_h * float(np.float32(width / height))
    return torch.stack(
        [plane_w, plane_h, cam.focus_distance, *_jitter_scales(cam, width)]
    )


def _jitter_scales(cam: Camera, width: int):
    """Defocus and diverge disc radii in world units: strength / width."""
    inv_w = float(np.float32(1.0) / np.float32(width))
    return cam.defocus_strength * inv_w, cam.diverge_strength * inv_w


def focus_points(cam: Camera, pix_x, pix_y, width: int, height: int):
    """World-space focus-plane points for pixel coordinates (B,) -> (B, 3)
    (RayTracing.shader:365-366)."""
    params = camera_params(cam, width, height)
    plane_w, plane_h, focus = params[0], params[1], params[2]
    u = vm.div(pix_x.to(torch.float32) + 0.5, float(width))
    v = vm.div(pix_y.to(torch.float32) + 0.5, float(height))
    lx = (u - 0.5) * plane_w
    ly = (v - 0.5) * plane_h
    rot = cam.rotation
    # position + rotation @ (lx, ly, focus), one row at a time
    return torch.stack(
        [
            cam.position[i] + (lx * rot[i, 0] + ly * rot[i, 1] + focus * rot[i, 2])
            for i in range(3)
        ],
        dim=-1,
    )


def generate_rays(state, cam: Camera, focus_point, width: int):
    """One ray per lane with defocus and anti-aliasing jitter, four draws
    (RayTracing.shader:377-382). Returns ``(state, origin, direction)``."""
    right = cam.rotation[:, 0]
    up = cam.rotation[:, 1]
    defocus_scale, diverge_scale = _jitter_scales(cam, width)

    state, defocus = rng_ops.random_point_in_circle(state)
    defocus = defocus * defocus_scale
    origin = (
        cam.position[None, :]
        + right[None, :] * defocus[..., 0:1]
        + up[None, :] * defocus[..., 1:2]
    )

    state, jitter = rng_ops.random_point_in_circle(state)
    jitter = jitter * diverge_scale
    target = (
        focus_point
        + right[None, :] * jitter[..., 0:1]
        + up[None, :] * jitter[..., 1:2]
    )
    return state, origin, vm.normalize(target - origin)
