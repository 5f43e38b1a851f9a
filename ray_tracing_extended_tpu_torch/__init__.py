"""ray_tracing_extended_tpu_torch: the progressive path tracer in PyTorch,
with a hand-written CUDA kernel for NVIDIA Hopper.

A port of ``ray_tracing_extended_tpu`` (JAX, TPU), which stays the
reference it is tested against. It imports torch and numpy, never JAX.
Builders, loaders and presets put scenes and cameras on the card unless
the caller passes ``device="cpu"``; tensors on a CUDA device take the CUDA
kernel, tensors on the CPU the plain PyTorch path.

Quick start (on the card)::

    import ray_tracing_extended_tpu_torch as rtt
    from ray_tracing_extended_tpu_torch.models.presets import rtiow_final_scene

    scene, cam, cfg = rtiow_final_scene(width=320, height=180, spp=4)
    img = rtt.render_frame(scene, cam, cfg, frame=0)

    scene, cam, cfg = rtt.load_json_scene("scenes/chess.json")
    img = rtt.render_progressive(scene, cam, cfg, frames=16)

or, from the shell, ``python -m ray_tracing_extended_tpu_torch.cli render
--scene scenes/chess.json --adaptive-spp --frames 16 --out chess.png``.
"""

from .models.geometry import (
    BVH,
    FLAG_CHECKER,
    FLAG_DIELECTRIC,
    FLAG_INVISIBLE_LIGHT,
    FLAG_NONE,
    Environment,
    Materials,
    MeshChunks,
    Scene,
    Spheres,
    Triangles,
)
from .models.scene import Material, SceneBuilder
from .ops.accumulate import accumulate
from .ops.camera import Camera, camera_from_matrix, look_at
from .progressive import render_progressive
from .render import (
    render_and_accumulate,
    render_frame,
    render_frame_with_stats,
    render_frames_and_accumulate,
)
from .scene.json_scene import load_json_scene
from .utils.config import RenderConfig

__version__ = "0.1.0"

__all__ = [
    "BVH",
    "Camera",
    "Environment",
    "FLAG_CHECKER",
    "FLAG_DIELECTRIC",
    "FLAG_INVISIBLE_LIGHT",
    "FLAG_NONE",
    "Material",
    "Materials",
    "MeshChunks",
    "RenderConfig",
    "Scene",
    "SceneBuilder",
    "Spheres",
    "Triangles",
    "accumulate",
    "camera_from_matrix",
    "load_json_scene",
    "look_at",
    "render_and_accumulate",
    "render_frame",
    "render_frame_with_stats",
    "render_frames_and_accumulate",
    "render_progressive",
]
