"""JSON scene files: the reference's serialized structs, field for field.

Mirrors ``ray_tracing_extended_tpu/scene/json_scene.py`` and reads the same
files, among them the six shipped mirrors of the reference's Unity scenes in
``scenes/``. Example::

    {
      "settings": {"maxBounceCount": 4, "numRaysPerPixel": 16},
      "camera": {"position": [0, 1, -4], "lookAt": [0, 0, 0], "fovY": 60,
                 "focusDistance": 4, "defocusStrength": 0,
                 "divergeStrength": 0.3},
      "environment": {"enabled": true, "groundColour": [0.35, 0.3, 0.35],
                      "skyColourHorizon": [1, 1, 1],
                      "skyColourZenith": [0.08, 0.37, 0.73],
                      "sunFocus": 500, "sunIntensity": 10,
                      "sunDirection": [0.5, 0.7, -0.5]},
      "spheres": [{"position": [0, 0, 0], "radius": 0.5,
                   "material": {"colour": [1, 0, 0], "smoothness": 0.5,
                                 "specularProbability": 0.1}}],
      "meshes": [{"obj": "bunny.obj",
                  "transform": {"position": [0, 0, 0],
                                 "rotationEulerDeg": [0, 90, 0],
                                 "scale": 1.0},
                  "material": {"colour": [0.8, 0.8, 0.8]},
                  "chunked": true}]
    }

Material fields default to the reference's defaults
(RayTracingMaterial.cs:21-28); ``flag`` takes 0-3 or the names "none",
"checker", "invisibleLight", "dielectric". ``camera.rotation`` (a 3x3
local-to-world matrix, rows nested, columns right/up/forward) may stand in
for ``lookAt``. A mesh entry names an ``"obj"`` or a binary ``"fbx"`` file
(``scene/fbx.py``: its model transforms and unit scale applied before
``transform``); ``{"npz": "file.npz", "group": "g000", ...}`` is a baked
world-space triangle soup (arrays ``<group>_pos`` and ``<group>_nrm`` of
shape (N, 3, 3)) and becomes one chunk.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..models.geometry import Environment
from ..models.scene import Material, SceneBuilder
from ..ops.camera import camera_from_matrix, look_at
from ..utils.config import RenderConfig
from ..utils.device import DEFAULT_DEVICE
from .fbx import load_fbx
from .mesh_io import load_obj

_FLAGS = {"none": 0, "checker": 1, "invisiblelight": 2, "dielectric": 3}


def _material(d: dict) -> Material:
    flag = d.get("flag", 0)
    if isinstance(flag, str):
        flag = _FLAGS[flag.lower()]
    return Material(
        colour=tuple(d.get("colour", (1, 1, 1))),
        emission_colour=tuple(d.get("emissionColour", (1, 1, 1))),
        specular_colour=tuple(d.get("specularColour", (1, 1, 1))),
        emission_strength=float(d.get("emissionStrength", 0.0)),
        smoothness=float(d.get("smoothness", 0.0)),
        specular_probability=float(d.get("specularProbability", 1.0)),
        flag=int(flag),
        ior=float(d.get("ior", 1.5 if flag == 3 else 1.0)),
    )


def _transform_matrix(t: dict) -> np.ndarray:
    """(4, 4) float64 local-to-world matrix from position, Euler angles in
    degrees (Unity's order: Z, then X, then Y) and a uniform or per-axis
    scale."""
    pos = np.asarray(t.get("position", (0, 0, 0)), np.float64)
    deg = np.asarray(t.get("rotationEulerDeg", (0, 0, 0)), np.float64)
    scale = t.get("scale", 1.0)
    scale = (
        np.asarray(scale, np.float64)
        if isinstance(scale, (list, tuple))
        else np.full(3, float(scale))
    )
    rx, ry, rz = np.radians(deg)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    m = np.eye(4)
    m[:3, :3] = (my @ mx @ mz) * scale
    m[:3, 3] = pos
    return m


def _environment(envd: dict) -> Environment:
    sun_dir = np.asarray(envd.get("sunDirection", (0, 1, 0)), np.float32)
    sun_dir = sun_dir / max(np.linalg.norm(sun_dir), 1e-20)

    def f32(v):
        return torch.from_numpy(np.array(v, dtype=np.float32))

    return Environment(
        enabled=f32(1.0 if envd.get("enabled") else 0.0),
        ground_colour=f32(envd.get("groundColour", (0, 0, 0))),
        sky_colour_horizon=f32(envd.get("skyColourHorizon", (0, 0, 0))),
        sky_colour_zenith=f32(envd.get("skyColourZenith", (0, 0, 0))),
        sun_focus=f32(max(1.0, float(envd.get("sunFocus", 1)))),
        sun_intensity=f32(max(0.0, float(envd.get("sunIntensity", 0)))),
        sun_dir=f32(sun_dir),
    )


def load_json_scene(path, overrides: dict | None = None,
                    device=DEFAULT_DEVICE):
    """-> ``(scene, camera, config)`` with the scene and camera on
    ``device`` (default the card; raises where CUDA is not available
    unless ``device="cpu"``). Relative mesh paths resolve against the JSON
    file's directory; ``overrides`` replaces config fields. As in the JAX
    package, a scene with a mesh of more than 4096 faces, or more than
    16384 baked triangles, gets a triangle BVH (``build_bvh="tri"``),
    which on the card takes the kernel's BVH instantiation; smaller
    scenes (every shipped mirror) are scanned by chunk."""
    path = Path(path)
    spec = json.loads(path.read_text())

    b = SceneBuilder(env=_environment(spec.get("environment") or {}))
    for s in spec.get("spheres", []):
        b.add_sphere(
            np.asarray(s["position"], np.float32),
            float(s["radius"]),
            _material(s.get("material") or {}),
        )

    any_big_mesh = False
    n_baked_tris = 0
    npz_cache: dict = {}
    for m in spec.get("meshes", []):
        material = _material(m.get("material") or {})
        if "npz" in m:
            f_npz = path.parent / m["npz"]
            if f_npz not in npz_cache:
                npz_cache[f_npz] = np.load(f_npz)
            data = npz_cache[f_npz]
            g = m["group"]
            tri_pos = np.asarray(data[f"{g}_pos"], np.float32)
            b.add_triangles(
                tri_pos, np.asarray(data[f"{g}_nrm"], np.float32), material
            )
            n_baked_tris += len(tri_pos)
        elif "obj" in m or "fbx" in m:
            if "obj" in m:
                v, f, n = load_obj(path.parent / m["obj"])
            else:
                v, f, n = load_fbx(path.parent / m["fbx"])
            any_big_mesh |= len(f) > 4096
            b.add_mesh(
                v, f, material, normals=n,
                transform=_transform_matrix(m.get("transform") or {}),
                chunked=bool(m.get("chunked", True)),
            )
        else:
            raise ValueError("mesh entry needs 'obj', 'fbx' or 'npz'")
    scene = b.build(
        build_bvh="tri" if any_big_mesh or n_baked_tris > 16384 else None,
        device=device,
    )

    settings = spec.get("settings") or {}
    camd = spec.get("camera") or {}
    lens = dict(
        fov_y_deg=float(camd.get("fovY", 60.0)),
        focus_distance=float(camd.get("focusDistance", 1.0)),
        defocus_strength=float(camd.get("defocusStrength", 0.0)),
        diverge_strength=float(camd.get("divergeStrength", 0.3)),
    )
    if "rotation" in camd:
        cam = camera_from_matrix(
            np.asarray(camd.get("position", (0, 0, -3)), np.float32),
            np.asarray(camd["rotation"], np.float32),
            **lens, device=device,
        )
    else:
        cam = look_at(
            camd.get("position", (0, 0, -3)),
            camd.get("lookAt", (0, 0, 0)),
            up=camd.get("up", (0, 1, 0)),
            **lens, device=device,
        )
    cfg = RenderConfig(
        max_bounce=int(settings.get("maxBounceCount", 4)),
        spp=int(settings.get("numRaysPerPixel", 2)),
        width=int(settings.get("width", 1280)),
        height=int(settings.get("height", 720)),
        adaptive_spp=bool(settings.get("adaptiveSpp", False)),
        fast_scatter=bool(settings.get("fastScatter", False)),
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return scene, cam, cfg.validate()
