"""Scene presets: the sphere, Cornell and big-mesh configs of
BASELINE.json, and the fly-through camera path.

Mirrors ``ray_tracing_extended_tpu/models/presets.py`` call for call, with
the same fixed-seed ``np.random.RandomState``, so both packages build
identical scenes. Each returns ``(scene, camera, config)`` with the scene
and camera on ``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.camera import look_at
from ..scene.mesh_io import load_obj
from ..scene.procedural import trefoil_knot_mesh
from ..utils.config import RenderConfig
from ..utils.device import DEFAULT_DEVICE
from .geometry import Environment
from .scene import Material, SceneBuilder


def _gradient_sky(horizon=(1.0, 1.0, 1.0), zenith=(0.5, 0.7, 1.0)):
    """RTIOW-style blue gradient sky, no sun."""

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    return Environment(
        enabled=f32(1.0),
        ground_colour=f32(horizon),
        sky_colour_horizon=f32(horizon),
        sky_colour_zenith=f32(zenith),
        sun_focus=f32(1.0),
        sun_intensity=f32(0.0),
        sun_dir=f32([0.0, 1.0, 0.0]),
    )


def three_sphere_scene(width=320, height=180, max_bounce=4, spp=16,
                       device=DEFAULT_DEVICE):
    """Three spheres (lambertian / metal / dielectric) on a ground sphere."""
    b = SceneBuilder(env=_gradient_sky())
    b.add_sphere((0.0, -100.5, 0.0), 100.0, Material.lambertian((0.8, 0.8, 0.0)))
    b.add_sphere((0.0, 0.0, 0.0), 0.5, Material.lambertian((0.1, 0.2, 0.5)))
    b.add_sphere((-1.05, 0.0, 0.0), 0.5, Material.dielectric(1.5))
    b.add_sphere((1.05, 0.0, 0.0), 0.5, Material.metal((0.8, 0.6, 0.2), smoothness=1.0))
    cam = look_at(
        (0.0, 0.25, -2.6),
        (0.0, 0.0, 0.0),
        fov_y_deg=45.0,
        focus_distance=2.6,
        defocus_strength=0.0,
        diverge_strength=0.5,
        device=device,
    )
    cfg = RenderConfig(width=width, height=height, max_bounce=max_bounce, spp=spp)
    return b.build(device=device), cam, cfg


def rtiow_final_scene(
    width=1920, height=1080, max_bounce=4, spp=1, seed=20260816,
    build_bvh: str | None = None, device=DEFAULT_DEVICE,
):
    """The RTIOW cover scene: ~480 random small spheres, 3 hero spheres and
    a ground sphere, HDR accumulation. ``build_bvh`` as in
    ``SceneBuilder.build``."""
    rs = np.random.RandomState(seed)
    b = SceneBuilder(env=_gradient_sky())
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, Material.lambertian((0.5, 0.5, 0.5)))
    for a in range(-11, 11):
        for c in range(-11, 11):
            choose = rs.rand()
            center = np.array(
                [a + 0.9 * rs.rand(), 0.2, c + 0.9 * rs.rand()], np.float32
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rs.rand(3) * rs.rand(3)
                mat = Material.lambertian(tuple(albedo))
            elif choose < 0.95:
                albedo = 0.5 * (1.0 + rs.rand(3))
                fuzz = 0.5 * rs.rand()
                mat = Material.metal(tuple(albedo), smoothness=1.0 - fuzz)
            else:
                mat = Material.dielectric(1.5)
            b.add_sphere(tuple(center), 0.2, mat)
    b.add_sphere((0.0, 1.0, 0.0), 1.0, Material.dielectric(1.5))
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, Material.lambertian((0.4, 0.2, 0.1)))
    b.add_sphere((4.0, 1.0, 0.0), 1.0, Material.metal((0.7, 0.6, 0.5), smoothness=1.0))
    cam = look_at(
        (13.0, 2.0, 3.0),
        (0.0, 0.0, 0.0),
        fov_y_deg=20.0,
        focus_distance=10.0,
        defocus_strength=20.0,
        diverge_strength=1.0,
        device=device,
    )
    cfg = RenderConfig(
        width=width, height=height, max_bounce=max_bounce, spp=spp,
        clamp_accumulate=False,
    )
    return b.build(build_bvh=build_bvh, device=device), cam, cfg


def _quad(b: SceneBuilder, p0, p1, p2, p3, mat: Material, normal=None):
    """Two triangles for the quad (p0, p1, p2, p3) in CCW order."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    if normal is None:
        normal = np.cross(p1 - p0, p3 - p0)
        normal = normal / np.linalg.norm(normal)
    normal = np.asarray(normal, np.float32)
    tris = np.stack([np.stack([p0, p1, p2]), np.stack([p0, p2, p3])])
    nrm = np.tile(normal, (2, 3, 1))
    b.add_triangles(tris, nrm, mat)


def cornell_box_scene(width=512, height=512, max_bounce=8, spp=4,
                      device=DEFAULT_DEVICE):
    """Cornell box with an emissive ceiling light, a glass and a metal
    sphere; environment off. Its walls are triangles: on the card it takes
    the kernel's triangle variant."""
    b = SceneBuilder()
    white = Material.lambertian((0.73, 0.73, 0.73))
    red = Material.lambertian((0.65, 0.05, 0.05))
    green = Material.lambertian((0.12, 0.45, 0.15))
    light = Material.emissive((1.0, 0.85, 0.7), 15.0)
    s = 1.0
    z0, z1 = 0.0, 2.0
    # every wall's normal points into the box: the triangle test culls
    # back faces
    _quad(b, (-s, -s, z0), (-s, -s, z1), (s, -s, z1), (s, -s, z0), white)  # floor
    _quad(b, (-s, s, z1), (-s, s, z0), (s, s, z0), (s, s, z1), white)  # ceiling
    _quad(b, (-s, -s, z1), (-s, s, z1), (s, s, z1), (s, -s, z1), white)  # back
    _quad(b, (-s, -s, z0), (-s, s, z0), (-s, s, z1), (-s, -s, z1), red)  # left
    _quad(b, (s, -s, z1), (s, s, z1), (s, s, z0), (s, -s, z0), green)  # right
    l, zl0, zl1 = 0.35, 0.8, 1.4
    _quad(
        b,
        (-l, s - 0.01, zl1),
        (-l, s - 0.01, zl0),
        (l, s - 0.01, zl0),
        (l, s - 0.01, zl1),
        light,
    )
    b.add_sphere((-0.35, -0.6, 1.3), 0.4, Material.dielectric(1.5))
    b.add_sphere((0.45, -0.65, 1.05), 0.35, Material.metal((0.8, 0.8, 0.9), smoothness=0.95))
    cam = look_at(
        (0.0, 0.0, -2.2),
        (0.0, 0.0, 1.0),
        fov_y_deg=40.0,
        focus_distance=3.2,
        defocus_strength=0.0,
        diverge_strength=1.0,
        device=device,
    )
    cfg = RenderConfig(
        width=width, height=height, max_bounce=max_bounce, spp=spp,
        clamp_accumulate=False,
    )
    return b.build(device=device), cam, cfg


def mesh_scene(
    width=1280,
    height=720,
    max_bounce=4,
    spp=1,
    obj_path: str | None = None,
    target_tris: int = 70000,
    device=DEFAULT_DEVICE,
):
    """BASELINE config 4: a large triangle mesh (~70k triangles) in one
    chunk, with a triangle BVH; on the card it takes the kernel's BVH
    instantiation. Loads an OBJ if given; otherwise a deterministic
    procedural trefoil knot of ``target_tris`` triangles (the repo ships
    no mesh assets)."""
    b = SceneBuilder(env=_gradient_sky())
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, Material.lambertian((0.6, 0.6, 0.6)))
    if obj_path is not None:
        v, f, n = load_obj(obj_path)
    else:
        v, f = trefoil_knot_mesh(target_tris=target_tris)
        n = None
    # centre and scale the mesh to about unit size above the ground
    v = np.asarray(v, np.float32)
    lo, hi = v.min(axis=0), v.max(axis=0)
    v = (v - (lo + hi) / 2.0) / max(hi - lo) * 2.0
    v[:, 1] -= v[:, 1].min()
    b.add_mesh(v, f, Material.metal((0.8, 0.5, 0.2), smoothness=0.7), normals=n,
               chunked=False)
    scene = b.build(build_bvh="tri", device=device)
    cam = look_at(
        (2.6, 1.6, -2.6),
        (0.0, 0.8, 0.0),
        fov_y_deg=35.0,
        focus_distance=4.0,
        defocus_strength=0.0,
        diverge_strength=1.0,
        device=device,
    )
    cfg = RenderConfig(
        width=width, height=height, max_bounce=max_bounce, spp=spp,
        clamp_accumulate=False, intersector="auto",
    )
    return scene, cam, cfg


def flythrough_cameras(num_frames: int, width=3840, height=2160,
                       device=DEFAULT_DEVICE):
    """BASELINE config 5: 4K fly-through with defocus blur. Returns the RTIOW
    scene plus a camera for each frame along a circular dolly path, on
    ``device``."""
    scene, _, _ = rtiow_final_scene(width=width, height=height, device=device)
    cams = []
    for i in range(num_frames):
        t = i / max(num_frames - 1, 1)
        ang = 0.35 * np.sin(2 * np.pi * t)
        r = 13.6 - 2.0 * t
        pos = (r * np.cos(ang + 0.23), 2.0 + 0.7 * np.sin(2 * np.pi * t),
               r * np.sin(ang + 0.23))
        cams.append(
            look_at(
                pos,
                (0.0, 0.5, 0.0),
                fov_y_deg=26.0,
                focus_distance=float(np.linalg.norm(pos)) - 3.0,
                defocus_strength=40.0,
                diverge_strength=1.0,
                device=device,
            )
        )
    cfg = RenderConfig(
        width=width, height=height, max_bounce=4, spp=1, clamp_accumulate=False
    )
    return scene, cams, cfg
