"""The DeepMind Control Suite dog's skin on its floor, as a JSON mirror.

Builds the scene of ``dm_control/suite/dog.xml`` (google-deepmind/dm_control,
Apache-2.0) from its own files and writes it in the repository's mirror
format (``scene/export.write_mirror``: a ``.json`` and its ``.npz`` of
world-baked triangle groups), which ``load_json_scene`` reads::

    python -m ray_tracing_extended_tpu_torch.tools.dmc_dog \\
        [--suite <dm_control/suite>] [--out benchmark/scenes/dmc-dog-skin.json]

The scene, as ``dog.xml`` states it:

- the skin, ``dog_assets/SKINbody.stl`` (33,900 triangles) at rest, diffuse,
  its colour the mean of ``skin_texture.png``'s values (MuJoCo shades with
  a texture's values as stored, as it does with ``rgb`` colours); the 173
  bone meshes, hidden inside it, are left out;
- the floor plane (``size`` 10 10: two triangles 20 m wide) with the
  ``grid`` checker's two colours (``common/materials.xml``) on the port's
  checker flag, whose squares are 1 m (MuJoCo's are 0.5 m);
- the ``y-axis`` camera of the torso body (its ``pos`` and ``xyaxes`` from
  the torso's position, MuJoCo's default ``fovy`` of 45 degrees), a pinhole
  (``defocusStrength`` 0) with a pixel's jitter (``divergeStrength`` 1) and
  its focus at the torso;
- the skybox gradient (``common/skybox.xml``: its top colour the zenith,
  the mean of its two the horizon, its bottom the ground) and a sun
  straight up, where the light above the torso is (``sunFocus`` 500,
  ``sunIntensity`` 200, as ``scenes/balls_outdoors.json``).

MuJoCo's frame is z-up and right-handed; the port's is y-up with the
camera's right ``up x forward`` (Unity's). The map ``(x, y, z) -> (x, z,
y)`` keeps the image unmirrored (the camera's right stays +x, the head on
the same side); it is a reflection, so each triangle's last two corners are
swapped, which keeps its winding's normal pointing out of the skin and its
facets front-facing from outside (the kernel culls back faces). The tool
builds the scene through ``SceneBuilder`` before writing it, and its
triangle count takes ``load_json_scene``'s BVH route.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import torch

from ..models.geometry import FLAG_CHECKER, Environment
from ..models.scene import Material, SceneBuilder
from ..scene.export import write_mirror
from ..scene.mesh_io import load_stl
from ..utils.image import read_png_rgb8

OUT = Path("benchmark/scenes/dmc-dog-skin.json")
MAX_BOUNCE, SPP = 15, 3
FOVY_DEFAULT = 45.0  # MuJoCo's camera default
SUN_FOCUS, SUN_INTENSITY = 500.0, 200.0


def default_suite() -> Path:
    """``dm_control/suite`` of the installed package (not imported)."""
    spec = importlib.util.find_spec("dm_control")
    if spec is None or not spec.submodule_search_locations:
        raise SystemExit("dm_control is not installed: pass --suite")
    return Path(list(spec.submodule_search_locations)[0]) / "suite"


def to_port(p: np.ndarray) -> np.ndarray:
    """MuJoCo's (x, y, z) -> the port's (x, z, y), on the last axis."""
    return np.asarray(p)[..., [0, 2, 1]]


def _floats(text: str) -> np.ndarray:
    return np.array([float(x) for x in text.split()], np.float64)


def _find(root, tag: str, name: str):
    for el in root.iter(tag):
        if el.get("name") == name:
            return el
    raise ValueError(f"no <{tag} name={name!r}>")


def dog_scene_spec(suite) -> dict:
    """The scene of ``suite/dog.xml`` in ``unity_scene_spec``'s form, in
    the port's frame: ``env``, ``cfg_kw``, ``spheres`` (none), ``camera``
    and ``tri_groups`` (the skin, then the floor)."""
    suite = Path(suite)
    dog = ET.parse(suite / "dog.xml").getroot()
    grid = _find(ET.parse(suite / "common" / "materials.xml").getroot(),
                 "texture", "grid")
    sky = _find(ET.parse(suite / "common" / "skybox.xml").getroot(),
                "texture", "skybox")
    assets = suite / dog.find("compiler").get("meshdir")

    # the skin at rest and its colour
    v, f, n = load_stl(assets / "SKINbody.stl")
    skin_pos, skin_nrm = v[f], n[f]
    texels = read_png_rgb8(assets / "skin_texture.png").reshape(-1, 3)
    skin = Material.lambertian(tuple(texels.mean(axis=0) / 255.0))

    # the floor plane, facing +z, in two triangles
    floor = _find(dog, "geom", "floor")
    hx, hy = _floats(floor.get("size"))[:2]
    corners = np.array([[-hx, -hy, 0], [hx, -hy, 0], [hx, hy, 0],
                        [-hx, hy, 0]], np.float32)
    floor_pos = corners[[[0, 1, 2], [0, 2, 3]]]
    floor_nrm = np.broadcast_to(np.float32([0, 0, 1]), floor_pos.shape)
    checker = Material(colour=tuple(_floats(grid.get("rgb1"))),
                       emission_colour=tuple(_floats(grid.get("rgb2"))),
                       specular_probability=0.0, flag=FLAG_CHECKER)

    groups = []
    for pos, nrm, mat in ((skin_pos, skin_nrm, skin),
                          (floor_pos, floor_nrm, checker)):
        # the reflection, and the corners swapped to keep the winding
        groups.append((np.ascontiguousarray(to_port(pos)[:, [0, 2, 1]],
                                            np.float32),
                       np.ascontiguousarray(to_port(nrm)[:, [0, 2, 1]],
                                            np.float32), mat))

    # the y-axis camera, in the torso's frame (at rest, trackcom's offset)
    torso = _find(dog, "body", "torso")
    cam = _find(torso, "camera", "y-axis")
    x_axis, y_axis = _floats(cam.get("xyaxes")).reshape(2, 3)
    x_axis /= np.linalg.norm(x_axis)
    y_axis -= x_axis * (x_axis @ y_axis)
    y_axis /= np.linalg.norm(y_axis)
    forward = -np.cross(x_axis, y_axis)  # MuJoCo looks down -z
    offset = _floats(cam.get("pos"))
    camera = dict(
        position=to_port(_floats(torso.get("pos")) + offset),
        rotation=np.stack([to_port(x_axis), to_port(y_axis),
                           to_port(forward)], axis=-1),
        fov_y_deg=float(cam.get("fovy", FOVY_DEFAULT)),
        focus_distance=float(np.linalg.norm(offset)),
        defocus_strength=0.0, diverge_strength=1.0)

    top, bottom = _floats(sky.get("rgb1")), _floats(sky.get("rgb2"))

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32))

    env = Environment(
        enabled=f32(1.0), ground_colour=f32(bottom),
        sky_colour_horizon=f32((top + bottom) / 2), sky_colour_zenith=f32(top),
        sun_focus=f32(SUN_FOCUS), sun_intensity=f32(SUN_INTENSITY),
        sun_dir=f32(to_port([0.0, 0.0, 1.0])))
    return dict(env=env, spheres=[], camera=camera, tri_groups=groups,
                cfg_kw=dict(max_bounce=MAX_BOUNCE, spp=SPP))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--suite", type=Path, default=None,
                    help="dm_control's suite directory (default: the "
                         "installed package's)")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    spec = dog_scene_spec(args.suite or default_suite())
    # the scene through SceneBuilder, with the BVH that load_json_scene
    # gives a scene of its size
    b = SceneBuilder(env=spec["env"])
    for pos, nrm, mat in spec["tri_groups"]:
        b.add_triangles(pos, nrm, mat)
    scene = b.build(build_bvh="tri", device="cpu")
    write_mirror(spec, args.out,
                 "The DeepMind Control Suite dog (dm_control/suite/dog.xml, "
                 "Apache-2.0): SKINbody.stl at rest on the floor plane, the "
                 "y-axis camera, the skybox; z-up mapped to y-up as (x, z, "
                 "y) with each triangle's last two corners swapped "
                 "(written by ray_tracing_extended_tpu_torch.tools.dmc_dog)")
    print(f"{args.out}: {int(scene.chunks.num_tris.sum())} triangles in "
          f"{len(spec['tri_groups'])} groups, BVH of "
          f"{scene.tri_bvh.left.shape[0]} nodes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
