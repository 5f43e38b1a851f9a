"""Export Unity scenes as self-contained JSON mirrors (a ``.json`` and, for
a scene with meshes, an ``.npz`` beside it).

Counterpart of ``ray_tracing_extended_tpu/scene/export.py``, writing the
same files: the JSON carries the settings, the camera (an explicit
rotation), the environment, the spheres and one material record a mesh
group; the NPZ each group's world-baked triangle soup (the serialized
localChunks after the reference's world transform, RayTracedMesh.cs:42-51),
which is what ``unity_scene_spec`` gives ``SceneBuilder.add_triangles``.
So ``load_json_scene`` of a mirror builds the scene that
``load_unity_scene`` builds from the ``.unity`` file. The shipped
``scenes/*.json`` were written this way. Needs PyYAML, as the importer
does. Regenerate a directory of mirrors with::

    python -m ray_tracing_extended_tpu_torch.scene.export \
        <unity project>/Assets/Scenes scenes/
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from .unity import unity_scene_spec

REFERENCE_SCENES = (
    "Balls Outdoors",
    "Reflective Balls",
    "Chess",
    "Knight",
    "Suzanne",
    "Thumbnail",
)


def _f(x) -> float:
    """Plain float for JSON (np scalars are not JSON-serializable)."""
    return float(np.asarray(x))


def _v(x) -> list:
    return [float(v) for v in np.asarray(x).reshape(-1)]


def _material_dict(mat) -> dict:
    d = {
        "colour": _v(mat.colour),
        "emissionColour": _v(mat.emission_colour),
        "specularColour": _v(mat.specular_colour),
        "emissionStrength": _f(mat.emission_strength),
        "smoothness": _f(mat.smoothness),
        "specularProbability": _f(mat.specular_probability),
        "flag": int(mat.flag),
    }
    if getattr(mat, "ior", 1.0) != 1.0:
        d["ior"] = _f(mat.ior)
    return d


def write_mirror(spec: dict, out_json, comment: str) -> dict:
    """Write ``out_json`` (+ sibling ``.npz`` when ``spec`` has triangle
    groups) from a scene spec in ``unity_scene_spec``'s form (``env``,
    ``cfg_kw``, ``spheres``, ``camera``, ``tri_groups``). Returns the JSON
    spec written."""
    out_json = Path(out_json)
    env = spec["env"]
    out = {
        "comment": comment,
        "settings": {
            "maxBounceCount": int(spec["cfg_kw"].get("max_bounce", 4)),
            "numRaysPerPixel": int(spec["cfg_kw"].get("spp", 2)),
        },
        "environment": {
            "enabled": bool(_f(env.enabled) > 0),
            "groundColour": _v(env.ground_colour),
            "skyColourHorizon": _v(env.sky_colour_horizon),
            "skyColourZenith": _v(env.sky_colour_zenith),
            "sunFocus": _f(env.sun_focus),
            "sunIntensity": _f(env.sun_intensity),
            "sunDirection": _v(env.sun_dir),
        },
        "spheres": [
            {
                "position": _v(pos),
                "radius": float(radius),
                "material": _material_dict(mat),
            }
            for pos, radius, mat in spec["spheres"]
        ],
    }
    if spec["camera"] is not None:
        c = spec["camera"]
        out["camera"] = {
            "position": _v(c["position"]),
            "rotation": [
                _v(row) for row in np.asarray(c["rotation"], np.float32)
            ],
            "fovY": _f(c["fov_y_deg"]),
            "focusDistance": _f(c["focus_distance"]),
            "defocusStrength": _f(c["defocus_strength"]),
            "divergeStrength": _f(c["diverge_strength"]),
        }
    if spec["tri_groups"]:
        npz_path = out_json.with_suffix(".npz")
        arrays = {}
        meshes = []
        for i, (tp, tn, mat) in enumerate(spec["tri_groups"]):
            g = f"g{i:03d}"
            arrays[f"{g}_pos"] = np.asarray(tp, np.float32)
            arrays[f"{g}_nrm"] = np.asarray(tn, np.float32)
            meshes.append({
                "npz": npz_path.name,
                "group": g,
                "material": _material_dict(mat),
            })
        out["meshes"] = meshes
        np.savez_compressed(npz_path, **arrays)
    out_json.write_text(json.dumps(out, indent=1) + "\n")
    return out


def export_unity_scene(unity_path, out_json) -> dict:
    """Write ``out_json`` (+ sibling ``.npz`` when the scene has meshes)
    mirroring ``unity_path``. Returns the JSON spec written."""
    unity_path = Path(unity_path)
    return write_mirror(
        unity_scene_spec(unity_path), out_json,
        f"Mirror of the reference scene '{unity_path.name}' "
        "(generated by ray_tracing_extended_tpu_torch.scene.export; "
        "triangles are world-baked localChunks, "
        "RayTracedMesh.cs:42-51)")


def export_reference_scenes(scenes_dir, out_dir) -> list[Path]:
    """Export all six reference scenes found under ``scenes_dir``."""
    scenes_dir = Path(scenes_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for name in REFERENCE_SCENES:
        src = scenes_dir / f"{name}.unity"
        if not src.exists():
            continue
        dst = out_dir / (name.lower().replace(" ", "_") + ".json")
        export_unity_scene(src, dst)
        written.append(dst)
    return written


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m ray_tracing_extended_tpu_torch.scene.export "
              "<directory of .unity scenes> <output directory>",
              file=sys.stderr)
        return 2
    for p in export_reference_scenes(*argv):
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
