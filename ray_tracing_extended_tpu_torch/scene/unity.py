"""Unity scene (.unity YAML) importer: the reference's scenes, read as its
frame scan reads them (RayTracingManager.CreateSpheres/CreateMeshes,
RayTracingManager.cs:135-187).

Counterpart of ``ray_tracing_extended_tpu/scene/unity.py``, computed the
same way in NumPy float64 (the transforms) and float32 (the arrays), so
both packages build identical scene arrays from a file; only the finished
scene, camera and environment become tensors, on ``device``.

  * ``RayTracedSphere`` components -> spheres at the world position with
    radius localScale.x * 0.5 (RayTracingManager.cs:178) and their
    serialized RayTracingMaterial;
  * ``RayTracedMesh`` components -> the cached ``localChunks`` (the
    MeshSplitter output Unity serialized, RayTracedMesh.cs:14) moved to
    world space as UpdateWorldChunkFromLocal does (RayTracedMesh.cs:56-84),
    a material per chunk by subMeshIndex (RayTracingManager.cs:149);
  * the ``RayTracingManager`` -> RenderConfig fields and the environment;
  * the enabled ``Camera`` and its transform -> the camera;
  * the directional ``Light`` -> the sun direction (-forward,
    RayTracing.shader:247).

Transforms compose through ``m_Father`` chains and prefab instances
(nested ``.prefab`` assets found by GUID beside the scene, FBX-sourced
prefabs through ``scene/fbx.py``). PyYAML reads the documents; it is
imported when a scene is read, so the package imports without it, and a
machine without it gets an ImportError that says so.
"""

from __future__ import annotations

import dataclasses
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from ..models.geometry import Environment
from ..models.scene import Material, SceneBuilder
from ..ops.camera import camera_from_matrix
from ..utils.config import RenderConfig
from ..utils.device import DEFAULT_DEVICE
from .fbx import _model_trs, _parse

GUID_SPHERE = "52a9ac6d93ef8ff438ff410be33e635a"  # RayTracedSphere.cs.meta
GUID_MESH = "da1318d85859d584682b30dbc26ca9f6"  # RayTracedMesh.cs.meta
GUID_MANAGER = "68c390cdf7a860745bbbdeccd7d206a9"  # RayTracingManager.cs.meta

_DOC_RE = re.compile(r"^--- !u!(\d+) &(\d+)( stripped)?\s*$", re.M)


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "reading a .unity scene needs PyYAML (the yaml module), which "
            "this Python does not have; render the scene's JSON mirror "
            "instead (scene/export.py writes one)"
        ) from e
    return yaml


def _parse_unity_yaml(text: str):
    """-> {fileID: (class_id, body_dict)}"""
    yaml = _yaml()
    docs = {}
    matches = list(_DOC_RE.finditer(text))
    for i, m in enumerate(matches):
        class_id = int(m.group(1))
        file_id = int(m.group(2))
        start = m.end()
        end = matches[i + 1].start() if i + 1 < len(matches) else len(text)
        # libyaml's C loader where there is one: ~10x faster on the
        # reference's biggest scene (Chess.unity, ~30k YAML lines)
        body = yaml.load(
            text[start:end],
            Loader=getattr(yaml, "CSafeLoader", yaml.SafeLoader),
        )
        if isinstance(body, dict) and len(body) == 1:
            body = next(iter(body.values()))
        docs[file_id] = (class_id, body)
    return docs


def _v3(d, default=(0.0, 0.0, 0.0)):
    if not isinstance(d, dict):
        return np.asarray(default, np.float64)
    return np.asarray([d.get("x", 0), d.get("y", 0), d.get("z", 0)], np.float64)


def _colour(d):
    return (float(d.get("r", 1)), float(d.get("g", 1)), float(d.get("b", 1)))


def _quat_matrix(q):
    x, y, z, w = (q.get("x", 0), q.get("y", 0), q.get("z", 0), q.get("w", 1))
    n = max(np.sqrt(x * x + y * y + z * z + w * w), 1e-20)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _trs_with_mods(mods, d_pos, d_rot, d_scale):
    """Apply a PrefabInstance modification dict (propertyPath -> value)
    for ONE transform over its default local TRS."""

    def getf(path, default):
        v = mods.get(path)
        try:
            return float(v)
        except (TypeError, ValueError):
            return default

    pos = np.array(
        [
            getf("m_LocalPosition.x", d_pos[0]),
            getf("m_LocalPosition.y", d_pos[1]),
            getf("m_LocalPosition.z", d_pos[2]),
        ]
    )
    scale = np.array(
        [
            getf("m_LocalScale.x", d_scale[0]),
            getf("m_LocalScale.y", d_scale[1]),
            getf("m_LocalScale.z", d_scale[2]),
        ]
    )
    if any(f"m_LocalRotation.{a}" in mods for a in "xyzw"):
        rot = _quat_matrix(
            {
                a: getf(f"m_LocalRotation.{a}", 1.0 if a == "w" else 0.0)
                for a in "xyzw"
            }
        )
    else:
        rot = d_rot
    return pos, rot, scale


class _SceneDocs:
    def __init__(self, docs, scene_path=None):
        self.docs = docs
        self.scene_path = Path(scene_path) if scene_path else None
        self.transforms = {
            fid: b for fid, (cid, b) in docs.items() if cid == 4
        }
        # transform fileID by owning GameObject
        self.tf_of_go = {}
        for fid, b in self.transforms.items():
            go = (b.get("m_GameObject") or {}).get("fileID")
            if go:
                self.tf_of_go[go] = fid
        self.prefab_instances = {
            fid: b for fid, (cid, b) in docs.items() if cid == 1001
        }
        # stripped GameObject -> owning PrefabInstance, and -> its
        # corresponding source object INSIDE the prefab asset (used to
        # compose child transforms for nested prefabs)
        self.prefab_of_go = {}
        self.src_of_go = {}
        for fid, (cid, b) in docs.items():
            if cid == 1 and isinstance(b, dict):
                pi = (b.get("m_PrefabInstance") or {}).get("fileID")
                if pi:
                    self.prefab_of_go[fid] = pi
                src = (
                    b.get("m_CorrespondingSourceObject") or {}
                ).get("fileID")
                if src:
                    self.src_of_go[fid] = src
        self._prefab_cache: dict = {}
        self._guid_map: dict | None = None

    def root_transform(self):
        """fileID of the transform with no father (prefab asset root)."""
        for fid, b in self.transforms.items():
            if not ((b.get("m_Father") or {}).get("fileID") or 0):
                return fid
        return None

    def _prefab_docs(self, prefab_id):
        """Parsed source .prefab asset for a PrefabInstance (cached by
        guid); None for FBX-sourced or missing prefabs."""
        body = self.prefab_instances.get(prefab_id)
        if body is None:
            return None
        src_guid = ((body.get("m_SourcePrefab") or {}).get("guid")) or ""
        asset = self._asset_for_guid(src_guid)
        if asset is None or asset.suffix.lower() != ".prefab":
            return None
        if src_guid not in self._prefab_cache:
            try:
                self._prefab_cache[src_guid] = _SceneDocs(
                    _parse_unity_yaml(asset.read_text()), asset
                )
            except OSError:
                self._prefab_cache[src_guid] = None
        return self._prefab_cache[src_guid]

    def _mods_by_target(self, prefab_id):
        """PrefabInstance m_Modifications grouped by target fileID (the
        source prefab's object the override applies to)."""
        body = self.prefab_instances.get(prefab_id) or {}
        out: dict = {}
        for m in (body.get("m_Modification") or {}).get(
            "m_Modifications"
        ) or []:
            t = (m.get("target") or {}).get("fileID") or 0
            out.setdefault(t, {})[m.get("propertyPath", "")] = m.get(
                "value"
            )
        return out

    def _prefab_trs(self, prefab_id):
        """Local TRS of a prefab instance ROOT: m_Modifications targeting
        the root transform override the source prefab's defaults. For
        FBX-sourced prefabs (the reference's mesh assets) the default root
        scale/rotation come from the FBX Model node (Unity keeps the
        file's Lcl Scaling - e.g. 100 - on the prefab root while baking
        FileScale into the mesh); for .prefab sources the defaults come
        from the serialized root transform and only root-targeted
        modifications apply (child-targeted ones compose in
        _prefab_child_world_trs)."""
        body = self.prefab_instances.get(prefab_id)
        if body is None:
            return np.zeros(3), np.eye(3), np.ones(3)
        src_guid = ((body.get("m_SourcePrefab") or {}).get("guid")) or ""

        d_pos = np.zeros(3)
        d_rot = np.eye(3)
        d_scale = np.ones(3)
        pd = self._prefab_docs(prefab_id)
        if pd is not None:
            root_tf = pd.root_transform()
            rb = pd.transforms.get(root_tf) or {}
            d_pos = _v3(rb.get("m_LocalPosition"))
            d_rot = _quat_matrix(rb.get("m_LocalRotation") or {})
            d_scale = _v3(rb.get("m_LocalScale"), (1, 1, 1))
            mods = self._mods_by_target(prefab_id).get(root_tf, {})
        else:
            # FBX source: one model, every modification addresses the
            # root, so the merged view is exact
            mods = {}
            for tmods in self._mods_by_target(prefab_id).values():
                mods.update(tmods)
            asset = self._asset_for_guid(src_guid)
            if asset is not None and asset.suffix.lower() == ".fbx":
                # an asset that does not read keeps the identity defaults
                try:
                    root, _ = _parse(asset.read_bytes())
                    for top in root.children:
                        if top.name == "Objects":
                            for node in top.children:
                                if node.name == "Model":
                                    d_pos, d_rot, d_scale = _model_trs(
                                        node
                                    )
                                    break
                except (OSError, ValueError, IndexError, KeyError,
                        TypeError, struct.error, zlib.error):
                    pass

        pos, rot, scale = _trs_with_mods(mods, d_pos, d_rot, d_scale)
        parent = (
            (body.get("m_Modification") or {}).get("m_TransformParent") or {}
        ).get("fileID") or 0
        if parent:
            p_pos, p_rot, p_scale = self._trs_of_transform(parent)
            pos = p_pos + p_rot @ (p_scale * pos)
            rot = p_rot @ rot
            scale = p_scale * scale
        return pos, rot, scale

    def _prefab_child_world_trs(self, prefab_id, src_go_fid):
        """World TRS of a prefab-instance CHILD object: the instance root
        TRS composed with the child's transform chain inside the source
        prefab, each node's serialized locals overridden by modifications
        targeting that node's transform (a stripped child is not placed
        at the root's TRS)."""
        pd = self._prefab_docs(prefab_id)
        if pd is None:
            return self._prefab_trs(prefab_id)
        tf_id = pd.tf_of_go.get(src_go_fid)
        if tf_id is None:
            return self._prefab_trs(prefab_id)
        mods = self._mods_by_target(prefab_id)
        chain = []
        cur = tf_id
        while cur:
            tb = pd.transforms.get(cur)
            if tb is None:
                break
            father = (tb.get("m_Father") or {}).get("fileID") or 0
            if not father:
                break  # cur is the prefab root - handled by _prefab_trs
            chain.append((cur, tb))
            cur = father
        pos, rot, scale = self._prefab_trs(prefab_id)
        for fid, tb in reversed(chain):
            lp, lr, ls = _trs_with_mods(
                mods.get(fid, {}),
                _v3(tb.get("m_LocalPosition")),
                _quat_matrix(tb.get("m_LocalRotation") or {}),
                _v3(tb.get("m_LocalScale"), (1, 1, 1)),
            )
            pos = pos + rot @ (scale * lp)
            rot = rot @ lr
            scale = scale * ls
        return pos, rot, scale

    def _asset_for_guid(self, guid):
        if not guid or self.scene_path is None:
            return None
        # Assets root = .../Assets/...; scan *.meta once
        root = self.scene_path.parent
        while root.name and root.name != "Assets":
            root = root.parent
        if not root.name:
            return None
        if self._guid_map is None:
            self._guid_map = {}
            for meta in root.rglob("*.meta"):
                try:
                    for line in meta.read_text().splitlines():
                        if line.startswith("guid:"):
                            self._guid_map[line.split()[1]] = meta.with_suffix(
                                ""
                            )
                            break
                except OSError:
                    pass
        return self._guid_map.get(guid)

    def _trs_of_transform(self, tf_id):
        chain = []
        while tf_id:
            b = self.transforms.get(tf_id)
            if b is None:
                break
            chain.append(b)
            tf_id = (b.get("m_Father") or {}).get("fileID") or 0
        pos = np.zeros(3)
        rot = np.eye(3)
        scale = np.ones(3)
        for b in reversed(chain):
            lp = _v3(b.get("m_LocalPosition"))
            lr = _quat_matrix(b.get("m_LocalRotation") or {})
            ls = _v3(b.get("m_LocalScale"), (1, 1, 1))
            pos = pos + rot @ (scale * lp)
            rot = rot @ lr
            scale = scale * ls  # lossyScale approximation (no shear)
        return pos, rot, scale

    def world_trs(self, go_file_id):
        """Compose world (pos, rot 3x3, scale 3) through the parent chain,
        resolving stripped prefab-instance objects."""
        tf_id = self.tf_of_go.get(go_file_id)
        if tf_id is None and go_file_id in self.prefab_of_go:
            pid = self.prefab_of_go[go_file_id]
            src = self.src_of_go.get(go_file_id)
            if src:
                return self._prefab_child_world_trs(pid, src)
            return self._prefab_trs(pid)
        return self._trs_of_transform(tf_id)


def _material_from(d) -> Material:
    return Material(
        colour=_colour(d.get("colour", {})),
        emission_colour=_colour(d.get("emissionColour", {})),
        specular_colour=_colour(d.get("specularColour", {})),
        emission_strength=float(d.get("emissionStrength", 0.0)),
        smoothness=float(d.get("smoothness", 0.0)),
        specular_probability=float(d.get("specularProbability", 1.0)),
        flag=int(d.get("flag", 0)),
    )


def unity_scene_spec(path) -> dict:
    """Parse a .unity scene into a neutral spec (the shared front half of
    ``load_unity_scene`` and ``scene/export.py``'s JSON mirror writer):

    * ``env``: Environment (CPU tensors)
    * ``cfg_kw``: RenderConfig kwargs from the manager (max_bounce, spp)
    * ``spheres``: [(position (3,) f32, radius float, Material)]
    * ``tri_groups``: [((N, 3, 3) world positions, (N, 3, 3) world
      normals, Material)] - the serialized localChunks after the
      reference's per-frame world transform (RayTracedMesh.cs:42-51)
    * ``camera``: camera_from_matrix kwargs, or None
    """
    text = Path(path).read_text()
    docs = _parse_unity_yaml(text)
    sd = _SceneDocs(docs, scene_path=path)

    manager = None
    spheres = []
    meshes = []
    camera_doc = None
    light_dirs = []

    for fid, (cid, body) in docs.items():
        if cid == 114 and isinstance(body, dict):  # MonoBehaviour
            guid = (body.get("m_Script") or {}).get("guid", "")
            if guid == GUID_MANAGER:
                manager = body
            elif guid == GUID_SPHERE:
                spheres.append(body)
            elif guid == GUID_MESH:
                meshes.append(body)
        elif cid == 20 and isinstance(body, dict):  # Camera
            if body.get("m_Enabled", 1):
                camera_doc = body
        elif cid == 108 and isinstance(body, dict):  # Light
            if body.get("m_Type", 1) == 1:  # directional
                go = (body.get("m_GameObject") or {}).get("fileID")
                if go:
                    _, rot, _ = sd.world_trs(go)
                    light_dirs.append(-rot[:, 2])  # -forward = toward sun

    # ---- environment / config (RayTracingManager fields) ----
    env = Environment.disabled()
    cfg_kw = {}
    if manager is not None:
        es = manager.get("environmentSettings") or {}
        sun_dir = (
            light_dirs[0]
            if light_dirs
            else np.array([0.0, 1.0, 0.0])
        )
        sun_dir = sun_dir / max(np.linalg.norm(sun_dir), 1e-20)

        def f32(v):
            return torch.from_numpy(np.array(v, np.float32))

        env = Environment(
            enabled=f32(1.0 if es.get("enabled", 0) else 0.0),
            ground_colour=f32(_colour(es.get("groundColour", {}))),
            sky_colour_horizon=f32(_colour(es.get("skyColourHorizon", {}))),
            sky_colour_zenith=f32(_colour(es.get("skyColourZenith", {}))),
            sun_focus=f32(max(1.0, float(es.get("sunFocus", 1)))),
            sun_intensity=f32(max(0.0, float(es.get("sunIntensity", 0)))),
            sun_dir=f32(sun_dir),
        )
        cfg_kw = dict(
            max_bounce=int(manager.get("maxBounceCount", 4)),
            spp=max(1, int(manager.get("numRaysPerPixel", 2))),
        )

    # ---- spheres (RayTracingManager.cs:167-187) ----
    sphere_specs = []
    for s in spheres:
        go = (s.get("m_GameObject") or {}).get("fileID")
        pos, _, scale = sd.world_trs(go)
        sphere_specs.append((
            pos.astype(np.float32),
            float(scale[0]) * 0.5,
            _material_from(s.get("material") or {}),
        ))

    # ---- meshes: serialized localChunks -> world space ----
    tri_groups = []
    for m in meshes:
        go = (m.get("m_GameObject") or {}).get("fileID")
        pos, rot, scale = sd.world_trs(go)
        mats = [_material_from(d) for d in (m.get("materials") or [{}])]
        n_mat = np.linalg.inv(rot * np.maximum(np.abs(scale), 1e-20)).T
        for chunk in m.get("localChunks") or []:
            tris = chunk.get("triangles") or []
            if not tris:
                continue
            sub = int(chunk.get("subMeshIndex", 0))
            mat = mats[min(sub, len(mats) - 1)]
            tp = np.zeros((len(tris), 3, 3), np.float32)
            tn = np.zeros((len(tris), 3, 3), np.float32)
            for i, t in enumerate(tris):
                for j, (pk, nk) in enumerate(
                    (("posA", "normalA"), ("posB", "normalB"),
                     ("posC", "normalC"))
                ):
                    p_l = _v3(t.get(pk))
                    n_l = _v3(t.get(nk))
                    tp[i, j] = rot @ (scale * p_l) + pos
                    nw = n_mat @ n_l
                    tn[i, j] = nw / max(np.linalg.norm(nw), 1e-20)
            tri_groups.append((tp, tn, mat))

    # ---- camera ----
    cam_kw = None
    if camera_doc is not None:
        go = (camera_doc.get("m_GameObject") or {}).get("fileID")
        pos, rot, _ = sd.world_trs(go)
        fov = float(camera_doc.get("field of view", 60.0))
        mgr = manager or {}
        cam_kw = dict(
            position=pos.astype(np.float32),
            rotation=rot.astype(np.float32),
            fov_y_deg=fov,
            focus_distance=max(0.0, float(mgr.get("focusDistance", 1.0))),
            defocus_strength=max(0.0, float(mgr.get("defocusStrength", 0.0))),
            diverge_strength=max(
                0.0, float(mgr.get("divergeStrength", 0.3))
            ),
        )

    return dict(
        env=env,
        cfg_kw=cfg_kw,
        spheres=sphere_specs,
        tri_groups=tri_groups,
        camera=cam_kw,
    )


def load_unity_scene(path, overrides: dict | None = None,
                     device=DEFAULT_DEVICE):
    """Import a .unity scene -> ``(scene, camera, config)``, the scene and
    camera on ``device`` (default the card; raises where CUDA is not
    available unless ``device="cpu"``).

    ``overrides`` replaces RenderConfig fields (the reference renders at
    the window's size; width and height default to 1280x720). As in the
    JAX package, a scene of more than 16,384 triangles gets a triangle
    BVH (on the card the kernel's BVH instantiation); a smaller one is
    scanned by chunk.
    """
    spec = unity_scene_spec(path)

    b = SceneBuilder(env=spec["env"])
    for pos, radius, mat in spec["spheres"]:
        b.add_sphere(pos, radius, mat)
    n_tris = 0
    for tp, tn, mat in spec["tri_groups"]:
        b.add_triangles(tp, tn, mat)
        n_tris += len(tp)
    scene = b.build(build_bvh="tri" if n_tris > 16384 else None,
                    device=device)

    cam = (
        camera_from_matrix(**spec["camera"], device=device)
        if spec["camera"] is not None
        else None
    )

    cfg = RenderConfig(width=1280, height=720, **spec["cfg_kw"])
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return scene, cam, cfg.validate()
