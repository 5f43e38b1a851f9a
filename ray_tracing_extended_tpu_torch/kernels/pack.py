"""Sphere clustering for the path-trace kernel's sphere scan, on the host in
NumPy.

Counterpart of ``ray_tracing_extended_tpu/kernels/pack.py``, of which it
copies what the sphere scan needs, so both packages build identical arrays
from the same spheres:

  * real spheres are Morton-sorted by centre into sub-clusters of ``SUB``,
    refined by a balanced capacity-``SUB`` k-means whose best iteration is
    chosen by summed cluster-AABB surface area (``_cluster_slots``); each
    sub-cluster carries one AABB, which gates its spheres behind a slab
    test;
  * oversized spheres (the RTIOW r=1000 ground and its three r=1 heroes),
    whose box could never cull and would inflate their neighbours', are
    hoisted out and tested first, so that their hit bounds every later
    slab test (``_hoist_candidates``);
  * dead slots carry r^2 = -1e30: the discriminant goes negative, no
    ``r > 0`` test is needed.

The super-cluster boxes of spheres are built from these sub-clusters by
``kernels/megakernel.py`` (``sphere_tables``: one box over each run of 32
of the port's clusters), and a launch visits both levels nearest box first
from its camera (``front_to_back``). Left out, because they serve TPU
mechanisms the CUDA kernel has no use for: the triangle sub-clusters (the
kernel gates triangles by the scene's chunks or walks its BVH), the fetch
tables (``fetch_tab``, ``fetch_tab2``, ``sph_attr``, ``tri_attr``: operands
of the one-hot and winner fetches; a CUDA thread reads its winner's row by
index) and ``features`` (code specialisation at trace time), but for the
rule that names the fields its one-hot fetch reads (``scene_features``,
``fetch_fields``): the profiling knob ``stub_fetch`` returns a constant a
field by its place in that list. The JAX
package drops the hoist when it would leave the regular spheres in more
than one super-cluster, because only its flat sub loop can skip the
trailing hoisted block; the port tests the hoisted spheres before either
level, so that guard has no counterpart here and every scene keeps its
hoist (without it RTIOW's r = 1000 ground would sit in a cluster whose box
every ray enters).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..accel.bvh import _morton3
from ..models.geometry import FLAG_CHECKER, FLAG_DIELECTRIC, FLAG_INVISIBLE_LIGHT

# Sphere slots are laid out in blocks of this many (the JAX package's
# lane-wide cluster): the regular spheres pad up to one, the hoisted block
# is one.
CLUSTER = 128

# Spheres a sub-cluster.
SUB = 32

# _cluster_slots only attempts k-means up to this sub-cluster count; above
# it the plain Morton runs are kept.
KMEANS_MAX_SUBS = 64


@dataclasses.dataclass
class SpherePack:
    """The sphere tables of the JAX package's ``PackedScene``."""

    # (S_pad,) int32: the original sphere index of every slot (dead slots
    # repeat a live member)
    perm: np.ndarray
    # (NSs, SUB, 8) f32: cx, cy, cz, r, r^2 (-1e30 on dead slots), pad 3
    sph_sub_cols: np.ndarray
    # (NSs, 8) f32: min xyz, max xyz, pad 2; zeros for an all-dead sub
    sph_sub_bounds: np.ndarray
    # (max(1, n_hoist) * 8,) f32: cx, cy, cz, r^2, slot base, slot offset
    hoist_params: np.ndarray
    n_hoist: int
    # subs [n_sphere_subs_visit, n_sphere_subs) hold the hoisted spheres
    n_sphere_subs_visit: int
    n_sphere_subs: int


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    denom = np.where(hi > lo, hi - lo, 1.0)
    scale = np.where(hi > lo, 1023.0 / denom, 0.0)
    q = np.clip((centroids - lo) * scale, 0, 1023).astype(np.uint32)
    return np.argsort(_morton3(q), kind="stable").astype(np.int32)


def _cluster_sa(assign, lo, hi, k):
    """Summed surface area of the k cluster AABBs under ``assign``."""
    mn = np.full((k, 3), np.inf)
    mx = np.full((k, 3), -np.inf)
    np.minimum.at(mn, assign, lo)
    np.maximum.at(mx, assign, hi)
    d = np.maximum(mx - mn, 0.0)
    d[~np.isfinite(d)] = 0.0
    return float(
        (2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                + d[:, 2] * d[:, 0])).sum()
    )


def _greedy_capacity(d2, k):
    """Capacity-SUB cluster assignment: points choose in decreasing margin
    (distance to the second-nearest minus to the nearest cluster) order,
    each taking its nearest cluster with room left. Deterministic: stable
    sorts, the point index breaks ties."""
    n = d2.shape[0]
    near = np.argsort(d2, axis=1, kind="stable")
    margin = d2[np.arange(n), near[:, 1]] - d2[np.arange(n), near[:, 0]]
    prio = np.argsort(-margin, kind="stable")
    cap = [SUB] * k
    assign = np.full(n, -1, np.int32)
    near_l = near.tolist()
    for p in prio.tolist():
        for cand in near_l[p]:
            if cap[cand] > 0:
                assign[p] = cand
                cap[cand] -= 1
                break
    return assign


def _morton_runs(morder, n, k):
    pad = k * SUB - n
    slots = np.concatenate(
        [morder, np.full(pad, morder[-1], np.int32)]
    ).astype(np.int32)
    return slots, np.arange(k * SUB) < n


def _cluster_slots(lo: np.ndarray, hi: np.ndarray, *, iters: int = 24):
    """Partition primitives (given their AABBs) into SUB-sized sub-clusters
    laid out as slot blocks: ``(slots, live)``, where ``slots`` is a
    ``(k * SUB,)`` int32 array of positions into the input (each block of
    SUB is one cluster; dead slots repeat a live member of it) and ``live``
    marks the real entries.

    Morton-initialised balanced k-means over box centres with a greedy
    capacity-SUB assignment an iteration; the winning iteration is the one
    of least summed cluster-AABB surface area, which the slab cull's visit
    probability tracks. If no iteration beats the Morton runs, those are
    kept. Clusters, and members within a cluster, end Morton-ordered.
    Deterministic (stable sorts, a fixed iteration count, no random
    numbers)."""
    cent = ((lo + hi) * 0.5).astype(np.float32)
    n = len(cent)
    k = -(-n // SUB)
    morder = _morton_order(cent)
    if k <= 1 or k > KMEANS_MAX_SUBS:
        return _morton_runs(morder, n, k)

    pts64 = cent.astype(np.float64)

    def centres(assign):
        cnt = np.bincount(assign, minlength=k).astype(np.float64)
        cc = np.zeros((k, 3), np.float64)
        np.add.at(cc, assign, pts64)
        return cc / np.maximum(cnt, 1.0)[:, None]

    assign = np.empty(n, np.int32)
    assign[morder] = (np.arange(n) // SUB).astype(np.int32)
    best_assign = assign
    best_sa = init_sa = _cluster_sa(assign, lo, hi, k)
    for _ in range(iters):
        cc = centres(assign)
        d2 = ((pts64[:, None, :] - cc[None, :, :]) ** 2).sum(-1)
        newa = _greedy_capacity(d2, k)
        # every cluster is a candidate and the capacity covers n, so the
        # greedy lands every point
        if (newa < 0).any():
            raise AssertionError("a sphere was left without a cluster")
        if np.array_equal(newa, assign):
            break
        assign = newa
        sa = _cluster_sa(assign, lo, hi, k)
        if sa < best_sa:
            best_sa = sa
            best_assign = assign

    if best_sa >= init_sa:
        return _morton_runs(morder, n, k)

    assign = best_assign
    corder = _morton_order(centres(assign).astype(np.float32))
    slots = np.empty(k * SUB, np.int32)
    live = np.zeros(k * SUB, bool)
    for p, j in enumerate(corder.tolist()):
        members = np.nonzero(assign == j)[0]
        members = members[_morton_order(cent[members])]
        m = len(members)
        base = p * SUB
        slots[base: base + m] = members
        slots[base + m: base + SUB] = members[-1]
        live[base: base + m] = True
    return slots, live


def _hoist_candidates(centers, radii, real_s) -> list:
    """Spheres so large that their sub-cluster's box could never cull. Up
    to 4, biggest first: a radius over the largest extent of the union box
    of all other real spheres (the r=1000 ground), or, among more than 16
    spheres, over 4x the median real radius (RTIOW's three r=1 heroes among
    its r=0.2 grid)."""
    if len(real_s) <= 2:
        return []
    chosen: list = []
    by_r = real_s[np.argsort(-radii[real_s], kind="stable")]
    med = float(np.median(radii[real_s]))
    for k in by_r[:4]:
        others = np.array([i for i in by_r if i != k and i not in chosen])
        if len(others) == 0:
            break
        omin = (centers[others] - radii[others, None]).min(axis=0)
        omax = (centers[others] + radii[others, None]).max(axis=0)
        if radii[k] > float((omax - omin).max()) or (
            len(real_s) > 16 and radii[k] > 4.0 * med
        ):
            chosen.append(int(k))
    return chosen


def pack_spheres(centers: np.ndarray, radii: np.ndarray) -> SpherePack:
    """The sphere half of the JAX package's ``pack_scene``: ``centers``
    (S, 3) and ``radii`` (S,) f32 of a scene's sphere arrays, padding
    spheres (radius <= 0) included."""
    centers = np.asarray(centers, np.float32)
    radii = np.asarray(radii, np.float32)
    real_s = np.nonzero(radii > 0)[0]
    hoist = _hoist_candidates(centers, radii, real_s)
    n_hoist, nss_visit, hoist_params = 0, None, np.zeros(8, np.float32)

    if hoist:
        # layout: [clustered regular spheres | pad][hoisted | pad]: the
        # hoisted block is one trailing CLUSTER
        reg = np.array([i for i in real_s if i not in set(hoist)], np.int64)
        s_pad_reg = -(-len(reg) // CLUSTER) * CLUSTER
        rr = radii[reg][:, None]
        slots, live = _cluster_slots(centers[reg] - rr, centers[reg] + rr)
        src = reg[slots]
        s_pad = s_pad_reg + CLUSTER
        c = np.zeros((s_pad, 3), np.float32)
        r = np.full((s_pad,), -1.0, np.float32)
        perm = np.full((s_pad,), hoist[-1], np.int32)
        c[: len(src)] = centers[src]
        c[len(src): s_pad_reg] = centers[src[-1]]
        r[: len(src)] = np.where(live, radii[src], -1.0)
        perm[: len(src)] = src
        c[s_pad_reg:] = centers[hoist[-1]]
        n_hoist = len(hoist)
        nss_visit = s_pad_reg // SUB
        hoist_params = np.zeros((n_hoist * 8,), np.float32)
        for j, k in enumerate(hoist):
            slot = s_pad_reg + j
            c[slot] = centers[k]
            r[slot] = radii[k]
            perm[slot] = k
            hoist_params[j * 8: j * 8 + 6] = [
                centers[k][0], centers[k][1], centers[k][2],
                radii[k] * radii[k],
                float((slot // SUB) * SUB), float(slot % SUB),
            ]
    elif len(real_s):
        rr = radii[real_s][:, None]
        slots, live = _cluster_slots(
            centers[real_s] - rr, centers[real_s] + rr
        )
        src = real_s[slots]
        s_pad = -(-len(real_s) // CLUSTER) * CLUSTER
        c = np.zeros((s_pad, 3), np.float32)
        r = np.full((s_pad,), -1.0, np.float32)
        perm = np.full((s_pad,), src[-1], np.int32)
        c[: len(src)] = centers[src]
        c[len(src):] = centers[src[-1]]
        r[: len(src)] = np.where(live, radii[src], -1.0)
        perm[: len(src)] = src
    else:
        s_pad = CLUSTER
        c = np.zeros((s_pad, 3), np.float32)
        r = np.full((s_pad,), -1.0, np.float32)
        perm = np.zeros((s_pad,), np.int32)

    nss = s_pad // SUB
    cols = np.zeros((nss, SUB, 8), np.float32)
    cols[:, :, 0:3] = c.reshape(nss, SUB, 3)
    cols[:, :, 3] = r.reshape(nss, SUB)
    cols[:, :, 4] = np.where(r > 0, r * r, -1e30).reshape(nss, SUB)
    bounds = np.zeros((nss, 8), np.float32)
    for k in range(nss):
        cs = c[k * SUB: (k + 1) * SUB]
        rs = r[k * SUB: (k + 1) * SUB]
        live = rs > 0
        if live.any():
            rr = rs[live][:, None]
            bounds[k, :3] = (cs[live] - rr).min(axis=0)
            bounds[k, 3:6] = (cs[live] + rr).max(axis=0)
    return SpherePack(
        perm=perm, sph_sub_cols=cols, sph_sub_bounds=bounds,
        hoist_params=hoist_params, n_hoist=int(n_hoist),
        n_sphere_subs_visit=int(nss if nss_visit is None else nss_visit),
        n_sphere_subs=int(nss),
    )


def scene_features(flags: np.ndarray, emission_strength: np.ndarray,
                   tri_n: np.ndarray, normal_a: np.ndarray,
                   normal_b: np.ndarray, normal_c: np.ndarray) -> tuple:
    """The JAX package's ``PackedScene.features`` that decide its fetch
    fields (``pack_scene``, ``kernels/pack.py:489-517``), from a scene's
    material flags and emission strengths and its triangles' geometric and
    vertex normals: ``"tris"`` where a triangle is real (a nonzero
    geometric normal), ``"vnormals"`` where a real one's three vertex
    normals differ, then ``"dielectric"``, ``"checker"``, ``"invisible"``
    for a material of that flag, ``"emissive"`` for an emission strength
    above 0. (``"env"`` and ``"sun"`` decide no field and are left out.)"""
    feats = []
    real = (np.asarray(tri_n) ** 2).sum(axis=1) > 0
    if real.any():
        feats.append("tris")
        na, nb, nc = (np.asarray(x)[real] for x in (normal_a, normal_b,
                                                      normal_c))
        if not (np.array_equal(na, nb) and np.array_equal(nb, nc)):
            feats.append("vnormals")
    flags = np.asarray(flags)
    for flag, name in ((FLAG_DIELECTRIC, "dielectric"),
                       (FLAG_CHECKER, "checker"),
                       (FLAG_INVISIBLE_LIGHT, "invisible")):
        if (flags == flag).any():
            feats.append(name)
    if (np.asarray(emission_strength) > 0).any():
        feats.append("emissive")
    return tuple(feats)


def fetch_fields(features) -> tuple:
    """The fields of the JAX package's one-hot fetch for a scene of
    ``features``, in its order (``pack_scene``'s ``fetch_fields``,
    ``kernels/pack.py:623-646``): what a segment's winner fetch reads."""
    fields = [
        "col_r", "col_g", "col_b",
        "spec_r", "spec_g", "spec_b",
        "smooth", "sprob",
        "scx", "scy", "scz", "sr2",
    ]
    if "emissive" in features or "checker" in features:
        fields += ["em_r", "em_g", "em_b"]
    if "emissive" in features:
        fields += ["estr"]
    if {"checker", "invisible", "dielectric"} & set(features):
        fields += ["flag"]
    if "dielectric" in features:
        fields += ["ior"]
    if "tris" in features:
        fields += ["is_sph"]
        bases = ["pa", "gn", "na"]
        if "vnormals" in features:
            bases += ["nb", "nc"]
            bases += ["eab", "eac"]
        for base in bases:
            fields += [f"{base}_x", f"{base}_y", f"{base}_z"]
    return tuple(fields)
