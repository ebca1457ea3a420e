"""Clustered-RL (Q-learning) direct lighting.

Reference: src/clustered_rl.{h,cu} (hash cell -> per-cell pdf/cdf over light
clusters, TD updates, block-parallel CDF rebuilds clustered_rl.cu:39-129),
src/direct_lighting_rl.h:45-180 (preprocess = cell hash lookup, sample =
2-level cluster -> light CDF draw, update = TD update on the occlusion
result), and the VTL clustering of mesh_lights.cu:632-891.

Design:
  * clusters: emissive triangles morton-sorted and partitioned into
    equal-power chunks (the light-BVH-cut analog), host-built once.
  * per-cell Q table (K cells x C clusters) is the renderer state; sampling
    mixes the normalized Q row with a uniform floor (the reference's bias
    mixing) so every light keeps nonzero pdf — unbiasedness preserved.
  * CDF "rebuild" is just a row cumsum at sample time (C is small);
    TD updates are segment-sums over (cell, cluster) pairs — the scatter-add
    replacement for the reference's atomic table updates.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.core.math import Vec3
from fermat_tpu.core.sampling import square_to_uniform_triangle
from fermat_tpu.scene.mesh import MeshView

Array = jax.Array


class RLClusters(NamedTuple):
    """Static cluster tables (host-built; VTL/cluster-cut analog)."""

    tri_cluster: Array  # (T,) i32, -1 = non-emissive
    sorted_tris: Array  # (E,) emissive tris grouped by cluster
    seg_cdf: Array  # (E,) power cdf within each cluster (inclusive, ends at 1)
    cluster_offset: Array  # (C+1,) i32 into sorted_tris
    tri_pdf_area: Array  # (T,) area pdf of the tri GIVEN its cluster
    n_clusters: int  # static


def build_clusters(mesh: MeshView, n_clusters: int = 16) -> RLClusters:
    """Morton-sort emissive tris, partition into equal-power clusters."""
    from fermat_tpu.core.morton import morton3d

    em = mesh.materials.emissive
    mid = np.asarray(mesh.material_id)
    lum = (
        0.2126 * np.asarray(em.x)[mid]
        + 0.7152 * np.asarray(em.y)[mid]
        + 0.0722 * np.asarray(em.z)[mid]
    )
    area = np.asarray(mesh.triangle_areas())
    power = lum * area
    T = mid.shape[0]
    emissive = np.nonzero(power > 0)[0]
    if emissive.size == 0:
        z = np.zeros(0, np.int32)
        return RLClusters(
            tri_cluster=jnp.full(T, -1, jnp.int32),
            sorted_tris=jnp.asarray(z),
            seg_cdf=jnp.zeros(0, jnp.float32),
            cluster_offset=jnp.zeros(n_clusters + 1, jnp.int32),
            tri_pdf_area=jnp.zeros(T, jnp.float32),
            n_clusters=n_clusters,
        )
    # morton order of centroids
    cx = np.asarray(mesh.p0.x) + (np.asarray(mesh.e1.x) + np.asarray(mesh.e2.x)) / 3
    cy = np.asarray(mesh.p0.y) + (np.asarray(mesh.e1.y) + np.asarray(mesh.e2.y)) / 3
    cz = np.asarray(mesh.p0.z) + (np.asarray(mesh.e1.z) + np.asarray(mesh.e2.z)) / 3
    c = np.stack([cx[emissive], cy[emissive], cz[emissive]], 1)
    lo, hi = c.min(0), c.max(0)
    ext = np.maximum(hi - lo, 1e-12)
    codes = np.asarray(
        morton3d(*(jnp.asarray((c[:, a] - lo[a]) / ext[a]) for a in range(3)))
    )
    order = emissive[np.argsort(codes)]
    # equal-power partition into n_clusters chunks
    p_sorted = power[order]
    cum = np.cumsum(p_sorted)
    total = cum[-1]
    cluster_of_sorted = np.minimum(
        (cum / total * n_clusters - 1e-9).astype(np.int32), n_clusters - 1
    )
    tri_cluster = np.full(T, -1, np.int32)
    tri_cluster[order] = cluster_of_sorted
    offsets = np.zeros(n_clusters + 1, np.int64)
    for cl in range(n_clusters):
        offsets[cl + 1] = offsets[cl] + int((cluster_of_sorted == cl).sum())
    # within-cluster power cdf + per-tri conditional area pdf
    seg_cdf = np.zeros(order.size, np.float32)
    tri_pdf = np.zeros(T, np.float32)
    for cl in range(n_clusters):
        a, b = int(offsets[cl]), int(offsets[cl + 1])
        if b > a:
            w = p_sorted[a:b]
            wsum = w.sum()
            seg_cdf[a:b] = np.cumsum(w) / max(wsum, 1e-20)
            tris = order[a:b]
            tri_pdf[tris] = (w / max(wsum, 1e-20)) / np.maximum(area[tris], 1e-20)
    return RLClusters(
        tri_cluster=jnp.asarray(tri_cluster),
        sorted_tris=jnp.asarray(order.astype(np.int32)),
        seg_cdf=jnp.asarray(seg_cdf),
        cluster_offset=jnp.asarray(offsets.astype(np.int32)),
        tri_pdf_area=jnp.asarray(tri_pdf),
        n_clusters=n_clusters,
    )


class RLState(NamedTuple):
    """Per-cell Q values (ClusteredRLStorage analog)."""

    q: Array  # (K, C)

    @staticmethod
    def create(table_size: int, n_clusters: int) -> "RLState":
        return RLState(q=jnp.ones((table_size, n_clusters), jnp.float32))


def cluster_probs(state: RLState, cell: Array, bias: float) -> Array:
    """(N, C) per-lane cluster selection probabilities (bias-mixed Q row)."""
    row = state.q[cell]  # (N, C)
    s = jnp.sum(row, axis=1, keepdims=True)
    c = row.shape[1]
    return (1.0 - bias) * row / jnp.maximum(s, 1e-20) + bias / c


def sample(
    clusters: RLClusters,
    state: RLState,
    mesh: MeshView,
    cell: Array,
    u0: Array,
    u1: Array,
    u2: Array,
    u3: Array,
    bias: float = 0.25,
):
    """Sample a light point: cluster by Q, triangle by power CDF, point
    uniformly (direct_lighting_rl.h::sample analog).

    Returns (pos, normal, Le, pdf_area, tri, cluster).
    """
    probs = cluster_probs(state, cell, bias)  # (N, C)
    cdf = jnp.cumsum(probs, axis=1)
    cl = jnp.minimum(
        jnp.sum((cdf < u2[:, None]).astype(jnp.int32), axis=1),
        clusters.n_clusters - 1,
    )
    p_cl = jnp.take_along_axis(probs, cl[:, None], axis=1)[:, 0]
    # segment binary search in the cluster's power cdf
    lo = clusters.cluster_offset[cl]
    hi = clusters.cluster_offset[cl + 1]
    e = clusters.seg_cdf.shape[0]

    def step(_, carry):
        lo_, hi_ = carry
        mid = (lo_ + hi_) // 2
        v = clusters.seg_cdf[jnp.clip(mid, 0, max(e - 1, 0))]
        go_right = v < u3
        return (jnp.where(go_right, mid + 1, lo_), jnp.where(go_right, hi_, mid))

    lo2, _ = jax.lax.fori_loop(0, 18, step, (lo, hi))
    slot = jnp.clip(lo2, 0, max(e - 1, 0))
    tri = clusters.sorted_tris[slot] if e > 0 else jnp.zeros_like(cl)
    # light point
    b0, b1 = square_to_uniform_triangle(u0, u1)
    p0, e1, e2, gn, *_rest, mid_ = mesh.fetch(tri)
    pos = p0 + e1 * b0 + e2 * b1
    from fermat_tpu.scene.lights import _emissive_of

    le = _emissive_of(mesh, mid_)
    pdf_area = p_cl * clusters.tri_pdf_area[tri]
    empty = hi <= lo
    pdf_area = jnp.where(empty, 0.0, pdf_area)
    return pos, gn, le, pdf_area, tri, cl


def pdf_area_of(
    clusters: RLClusters, state: RLState, cell: Array, tri: Array, bias: float = 0.25
) -> Array:
    """Area pdf the RL sampler would assign to hitting `tri` from `cell`
    (the MIS counterpart for emissive BSDF hits)."""
    cl = clusters.tri_cluster[jnp.maximum(tri, 0)]
    probs = cluster_probs(state, cell, bias)
    p_cl = jnp.take_along_axis(probs, jnp.maximum(cl, 0)[:, None], axis=1)[:, 0]
    pdf = p_cl * clusters.tri_pdf_area[jnp.maximum(tri, 0)]
    return jnp.where(cl >= 0, pdf, 0.0)


def update(
    state: RLState,
    cell: Array,
    cluster: Array,
    reward: Array,
    valid: Array,
    lr: float = 0.15,
) -> RLState:
    """TD update toward the observed unshadowed contribution
    (direct_lighting_rl.h::update analog; scatter-add mean per (cell,cluster))."""
    k, c = state.q.shape
    flat = jnp.where(valid, cell * c + cluster, 0)
    r = jnp.where(valid, reward, 0.0)
    sums = jnp.zeros(k * c, jnp.float32).at[flat].add(r)
    cnts = jnp.zeros(k * c, jnp.float32).at[flat].add(valid.astype(jnp.float32))
    mean_r = sums / jnp.maximum(cnts, 1.0)
    seen = (cnts > 0).reshape(k, c)
    q_new = jnp.where(
        seen, (1.0 - lr) * state.q + lr * mean_r.reshape(k, c), state.q
    )
    return RLState(q=q_new)


# ---------------------------------------------------------------------------
# Tier 2: VTL clusters from the light-BVH cut (scene/mesh_lights.py).
# Reference: direct_lighting_rl.h sampling over MeshVTLStorage clusters +
# clustered_rl_inline.h's adaptive cuts.
# ---------------------------------------------------------------------------

def _fetch_vtl_rows(vtls, slot: Array) -> Array:
    return vtls.rows[slot]


def sample_vtl(
    vtls,
    state: RLState,
    cell: Array,
    u0: Array,
    u1: Array,
    u2: Array,
    u3: Array,
    bias: float = 0.25,
):
    """Sample a light point from the VTL set: cluster by Q, VTL by power
    CDF, point uniformly in the sub-triangle. One row fetch; no mesh
    gathers (the rows bake the sub-triangle's world geometry).

    Returns (pos, normal, Le, pdf_area, tri, cluster, slot).
    """
    n = cell.shape[0]
    v = vtls.rows.shape[0]
    if v == 0:
        z = jnp.zeros(n, jnp.float32)
        zv = Vec3.zeros((n,))
        zi = jnp.zeros(n, jnp.int32)
        return zv, zv, zv, z, zi, zi, zi
    probs = cluster_probs(state, cell, bias)  # (N, C)
    cdf = jnp.cumsum(probs, axis=1)
    cl = jnp.minimum(
        jnp.sum((cdf < u2[:, None]).astype(jnp.int32), axis=1),
        vtls.n_clusters - 1,
    )
    p_cl = jnp.take_along_axis(probs, cl[:, None], axis=1)[:, 0]
    lo = vtls.cluster_offset[cl]
    hi = vtls.cluster_offset[cl + 1]

    def step(_, carry):
        lo_, hi_ = carry
        mid = (lo_ + hi_) // 2
        val = vtls.seg_cdf[jnp.clip(mid, 0, v - 1)]
        go_right = val < u3
        return (jnp.where(go_right, mid + 1, lo_), jnp.where(go_right, hi_, mid))

    lo2, _ = jax.lax.fori_loop(0, 18, step, (lo, hi))
    slot = jnp.clip(lo2, 0, v - 1)
    r = _fetch_vtl_rows(vtls, slot)
    vec = lambda c0: Vec3(r[:, c0], r[:, c0 + 1], r[:, c0 + 2])
    q0, d1, d2, nrm, le = vec(0), vec(3), vec(6), vec(9), vec(12)
    s, t = square_to_uniform_triangle(u0, u1)
    pos = q0 + d1 * s + d2 * t
    pdf_area = p_cl * r[:, 15]
    empty = hi <= lo
    pdf_area = jnp.where(empty, 0.0, pdf_area)
    return pos, nrm, le, pdf_area, vtls.tri[slot], cl, slot


def pdf_area_of_vtl(
    vtls,
    state: RLState,
    cell: Array,
    tri: Array,
    u: Array,
    v: Array,
    bias: float = 0.25,
) -> Array:
    """Area pdf the VTL sampler assigns to the hit (tri, u, v) — the MIS
    counterpart for emissive BSDF hits. Uses the closed-form barycentric
    quadtree descent to find the containing VTL."""
    from fermat_tpu.scene.mesh_lights import locate

    nv = vtls.rows.shape[0]
    if nv == 0:
        return jnp.zeros(tri.shape[0], jnp.float32)
    tri_c = jnp.maximum(tri, 0)
    base = vtls.vtl_base[tri_c]
    depth = vtls.vtl_depth[tri_c]
    local = locate(u, v, depth)
    slot = vtls.leaf_slot[jnp.clip(base + local, 0, nv - 1)]
    cl = vtls.cluster_of[slot]
    probs = cluster_probs(state, cell, bias)
    p_cl = jnp.take_along_axis(probs, cl[:, None], axis=1)[:, 0]
    pdf = p_cl * vtls.pdf_area[slot]
    return jnp.where(base >= 0, pdf, 0.0)
