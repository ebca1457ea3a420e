"""2D UV-space BVH + UV chart fixing.

Reference analogs:
  * `UVBvh` / `UVBvhView::locate` (src/uv_bvh.h:38-58, uv_bvh_view.h:122):
    a BVH over the mesh's UV-space triangles used to find the triangle
    covering a given (u, v) inside a group — texture baking & VTL lookups.
  * `uv_fix` (src/uv_fix.cu:377): split each mesh group into charts of
    connected, non-overlapping UV triangles (components of the shared-
    uv-edge graph).

Shape: the tree is a host-built (numpy) median-split skip-link array;
`locate` is a jnp `lax.while_loop` walk over flat node arrays — the same
stackless scheme as the 3D skip-link tracer (accel/traverse.py), with the
point-in-box test replacing the slab test.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

_LEAF = 4


class UVBvhView(NamedTuple):
    """Flat 2D skip-link tree (device)."""

    lo_u: Array  # (M,)
    lo_v: Array
    hi_u: Array
    hi_v: Array
    skip: Array  # (M,) next node if this subtree is skipped (-1 = done)
    start: Array  # (M,) first prim slot for leaves, -1 for inner
    count: Array  # (M,) leaf prim count (0 for inner)
    prims: Array  # (P,) triangle ids in leaf order
    # per-triangle uv corners (dense, for the containment test)
    uv0: Array  # (T, 2)
    uv1: Array
    uv2: Array
    group_of: Array  # (T,) i32 group id of each triangle


def _build_nodes(cent, boxes, order, start, end, nodes, prims):
    lo = boxes[order[start:end], 0:2].min(0)
    hi = boxes[order[start:end], 2:4].max(0)
    me = len(nodes)
    nodes.append([lo[0], lo[1], hi[0], hi[1], -1, -1, 0])
    if end - start <= _LEAF:
        nodes[me][5] = len(prims)
        nodes[me][6] = end - start
        prims.extend(order[start:end].tolist())
    else:
        axis = int(np.argmax(hi - lo))
        mid = (start + end) // 2
        sub = np.argsort(cent[order[start:end], axis], kind="stable")
        order[start:end] = order[start:end][sub]
        _build_nodes(cent, boxes, order, start, mid, nodes, prims)
        _build_nodes(cent, boxes, order, mid, end, nodes, prims)
    return me


def build_uv_bvh(mesh_storage) -> UVBvhView:
    """Host build over the mesh's per-corner UVs (uv_bvh.cu build analog)."""
    view_uv = _corner_uvs(mesh_storage)
    t = view_uv.shape[0]
    boxes = np.concatenate([view_uv.min(1), view_uv.max(1)], 1)  # (T, 4)
    cent = 0.5 * (boxes[:, 0:2] + boxes[:, 2:4])
    order = np.arange(t)
    nodes: list = []
    prims: list = []
    if t:
        _build_nodes(cent, boxes, order, 0, t, nodes, prims)
    else:
        nodes.append([0.0, 0.0, 0.0, 0.0, -1, 0, 0])
    # resolve skip links by preorder subtree sizes: a node's left child is
    # i+1, its right child i+1+size(left); skip(left) = right, skip(right)
    # and skip(node) = the parent's skip
    m = len(nodes)
    arr = np.asarray(nodes, np.float64)
    skips = np.full(m, -1, np.int64)
    sizes = np.zeros(m, np.int64)

    def subtree(i):
        if arr[i, 6] > 0 or t == 0:  # leaf (count > 0) or the empty stub
            sizes[i] = 1
            return 1
        sl = subtree(i + 1)
        sr = subtree(i + 1 + sl)
        sizes[i] = 1 + sl + sr
        return sizes[i]

    subtree(0)

    def fix(i, skip):
        skips[i] = skip
        if arr[i, 6] > 0 or t == 0:
            return
        l = i + 1
        r = l + sizes[l]
        fix(l, r)
        fix(r, skip)

    fix(0, -1)

    group_of = np.zeros(t, np.int32)
    offs = np.asarray(mesh_storage.group_offsets)
    for g in range(len(offs) - 1):
        group_of[offs[g]:offs[g + 1]] = g

    j = jnp.asarray
    return UVBvhView(
        lo_u=j(arr[:, 0].astype(np.float32)), lo_v=j(arr[:, 1].astype(np.float32)),
        hi_u=j(arr[:, 2].astype(np.float32)), hi_v=j(arr[:, 3].astype(np.float32)),
        skip=j(skips.astype(np.int32)),
        start=j(arr[:, 5].astype(np.int32)),
        count=j(arr[:, 6].astype(np.int32)),
        prims=j(np.asarray(prims + [0], np.int32)),
        uv0=j(view_uv[:, 0].astype(np.float32)),
        uv1=j(view_uv[:, 1].astype(np.float32)),
        uv2=j(view_uv[:, 2].astype(np.float32)),
        group_of=j(group_of),
    )


def _corner_uvs(ms) -> np.ndarray:
    """(T, 3, 2) resolved per-corner uvs."""
    t = ms.n_triangles
    out = np.zeros((t, 3, 2), np.float64)
    uvs = ms._resolved_uvs() if hasattr(ms, "_resolved_uvs") else ms.uvs
    if uvs.shape[0]:
        ui = ms.uv_indices
        ok = ui >= 0
        out[ok] = uvs[np.where(ok, ui, 0)][ok]
    return out


def locate(bvh: UVBvhView, group_id: Array, su: Array, sv: Array):
    """Find the triangle of `group_id` containing uv point (su, sv).

    Returns (tri, u, v): tri == -1 when no triangle covers the point
    (UVBvhView::locate, uv_bvh_view.h:122-228). Vectorized over N query
    lanes; stackless skip-link walk.
    """
    n = su.shape[0]

    def cond(carry):
        node, _tri, _u, _v = carry
        return jnp.any(node >= 0)

    def body(carry):
        node, tri, u, v = carry
        nc = jnp.maximum(node, 0)
        inside = (
            (su >= bvh.lo_u[nc]) & (su <= bvh.hi_u[nc])
            & (sv >= bvh.lo_v[nc]) & (sv <= bvh.hi_v[nc])
        ) & (node >= 0)
        is_leaf = bvh.count[nc] > 0
        # leaf: test up to _LEAF prims
        for k in range(_LEAF):
            slot = jnp.clip(bvh.start[nc] + k, 0, bvh.prims.shape[0] - 1)
            pid = bvh.prims[slot]
            valid = inside & is_leaf & (k < bvh.count[nc]) & (
                bvh.group_of[pid] == group_id) & (tri < 0)
            a = bvh.uv0[pid]
            b = bvh.uv1[pid]
            c = bvh.uv2[pid]
            v1u, v1v = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
            v2u, v2v = c[:, 0] - a[:, 0], c[:, 1] - a[:, 1]
            pu, pv_ = su - a[:, 0], sv - a[:, 1]
            den = v1u * v2v - v2u * v1v
            inv = jnp.where(jnp.abs(den) > 1e-20,
                            1.0 / jnp.where(den == 0, 1.0, den), 0.0)
            bu = (pu * v2v - v2u * pv_) * inv
            bv = (v1u * pv_ - pu * v1v) * inv
            hit = valid & (bu >= -1e-6) & (bv >= -1e-6) & (bu + bv <= 1.0 + 1e-6)
            tri = jnp.where(hit, pid, tri)
            u = jnp.where(hit, bu, u)
            v = jnp.where(hit, bv, v)
        # descend into the box, or skip the subtree
        nxt = jnp.where(
            inside & ~is_leaf, node + 1,
            jnp.where(node >= 0, bvh.skip[nc], node),
        )
        # found lanes park at -1
        nxt = jnp.where(tri >= 0, -1, nxt)
        return nxt, tri, u, v

    node0 = jnp.zeros(n, jnp.int32)
    tri0 = jnp.full(n, -1, jnp.int32)
    z = jnp.zeros(n, jnp.float32)
    _n, tri, u, v = jax.lax.while_loop(cond, body, (node0, tri0, z, z))
    return tri, u, v


# ---------------------------------------------------------------------------
# uv_fix (uv_fix.cu:377): split groups into connected non-overlapping charts
# ---------------------------------------------------------------------------

def uv_fix(ms) -> int:
    """Split each mesh group into UV charts — connected components of the
    shared-uv-edge graph — rewriting group_offsets/group_names in place.
    Returns the new group count. Triangles are NOT reordered; charts are
    expressed as a finer partition using a stable re-sort of each group's
    triangles by component id (all parallel per-triangle arrays permute
    together)."""
    t = ms.n_triangles
    if t == 0 or ms.uv_indices.shape[0] != t:
        return len(ms.group_names)
    parent = np.arange(t)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    offs = np.asarray(ms.group_offsets)
    ui = ms.uv_indices
    for g in range(len(offs) - 1):
        lo, hi = int(offs[g]), int(offs[g + 1])
        edge_map: dict = {}
        for ti in range(lo, hi):
            tri_uv = ui[ti]
            if (tri_uv < 0).any():
                continue
            for e in range(3):
                a, b = int(tri_uv[e]), int(tri_uv[(e + 1) % 3])
                key = (min(a, b), max(a, b))
                if key in edge_map:
                    union(edge_map[key], ti)
                else:
                    edge_map[key] = ti
    roots = np.array([find(i) for i in range(t)])

    new_offsets = [0]
    new_names = []
    perm = np.zeros(t, np.int64)
    cursor = 0
    for g in range(len(offs) - 1):
        lo, hi = int(offs[g]), int(offs[g + 1])
        seg = np.arange(lo, hi)
        if seg.size == 0:
            continue
        r = roots[seg]
        uniq, inv = np.unique(r, return_inverse=True)
        order = np.argsort(inv, kind="stable")
        perm[cursor:cursor + seg.size] = seg[order]
        counts = np.bincount(inv)
        base = ms.group_names[g] if g < len(ms.group_names) else f"group{g}"
        for ci, c in enumerate(counts):
            suffix = f"_chart{ci}" if counts.size > 1 else ""
            new_names.append(base + suffix)
            new_offsets.append(new_offsets[-1] + int(c))
        cursor += seg.size

    ms.triangles = ms.triangles[perm]
    if ms.normal_indices.shape[0] == t:
        ms.normal_indices = ms.normal_indices[perm]
    if ms.uv_indices.shape[0] == t:
        ms.uv_indices = ms.uv_indices[perm]
    if ms.material_ids.shape[0] == t:
        ms.material_ids = ms.material_ids[perm]
    ms.group_names = new_names
    ms.group_offsets = np.asarray(new_offsets, np.int32)
    return len(new_names)
