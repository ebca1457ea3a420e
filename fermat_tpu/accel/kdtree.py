"""k-d tree k-nearest-neighbor queries (cugar/kd analog).

Reference analog: cugar/kd/* (the GPU k-d builder + kNN lookups used by
photon-style estimators). The framework's own density estimators (PSFPT,
RPT) use stochastic spatial hashing instead — this module exists for
parity and for host-side tooling that wants exact kNN.

Shape: host numpy median-split build into flat skip-link arrays (the
same stackless scheme as the 3D/2D BVHs); the device query is a
`lax.while_loop` walk carrying an UNROLLED k-best register file per lane
(k is static and small), pruning subtrees whose AABB distance exceeds the
current k-th best — every step is a dense vector op, no per-lane stacks.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

_LEAF = 8
_BIG = 3.0e38


class KdTreeView(NamedTuple):
    """Flat skip-link k-d tree over points (device)."""

    lo: Array  # (M, 3) node bounds
    hi: Array  # (M, 3)
    skip: Array  # (M,) next node if subtree skipped (-1 done)
    start: Array  # (M,) leaf slot start (-1 inner)
    count: Array  # (M,) leaf point count
    pts: Array  # (P, 3) points in leaf order
    ids: Array  # (P,) original point ids in leaf order


def build_kdtree(points: np.ndarray) -> KdTreeView:
    """Host median-split build over (N, 3) points."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    order = np.arange(n)
    nodes: list = []
    slots: list = []

    def rec(start, end):
        ids = order[start:end]
        lo = points[ids].min(0) if ids.size else np.zeros(3)
        hi = points[ids].max(0) if ids.size else np.zeros(3)
        me = len(nodes)
        nodes.append([*lo, *hi, -1, -1, 0])
        if end - start <= _LEAF:
            nodes[me][7] = len(slots)
            nodes[me][8] = end - start
            slots.extend(ids.tolist())
        else:
            axis = int(np.argmax(hi - lo))
            mid = (start + end) // 2
            sub = np.argsort(points[ids][:, axis], kind="stable")
            order[start:end] = ids[sub]
            rec(start, mid)
            rec(mid, end)
        return me

    if n:
        rec(0, n)
    else:
        nodes.append([0, 0, 0, 0, 0, 0, -1, 0, 0])

    m = len(nodes)
    arr = np.asarray(nodes, np.float64)
    sizes = np.zeros(m, np.int64)
    skips = np.full(m, -1, np.int64)

    def subtree(i):
        if arr[i, 8] > 0 or n == 0:
            sizes[i] = 1
            return 1
        sl = subtree(i + 1)
        sr = subtree(i + 1 + sl)
        sizes[i] = 1 + sl + sr
        return sizes[i]

    subtree(0)

    def fix(i, skip):
        skips[i] = skip
        if arr[i, 8] > 0 or n == 0:
            return
        l = i + 1
        r = l + sizes[l]
        fix(l, r)
        fix(r, skip)

    fix(0, -1)

    j = jnp.asarray
    return KdTreeView(
        lo=j(arr[:, 0:3].astype(np.float32)),
        hi=j(arr[:, 3:6].astype(np.float32)),
        skip=j(skips.astype(np.int32)),
        start=j(arr[:, 7].astype(np.int32)),
        count=j(arr[:, 8].astype(np.int32)),
        pts=j(points[np.asarray(slots + [0], np.int64)[: max(len(slots), 1)]]
              .astype(np.float32)),
        ids=j(np.asarray(slots + [0], np.int64)[: max(len(slots), 1)]
              .astype(np.int32)),
    )


def _box_dist2(lo, hi, qx, qy, qz):
    dx = jnp.maximum(jnp.maximum(lo[:, 0] - qx, qx - hi[:, 0]), 0.0)
    dy = jnp.maximum(jnp.maximum(lo[:, 1] - qy, qy - hi[:, 1]), 0.0)
    dz = jnp.maximum(jnp.maximum(lo[:, 2] - qz, qz - hi[:, 2]), 0.0)
    return dx * dx + dy * dy + dz * dz


def knn(tree: KdTreeView, qx: Array, qy: Array, qz: Array, k: int = 4):
    """k nearest points for each query lane.

    Returns (dist2 (N, k) ascending, ids (N, k); empty slots carry +inf /
    -1). k is static (unrolled k-best registers).
    """
    n = qx.shape[0]
    best_d = jnp.full((n, k), _BIG, jnp.float32)
    best_i = jnp.full((n, k), -1, jnp.int32)
    node0 = jnp.zeros(n, jnp.int32)

    def insert(best_d, best_i, d2, pid, ok):
        """Insertion into the sorted k-best register file (unrolled)."""
        d2 = jnp.where(ok, d2, _BIG)
        for s in range(k):
            smaller = d2 < best_d[:, s]
            # shift the tail down by one
            new_d = best_d
            new_i = best_i
            for t in range(k - 1, s, -1):
                new_d = new_d.at[:, t].set(
                    jnp.where(smaller, best_d[:, t - 1], best_d[:, t]))
                new_i = new_i.at[:, t].set(
                    jnp.where(smaller, best_i[:, t - 1], best_i[:, t]))
            new_d = new_d.at[:, s].set(jnp.where(smaller, d2, best_d[:, s]))
            new_i = new_i.at[:, s].set(jnp.where(smaller, pid, best_i[:, s]))
            done = smaller
            best_d = new_d
            best_i = new_i
            d2 = jnp.where(done, _BIG, d2)  # inserted -> stop propagating
        return best_d, best_i

    def cond(carry):
        node, _d, _i = carry
        return jnp.any(node >= 0)

    def body(carry):
        node, best_d, best_i = carry
        nc = jnp.maximum(node, 0)
        live = node >= 0
        kth = best_d[:, k - 1]
        near = _box_dist2(tree.lo[nc], tree.hi[nc], qx, qy, qz)
        enter = live & (near < kth)
        is_leaf = tree.count[nc] > 0
        for s in range(_LEAF):
            slot = jnp.clip(tree.start[nc] + s, 0, tree.pts.shape[0] - 1)
            p = tree.pts[slot]
            ok = enter & is_leaf & (s < tree.count[nc])
            d2 = ((qx - p[:, 0]) ** 2 + (qy - p[:, 1]) ** 2
                  + (qz - p[:, 2]) ** 2)
            best_d, best_i = insert(best_d, best_i, d2, tree.ids[slot], ok)
        nxt = jnp.where(
            enter & ~is_leaf, node + 1,
            jnp.where(live, tree.skip[nc], node),
        )
        return nxt, best_d, best_i

    _n, best_d, best_i = jax.lax.while_loop(
        cond, body, (node0, best_d, best_i))
    return best_d, best_i
