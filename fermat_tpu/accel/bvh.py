"""BVH build (host, binned SAH) + flattened skip-link node layout.

Reference analogs:
  * cugar/bvh/bvh.h + bvh_sah_builder.h (host SAH builder),
    binned_sah_builder.h (GPU binned SAH) — here a numpy binned-SAH builder.
  * cugar/bvh/bvh_node.h:45-106 — the packed 32-byte node. This layout
    differs deliberately: nodes are SoA flat arrays in DFS order with
    *skip links*, so traversal is stackless (one live i32 of state per ray):
    a lockstep while-loop across the wavefront in XLA, or a per-ray loop in
    the GPU kernel (ops/gpu_bvh_walk.py). No per-ray stack is needed; a
    skip-link thread turns the tree walk into a data-parallel pointer
    chase.

Leaves are padded to a fixed primitive count (LEAF_SIZE) in a reordered
primitive-index array, so a leaf visit intersects exactly LEAF_SIZE triangles
with a static unroll — no data-dependent inner loops under jit.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

SENTINEL = np.int32(-1)


@jax.tree_util.register_pytree_node_class
class BvhView:
    """Device-side flattened BVH (SoA).

    A registered pytree: the array fields are leaves; `leaf_size` is STATIC
    aux data (it parameterizes the unroll length of leaf intersection and
    must stay a python int under jit).
    """

    _ARRAY_FIELDS = (
        "lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z",
        "skip", "prim_start", "is_leaf", "prims", "child",
    )

    def __init__(
        self, lo_x, lo_y, lo_z, hi_x, hi_y, hi_z,
        skip, prim_start, is_leaf, prims, leaf_size, child=None,
    ):
        self.lo_x, self.lo_y, self.lo_z = lo_x, lo_y, lo_z
        self.hi_x, self.hi_y, self.hi_z = hi_x, hi_y, hi_z
        self.skip = skip
        self.prim_start = prim_start
        self.is_leaf = is_leaf
        self.prims = prims
        self.leaf_size = leaf_size
        self.child = child

    @property
    def n_nodes(self) -> int:
        return self.skip.shape[0]

    def tree_flatten(self):
        return tuple(getattr(self, f) for f in self._ARRAY_FIELDS), self.leaf_size

    @classmethod
    def tree_unflatten(cls, leaf_size, children):
        kw = dict(zip(cls._ARRAY_FIELDS, children))
        return cls(leaf_size=leaf_size, **kw)


class _BuildNode:
    __slots__ = ("lo", "hi", "left", "right", "prims")

    def __init__(self, lo, hi, left=None, right=None, prims=None):
        self.lo = lo
        self.hi = hi
        self.left = left
        self.right = right
        self.prims = prims


def build_bvh(
    centroids: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    leaf_size: int = 4,
    n_bins: int = 16,
) -> Tuple["BvhView", np.ndarray]:
    """Binned-SAH build over primitive aabbs (cugar binned_sah_builder analog).

    centroids/lo/hi: (T, 3) float32. Returns (BvhView on device, primitive
    order array) — `prims` in the view indexes the ORIGINAL triangle array.
    """
    T = centroids.shape[0]
    assert T > 0, "empty BVH"
    idx = np.arange(T, dtype=np.int32)

    def node_bounds(ids):
        return lo[ids].min(0), hi[ids].max(0)

    def recurse(ids) -> _BuildNode:
        nlo, nhi = node_bounds(ids)
        if len(ids) <= leaf_size:
            return _BuildNode(nlo, nhi, prims=ids)
        c = centroids[ids]
        cl, ch = c.min(0), c.max(0)
        ext = ch - cl
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            # degenerate spread: split in half by index
            mid = len(ids) // 2
            return _BuildNode(nlo, nhi, recurse(ids[:mid]), recurse(ids[mid:]))
        # binned SAH
        rel = (c[:, axis] - cl[axis]) / ext[axis]
        bins = np.minimum((rel * n_bins).astype(np.int32), n_bins - 1)
        bin_lo = np.full((n_bins, 3), np.inf, np.float32)
        bin_hi = np.full((n_bins, 3), -np.inf, np.float32)
        bin_n = np.zeros(n_bins, np.int64)
        for b in range(n_bins):
            m = bins == b
            if m.any():
                bin_lo[b] = lo[ids[m]].min(0)
                bin_hi[b] = hi[ids[m]].max(0)
                bin_n[b] = m.sum()

        def area(blo, bhi):
            d = np.maximum(bhi - blo, 0)
            return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

        # prefix/suffix sweeps
        costs = np.full(n_bins - 1, np.inf)
        acc_lo, acc_hi, acc_n = np.full(3, np.inf), np.full(3, -np.inf), 0
        left_a = np.zeros(n_bins - 1)
        left_n = np.zeros(n_bins - 1, np.int64)
        for b in range(n_bins - 1):
            acc_lo = np.minimum(acc_lo, bin_lo[b])
            acc_hi = np.maximum(acc_hi, bin_hi[b])
            acc_n += bin_n[b]
            left_a[b] = area(acc_lo, acc_hi) if acc_n else 0.0
            left_n[b] = acc_n
        acc_lo, acc_hi, acc_n = np.full(3, np.inf), np.full(3, -np.inf), 0
        for b in range(n_bins - 1, 0, -1):
            acc_lo = np.minimum(acc_lo, bin_lo[b])
            acc_hi = np.maximum(acc_hi, bin_hi[b])
            acc_n += bin_n[b]
            right_a = area(acc_lo, acc_hi) if acc_n else 0.0
            if left_n[b - 1] > 0 and acc_n > 0:
                costs[b - 1] = left_a[b - 1] * left_n[b - 1] + right_a * acc_n
        if not np.isfinite(costs).any():
            mid = len(ids) // 2
            order = np.argsort(c[:, axis], kind="stable")
            return _BuildNode(
                nlo, nhi, recurse(ids[order[:mid]]), recurse(ids[order[mid:]])
            )
        split = int(np.argmin(costs))
        lmask = bins <= split
        lids, rids = ids[lmask], ids[~lmask]
        if len(lids) == 0 or len(rids) == 0:
            mid = len(ids) // 2
            order = np.argsort(c[:, axis], kind="stable")
            lids, rids = ids[order[:mid]], ids[order[mid:]]
        return _BuildNode(nlo, nhi, recurse(lids), recurse(rids))

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = recurse(idx)
    finally:
        sys.setrecursionlimit(old_limit)

    # Flatten to DFS order with skip links: node i's children (if inner) start
    # at i+1; `skip[i]` is where traversal resumes when the subtree at i is
    # missed or exhausted. Left subtree exits to the right child; right
    # subtree exits to the parent's own skip.
    nodes_lo, nodes_hi, skips, starts, leaf_flags = [], [], [], [], []
    prim_slots: list = []

    def flatten(n: _BuildNode, skip_to: int):
        nodes_lo.append(n.lo)
        nodes_hi.append(n.hi)
        skips.append(skip_to)
        if n.prims is not None:
            starts.append(len(prim_slots))
            leaf_flags.append(True)
            prim_slots.extend(list(n.prims) + [-1] * (leaf_size - len(n.prims)))
        else:
            starts.append(0)
            leaf_flags.append(False)
            # left child goes first; we don't know the right child's index
            # until the left subtree is emitted, so patch the placeholder.
            left_pos = len(nodes_lo)
            flatten(n.left, -2)
            right_pos = len(nodes_lo)
            for i in range(left_pos, right_pos):
                if skips[i] == -2:
                    skips[i] = right_pos
            flatten(n.right, skip_to)

    flatten(root, int(SENTINEL))

    j = jnp.asarray
    nlo = np.asarray(nodes_lo, np.float32)
    nhi = np.asarray(nodes_hi, np.float32)
    n_nodes = len(skips)
    view = BvhView(
        lo_x=j(nlo[:, 0]), lo_y=j(nlo[:, 1]), lo_z=j(nlo[:, 2]),
        hi_x=j(nhi[:, 0]), hi_y=j(nhi[:, 1]), hi_z=j(nhi[:, 2]),
        skip=j(np.asarray(skips, np.int32)),
        prim_start=j(np.asarray(starts, np.int32)),
        is_leaf=j(np.asarray(leaf_flags, bool)),
        prims=j(np.asarray(prim_slots, np.int32)),
        leaf_size=leaf_size,
        child=j(np.arange(1, n_nodes + 1, dtype=np.int32)),  # DFS: child = i+1
    )
    return view, np.asarray(prim_slots, np.int32)


_NATIVE_MIN_TRIS = 4096  # below this python build time is negligible


def build_bvh_for_mesh(mesh_view, leaf_size: int = 4, use_native: bool = True) -> BvhView:
    """Build from a MeshView's (p0, e1, e2) triangle soup.

    Large meshes route to the native C++ builder (native/fermat_native.cpp)
    when available — same flattened layout, ~100x the python build speed."""
    p0 = np.stack([np.asarray(mesh_view.p0.x), np.asarray(mesh_view.p0.y), np.asarray(mesh_view.p0.z)], 1)
    p1 = p0 + np.stack([np.asarray(mesh_view.e1.x), np.asarray(mesh_view.e1.y), np.asarray(mesh_view.e1.z)], 1)
    p2 = p0 + np.stack([np.asarray(mesh_view.e2.x), np.asarray(mesh_view.e2.y), np.asarray(mesh_view.e2.z)], 1)
    lo = np.minimum(np.minimum(p0, p1), p2) - 1e-7
    hi = np.maximum(np.maximum(p0, p1), p2) + 1e-7
    centroids = ((p0 + p1 + p2) / 3.0).astype(np.float32)
    lo = lo.astype(np.float32)
    hi = hi.astype(np.float32)

    if use_native and centroids.shape[0] >= _NATIVE_MIN_TRIS:
        from fermat_tpu.utils.native import build_bvh_native

        r = build_bvh_native(centroids, lo, hi, leaf_size)
        if r is not None:
            j = jnp.asarray
            n_nodes = r["skip"].shape[0]
            return BvhView(
                lo_x=j(r["lo"][:, 0]), lo_y=j(r["lo"][:, 1]), lo_z=j(r["lo"][:, 2]),
                hi_x=j(r["hi"][:, 0]), hi_y=j(r["hi"][:, 1]), hi_z=j(r["hi"][:, 2]),
                skip=j(r["skip"]),
                prim_start=j(r["prim_start"]),
                is_leaf=j(r["is_leaf"]),
                prims=j(r["prims"]),
                leaf_size=leaf_size,
                child=j(np.arange(1, n_nodes + 1, dtype=np.int32)),
            )

    view, _ = build_bvh(centroids, lo, hi, leaf_size)
    return view
