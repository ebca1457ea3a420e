"""Wavefront ray traversal: closest-hit and any-hit queries.

Reference analog: src/rt.{h,cpp} (`RTContext::trace` / `trace_shadow`,
rt.cpp:558-650) + the OptiX ray-gen programs (src/kernels/optix_rt.cu).
This is the plain XLA walk: a skip-link BVH stepped in lockstep across the
whole wavefront. Each ray's traversal state is ONE i32 node cursor, and
every `while_loop` step performs a (gather → slab test → LEAF_SIZE unrolled
triangle tests → cursor update) across all rays as flat vector ops. Rays
that finish park at the sentinel and become masked lanes until the whole
wavefront drains. On a GPU the same tree is walked per ray by
`ops/gpu_bvh_walk.py` (routing: `fermat_tpu.platform.tracer_for`).

A brute-force path (all triangles, blocked) serves small scenes, where
testing every triangle in one fused loop beats pointer chasing, and is the
plain reference every tracer is tested against.

The hit record matches src/ray.h:42-89 (`Hit { t, triId, u, v }`): miss is
tri == -1.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from fermat_tpu.accel.bvh import BvhView
from fermat_tpu.core.math import Vec3, cross, dot
from fermat_tpu.scene.mesh import MeshView

Array = jax.Array

_EPS_DET = 1e-12


class Hit(NamedTuple):
    """Per-ray hit record (src/ray.h Hit analog)."""

    t: Array
    tri: Array  # -1 = miss
    u: Array
    v: Array

    @property
    def hit_mask(self) -> Array:
        return self.tri >= 0


def intersect_triangles(
    mesh: MeshView,
    tri_idx: Array,
    o: Vec3,
    d: Vec3,
    tmin,
    tmax,
) -> Tuple[Array, Array, Array, Array]:
    """Moller-Trumbore for one gathered triangle per lane.

    tri_idx must be a valid index (clamp before calling; mask after).
    Returns (t, u, v, hit_ok).
    """
    p0 = mesh.p0.gather(tri_idx)
    e1 = mesh.e1.gather(tri_idx)
    e2 = mesh.e2.gather(tri_idx)
    pv = cross(d, e2)
    det = dot(e1, pv)
    inv_det = jnp.where(jnp.abs(det) > _EPS_DET, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tv = o - p0
    u = dot(tv, pv) * inv_det
    qv = cross(tv, e1)
    v = dot(d, qv) * inv_det
    t = dot(e2, qv) * inv_det
    ok = (
        (jnp.abs(det) > _EPS_DET)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < tmax)
    )
    return t, u, v, ok


class _TraceState(NamedTuple):
    node: Array
    t: Array
    tri: Array
    u: Array
    v: Array


def _safe_inv(d: Array) -> Array:
    return jnp.where(jnp.abs(d) > 1e-20, 1.0 / jnp.where(d == 0, 1.0, d), 1e20 * jnp.where(d >= 0, 1.0, -1.0))


def _slab_test(bvh: BvhView, n: Array, o: Vec3, inv_d: Vec3, tmin, tmax) -> Array:
    """Ray-AABB slab test for the gathered node n (clamped indices)."""
    t0x = (bvh.lo_x[n] - o.x) * inv_d.x
    t1x = (bvh.hi_x[n] - o.x) * inv_d.x
    t0y = (bvh.lo_y[n] - o.y) * inv_d.y
    t1y = (bvh.hi_y[n] - o.y) * inv_d.y
    t0z = (bvh.lo_z[n] - o.z) * inv_d.z
    t1z = (bvh.hi_z[n] - o.z) * inv_d.z
    near = jnp.maximum(
        jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
        jnp.maximum(jnp.minimum(t0z, t1z), tmin),
    )
    far = jnp.minimum(
        jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
        jnp.minimum(jnp.maximum(t0z, t1z), tmax),
    )
    return near <= far


def trace_closest(
    bvh: BvhView,
    mesh: MeshView,
    o: Vec3,
    d: Vec3,
    tmin: Array,
    tmax: Array,
    active: Optional[Array] = None,
) -> Hit:
    """Closest-hit wavefront trace (RTContext::trace analog, rt.cpp:558).

    `active=False` lanes return a miss without traversing (their cursor
    starts at the sentinel, so they cost nothing but the masked lanes).
    """
    inv_d = Vec3(_safe_inv(d.x), _safe_inv(d.y), _safe_inv(d.z))
    n = o.x.shape[0]
    node0 = jnp.zeros(n, jnp.int32)
    if active is not None:
        node0 = jnp.where(active, node0, -1)
    state = _TraceState(
        node=node0,
        t=jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,)),
        tri=jnp.full(n, -1, jnp.int32),
        u=jnp.zeros(n, jnp.float32),
        v=jnp.zeros(n, jnp.float32),
    )

    def cond(s: _TraceState):
        return jnp.any(s.node >= 0)

    def body(s: _TraceState):
        live = s.node >= 0
        nd = jnp.maximum(s.node, 0)
        hit_box = _slab_test(bvh, nd, o, inv_d, tmin, s.t) & live
        leaf = bvh.is_leaf[nd]
        t, tri, u, v = s.t, s.tri, s.u, s.v
        do_leaf = hit_box & leaf
        start = bvh.prim_start[nd]
        for k in range(bvh.leaf_size):
            tid = bvh.prims[jnp.minimum(start + k, bvh.prims.shape[0] - 1)]
            valid = do_leaf & (tid >= 0)
            tid_c = jnp.maximum(tid, 0)
            th, uh, vh, ok = intersect_triangles(mesh, tid_c, o, d, tmin, t)
            closer = valid & ok
            t = jnp.where(closer, th, t)
            tri = jnp.where(closer, tid_c, tri)
            u = jnp.where(closer, uh, u)
            v = jnp.where(closer, vh, v)
        nxt = jnp.where(hit_box & ~leaf, bvh.child[nd], bvh.skip[nd])
        return _TraceState(jnp.where(live, nxt, s.node), t, tri, u, v)

    s = jax.lax.while_loop(cond, body, state)
    return Hit(t=s.t, tri=s.tri, u=s.u, v=s.v)


def trace_any(
    bvh: BvhView,
    mesh: MeshView,
    o: Vec3,
    d: Vec3,
    tmin: Array,
    tmax: Array,
    active: Optional[Array] = None,
) -> Array:
    """Binary occlusion query (RTContext::trace_shadow analog, rt.cpp:610).

    Returns occluded mask. Rays early-out at the first confirmed hit.
    """
    inv_d = Vec3(_safe_inv(d.x), _safe_inv(d.y), _safe_inv(d.z))
    n = o.x.shape[0]
    node0 = jnp.zeros(n, jnp.int32)
    if active is not None:
        node0 = jnp.where(active, node0, -1)
    occluded0 = jnp.zeros(n, bool)

    def cond(s):
        return jnp.any(s[0] >= 0)

    def body(s):
        node, occluded = s
        live = node >= 0
        nd = jnp.maximum(node, 0)
        hit_box = _slab_test(bvh, nd, o, inv_d, tmin, tmax) & live
        leaf = bvh.is_leaf[nd]
        do_leaf = hit_box & leaf
        start = bvh.prim_start[nd]
        hit_any = jnp.zeros_like(occluded)
        for k in range(bvh.leaf_size):
            tid = bvh.prims[jnp.minimum(start + k, bvh.prims.shape[0] - 1)]
            valid = do_leaf & (tid >= 0)
            tid_c = jnp.maximum(tid, 0)
            _, _, _, ok = intersect_triangles(mesh, tid_c, o, d, tmin, tmax)
            hit_any = hit_any | (valid & ok)
        occluded = occluded | hit_any
        nxt = jnp.where(hit_box & ~leaf, bvh.child[nd], bvh.skip[nd])
        nxt = jnp.where(occluded, -1, nxt)  # early out
        return (jnp.where(live, nxt, node), occluded)

    _, occluded = jax.lax.while_loop(cond, body, (node0, occluded0))
    return occluded


# ---------------------------------------------------------------------------
# Brute-force path for small scenes: blocked all-triangle tests, dense work
# with no divergence — faster than a tree below a few thousand triangles.
# ---------------------------------------------------------------------------

def trace_closest_brute(
    mesh: MeshView,
    o: Vec3,
    d: Vec3,
    tmin: Array,
    tmax: Array,
    active: Optional[Array] = None,
    block: int = 128,
) -> Hit:
    n = o.x.shape[0]
    T = mesh.n_triangles
    n_blocks = -(-T // block)
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (n,))

    def body(b, s):
        t_best, tri_best, u_best, v_best = s
        base = b * block
        ids = base + jnp.arange(block, dtype=jnp.int32)
        valid_t = ids < T
        ids_c = jnp.minimum(ids, T - 1)
        # broadcast rays (N,1) x tris (1,B)
        p0 = mesh.p0.gather(ids_c)
        e1 = mesh.e1.gather(ids_c)
        e2 = mesh.e2.gather(ids_c)
        ox, oy, oz = o.x[:, None], o.y[:, None], o.z[:, None]
        dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
        e1x, e1y, e1z = e1.x[None, :], e1.y[None, :], e1.z[None, :]
        e2x, e2y, e2z = e2.x[None, :], e2.y[None, :], e2.z[None, :]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv_det = jnp.where(jnp.abs(det) > _EPS_DET, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
        tvx = ox - p0.x[None, :]
        tvy = oy - p0.y[None, :]
        tvz = oz - p0.z[None, :]
        uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        ok = (
            (jnp.abs(det) > _EPS_DET)
            & (uu >= 0.0)
            & (vv >= 0.0)
            & (uu + vv <= 1.0)
            & (tt > tmin[:, None])
            & (tt < t_best[:, None])
            & valid_t[None, :]
        )
        tt = jnp.where(ok, tt, jnp.inf)
        kmin = jnp.argmin(tt, axis=1)
        rows = jnp.arange(n)
        t_new = tt[rows, kmin]
        got = jnp.isfinite(t_new)
        t_best = jnp.where(got, t_new, t_best)
        tri_best = jnp.where(got, ids_c[kmin], tri_best)
        u_best = jnp.where(got, uu[rows, kmin], u_best)
        v_best = jnp.where(got, vv[rows, kmin], v_best)
        return (t_best, tri_best, u_best, v_best)

    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))
    init = (
        tmax_b,
        jnp.full(n, -1, jnp.int32),
        jnp.zeros(n, jnp.float32),
        jnp.zeros(n, jnp.float32),
    )
    t, tri, u, v = jax.lax.fori_loop(0, n_blocks, body, init)
    if active is not None:
        tri = jnp.where(active, tri, -1)
    return Hit(t=t, tri=tri, u=u, v=v)


def trace_any_brute(
    mesh: MeshView,
    o: Vec3,
    d: Vec3,
    tmin: Array,
    tmax: Array,
    active: Optional[Array] = None,
    block: int = 128,
) -> Array:
    hit = trace_closest_brute(mesh, o, d, tmin, tmax, active, block)
    occ = hit.hit_mask
    if active is not None:
        occ = occ & active
    return occ
