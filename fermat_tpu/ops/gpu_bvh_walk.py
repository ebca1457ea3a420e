"""Per-ray BVH walk on the GPU: a Pallas kernel for the Triton backend.

Reference analog: the OptiX trace behind `RTContext::trace` /
`trace_shadow` (rt.cpp:558-650), where each thread walks the tree for its
own ray. The XLA walk in `accel/traverse.py` instead steps the whole
wavefront in lockstep: every step writes each ray's (node, t, tri, u, v)
to device memory and reads it back, and the loop runs until the slowest
ray of the wavefront is done. Here one program takes a block of rays,
keeps their state in registers, and stops when its own rays are done.

The tree is the skip-link BvhView of `accel/bvh.py` / `accel/lbvh.py`,
packed into two flat tables (`pack`, once per scene or pass, outside any
bounce loop):

  nodes (n_nodes * 8,) f32: lo xyz, hi xyz, link, skip — `link` is the
      first child of an inner node, or -1 - prim_start for a leaf; link
      and skip are int32 bit patterns.
  tris  (n_slots * 12,) f32: p0 xyz, e1 xyz, e2 xyz, triangle id (int32
      bits, -1 for a padding slot), 2 pad — one row per leaf slot, so a
      leaf's triangles are contiguous.

Node and triangle rows are read by gathered loads; a scene of ~100k
triangles (about 10 MB packed) stays in the H100's 50 MB L2. Hits are
geometric and never differentiated (integrators/pt.py detaches them), so
the kernels have no VJP.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from fermat_tpu import platform
from fermat_tpu.accel.bvh import BvhView
from fermat_tpu.accel.traverse import _EPS_DET, Hit
from fermat_tpu.core.math import Vec3
from fermat_tpu.scene.mesh import MeshView

Array = jax.Array

BLOCK = 128  # rays per program: 4 warps
NUM_WARPS = 4
_NODE_W = 8
_TRI_W = 12


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["nodes", "tris"], meta_fields=["leaf_size"])
@dataclasses.dataclass(frozen=True)
class WalkTables:
    """The packed tree the kernels walk (module docstring); `leaf_size` is
    static."""

    nodes: Array
    tris: Array
    leaf_size: int


def pack(bvh: BvhView, mesh: MeshView) -> WalkTables:
    """Pack `bvh` over `mesh` into the kernels' flat tables. Hits are never
    differentiated, so the tables are detached."""
    i2f = lambda a: jax.lax.bitcast_convert_type(a.astype(jnp.int32),
                                                 jnp.float32)
    link = jnp.where(bvh.is_leaf, -1 - bvh.prim_start, bvh.child)
    nodes = jnp.stack([bvh.lo_x, bvh.lo_y, bvh.lo_z,
                       bvh.hi_x, bvh.hi_y, bvh.hi_z,
                       i2f(link), i2f(bvh.skip)], axis=1)
    tid = bvh.prims
    tc = jnp.maximum(tid, 0)
    pad = tid < 0
    # padding slots get a zero triangle: det == 0, so it never hits
    geo = lambda a: jnp.where(pad, 0.0, a[tc])
    zeros = jnp.zeros_like(tid, jnp.float32)
    tris = jnp.stack([geo(mesh.p0.x), geo(mesh.p0.y), geo(mesh.p0.z),
                      geo(mesh.e1.x), geo(mesh.e1.y), geo(mesh.e1.z),
                      geo(mesh.e2.x), geo(mesh.e2.y), geo(mesh.e2.z),
                      i2f(tid), zeros, zeros], axis=1)
    sg = jax.lax.stop_gradient
    return WalkTables(nodes=sg(nodes.reshape(-1)), tris=sg(tris.reshape(-1)),
                      leaf_size=bvh.leaf_size)


def _safe_inv(d):
    # same guard as traverse._safe_inv
    return jnp.where(jnp.abs(d) > 1e-20, 1.0 / jnp.where(d == 0, 1.0, d),
                     1e20 * jnp.where(d >= 0, 1.0, -1.0))


def _walk(o, d, tmin, tmax, node0, nodes_ref, tris_ref, leaf_size, any_hit):
    """The per-block walk: returns (t, tri, u, v) or the occluded mask."""
    ox, oy, oz = o
    dx, dy, dz = d
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    f2i = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)

    def ld(ref, idx, live):
        return plgpu.load(ref.at[idx], mask=live, other=0.0)

    def body(s):
        node, t, tri, u, v = s
        live = node >= 0
        base = jnp.maximum(node, 0) * _NODE_W
        t0x = (ld(nodes_ref, base, live) - ox) * ix
        t0y = (ld(nodes_ref, base + 1, live) - oy) * iy
        t0z = (ld(nodes_ref, base + 2, live) - oz) * iz
        t1x = (ld(nodes_ref, base + 3, live) - ox) * ix
        t1y = (ld(nodes_ref, base + 4, live) - oy) * iy
        t1z = (ld(nodes_ref, base + 5, live) - oz) * iz
        link = f2i(ld(nodes_ref, base + 6, live))
        skip = f2i(ld(nodes_ref, base + 7, live))
        t_far = tmax if any_hit else t
        near = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.maximum(jnp.minimum(t0z, t1z), tmin))
        far = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.minimum(jnp.maximum(t0z, t1z), t_far))
        hit_box = live & (near <= far)
        leaf = link < 0
        do_leaf = hit_box & leaf
        slot0 = jnp.maximum(-1 - link, 0)
        occluded = jnp.zeros_like(live)
        for k in range(leaf_size):
            rb = (slot0 + k) * _TRI_W
            g = lambda c: ld(tris_ref, rb + c, do_leaf)
            p0x, p0y, p0z = g(0), g(1), g(2)
            e1x, e1y, e1z = g(3), g(4), g(5)
            e2x, e2y, e2z = g(6), g(7), g(8)
            tid = f2i(g(9))
            # Moller-Trumbore, as traverse.intersect_triangles
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            ok_det = jnp.abs(det) > _EPS_DET
            inv_det = jnp.where(ok_det, 1.0 / jnp.where(det == 0, 1.0, det),
                                0.0)
            tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
            uh = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            vh = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            th = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            # closest-hit compares with the best t so far, as the XLA walk
            ok = (do_leaf & (tid >= 0) & ok_det & (uh >= 0.0) & (vh >= 0.0)
                  & (uh + vh <= 1.0) & (th > tmin)
                  & (th < (tmax if any_hit else t)))
            if any_hit:
                occluded = occluded | ok
            else:
                t = jnp.where(ok, th, t)
                tri = jnp.where(ok, tid, tri)
                u = jnp.where(ok, uh, u)
                v = jnp.where(ok, vh, v)
        nxt = jnp.where(hit_box & ~leaf, link, skip)
        if any_hit:
            tri = jnp.where(occluded, 1, tri)  # tri carries the flag
            nxt = jnp.where(occluded, -1, nxt)
        return jnp.where(live, nxt, node), t, tri, u, v

    zf = jnp.zeros_like(tmax)
    init = (node0, tmax, jnp.full_like(node0, 0 if any_hit else -1), zf, zf)
    _, t, tri, u, v = jax.lax.while_loop(
        lambda s: jnp.max(s[0]) >= 0, body, init)
    return t, tri, u, v


def _kernel(ox, oy, oz, dx, dy, dz, tmin, tmax, node0, nodes, tris, *outs,
            leaf_size, any_hit):
    t, tri, u, v = _walk(
        (ox[...], oy[...], oz[...]), (dx[...], dy[...], dz[...]),
        tmin[...], tmax[...], node0[...], nodes, tris, leaf_size, any_hit)
    if any_hit:
        outs[0][...] = tri
    else:
        t_ref, tri_ref, u_ref, v_ref = outs
        t_ref[...] = t
        tri_ref[...] = tri
        u_ref[...] = u
        v_ref[...] = v


@functools.partial(jax.jit, static_argnames=("any_hit", "interpret"))
def _call(tables, o, d, tmin, tmax, active, any_hit, interpret):
    n = o.x.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    f32 = lambda a: jnp.broadcast_to(jnp.asarray(a, jnp.float32), (n,))
    pad = lambda a, fill: jnp.pad(a, (0, n_pad - n), constant_values=fill)
    node0 = jnp.zeros(n, jnp.int32)
    if active is not None:
        node0 = jnp.where(active, node0, -1)
    rays = [pad(f32(a), 0.0) for a in (o.x, o.y, o.z, d.x, d.y, d.z)]
    rays += [pad(f32(tmin), 0.0), pad(f32(tmax), 0.0), pad(node0, -1)]
    nodes, tris = tables.nodes, tables.tris
    lane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,))
    if any_hit:
        out_shape = [jax.ShapeDtypeStruct((n_pad,), jnp.int32)]
    else:
        out_shape = [jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                     jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                     jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                     jax.ShapeDtypeStruct((n_pad,), jnp.float32)]
    outs = pl.pallas_call(
        functools.partial(_kernel, leaf_size=tables.leaf_size,
                          any_hit=any_hit),
        out_shape=out_shape,
        grid=(n_pad // BLOCK,),
        in_specs=[lane] * 9 + [whole(nodes), whole(tris)],
        out_specs=[lane] * len(out_shape),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_walk_any" if any_hit else "bvh_walk_closest",
    )(*rays, nodes, tris)
    if any_hit:
        return outs[0][:n] > 0
    t, tri, u, v = (a[:n] for a in outs)
    return Hit(t=t, tri=tri, u=u, v=v)


def trace_closest_walk(tables: WalkTables, o: Vec3, d: Vec3, tmin, tmax,
                       active: Optional[Array] = None, *,
                       interpret: bool = False) -> Hit:
    """Closest hit per ray in the packed tree `tables` (`pack`); otherwise
    the contract of `traverse.trace_closest`."""
    platform.require_kernel_backend("trace_closest_walk", interpret)
    return _call(tables, o, d, tmin, tmax, active, False, interpret)


def trace_any_walk(tables: WalkTables, o: Vec3, d: Vec3, tmin, tmax,
                   active: Optional[Array] = None, *,
                   interpret: bool = False) -> Array:
    """Occluded mask per ray in the packed tree `tables` (`pack`);
    otherwise the contract of `traverse.trace_any`."""
    platform.require_kernel_backend("trace_any_walk", interpret)
    return _call(tables, o, d, tmin, tmax, active, True, interpret)
