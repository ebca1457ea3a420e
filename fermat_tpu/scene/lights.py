"""Light models + mesh-emitter sampling.

Reference analogs:
  * src/lights.h:47-330 — LightType{Point,Disk,Rectangle,Directional,Mesh,VTL},
    manual-dispatch Light base with sample/map/eval pdf.
  * src/mesh_lights.{h,cu} — MeshLightsStorage: emissive-triangle CDF weighted
    by EDF x area (mesh_lights.cu:158-520), uniform-mesh NEE sampling.
  * src/edf.h:49 — Lambertian EDF: radiance == emissive color on the front
    side (cugar/bsdf/lambert_edf.h:60-64).

Design: the CDF is a flat device array sampled with a vectorized
`searchsorted` per lane; the tri -> pdf lookup for MIS is a dense (T,) array
gather (no hash). VPL presampling and the light BVH / clustered-RL machinery
build on this in fermat_tpu.integrators.rl (later tier).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.core.math import Vec3, dot, normalize
from fermat_tpu.core.sampling import square_to_uniform_triangle
from fermat_tpu.scene.mesh import MeshView

Array = jax.Array


class MeshLightsView(NamedTuple):
    """Device view over the emissive set (MeshLightsStorage analog)."""

    cdf: Array  # (T,) inclusive, normalized to 1 over ALL triangles (mesh_lights.cu:166-285)
    pdf_area: Array  # (T,) area-measure pdf of sampling a point on tri t (0 for non-emissive)
    has_lights: Array  # () bool
    rows: Array  # (T, 23) light-sample row table: p0 e1 e2 gn Le pdf_area uv0 duv1 duv2 emap

    @staticmethod
    def build(mesh: MeshView, weights: Optional[Array] = None) -> "MeshLightsView":
        """Weight = luminance(emissive) * area (EDF x area integral,
        mesh_lights.cu:164-254); pass `weights` (T,) to fold in the
        texture-integral estimate (mesh_lights.textured_tri_energies)."""
        mats = mesh.materials
        em = mats.emissive
        area = mesh.triangle_areas()
        if weights is None:
            lum = (
                0.2126 * em.x[mesh.material_id]
                + 0.7152 * em.y[mesh.material_id]
                + 0.0722 * em.z[mesh.material_id]
            )
            w = jnp.maximum(lum, 0.0) * area
        else:
            w = jnp.maximum(jnp.asarray(weights, jnp.float32), 0.0)
        total = jnp.sum(w)
        has = total > 0.0
        safe_total = jnp.where(has, total, 1.0)
        cdf = jnp.cumsum(w) / safe_total
        pdf_area = jnp.where(
            (w > 0.0) & (area > 0.0), (w / safe_total) / jnp.maximum(area, 1e-20), 0.0
        )
        # pre-baked light-sample rows: one 23-column fetch per NEE sample
        # instead of a 28-col geometry fetch + a second emissive fetch;
        # pdf_area rides as col 15, texture uvs + emissive map as cols
        # 16:23 so a textured-emitter NEE needs no mesh gather either
        emap = mats.emissive_map[mesh.material_id].astype(jnp.float32)
        rows = jnp.stack(
            [
                mesh.p0.x, mesh.p0.y, mesh.p0.z,
                mesh.e1.x, mesh.e1.y, mesh.e1.z,
                mesh.e2.x, mesh.e2.y, mesh.e2.z,
                mesh.gn.x, mesh.gn.y, mesh.gn.z,
                em.x[mesh.material_id], em.y[mesh.material_id], em.z[mesh.material_id],
                pdf_area,
                mesh.uv0[:, 0], mesh.uv0[:, 1],
                mesh.uv1[:, 0] - mesh.uv0[:, 0], mesh.uv1[:, 1] - mesh.uv0[:, 1],
                mesh.uv2[:, 0] - mesh.uv0[:, 0], mesh.uv2[:, 1] - mesh.uv0[:, 1],
                emap,
            ],
            axis=1,
        )
        return MeshLightsView(cdf=cdf, pdf_area=pdf_area, has_lights=has, rows=rows)

    def sample(
        self, mesh: MeshView, u0: Array, u1: Array, u2: Array
    ) -> Tuple[Vec3, Vec3, Vec3, Array, Array]:
        """Sample one point on the emissive set per lane.

        Returns (position, normal, Le radiance, pdf_area, tri_id).
        Mirrors MeshLightsStorage::sample (mesh_lights.cu:298-330): CDF
        upper-bound, then uniform barycentrics.
        """
        t_count = self.cdf.shape[0]
        if t_count <= 2048:
            # fused compare+sum upper_bound — avoids searchsorted's
            # gather-based binary search (~log T gathers/lane)
            tri = jnp.sum(
                (self.cdf[None, :] <= u2[:, None]).astype(jnp.int32), axis=1
            )
        else:
            tri = jnp.searchsorted(self.cdf, u2, side="right").astype(jnp.int32)
        tri = jnp.clip(tri, 0, t_count - 1).astype(jnp.int32)
        b0, b1 = square_to_uniform_triangle(u0, u1)
        # one packed row fetch from the pre-baked light table
        from fermat_tpu.ops.gather import gather_rows

        r = gather_rows(self.rows, tri)
        vec = lambda cidx: Vec3(r[:, cidx], r[:, cidx + 1], r[:, cidx + 2])
        p0, e1, e2, n, le = vec(0), vec(3), vec(6), vec(9), vec(12)
        pos = p0 + e1 * b0 + e2 * b1
        pdf = r[:, 15]  # col 15: no separate (T,) scalar gather
        return pos, n, le, pdf, tri

    def sample_ex(self, mesh: MeshView, u0: Array, u1: Array, u2: Array):
        """sample() plus the sampled point's texture coords and the
        emitter's emissive-map index (for textured-emitter radiance)."""
        t_count = self.cdf.shape[0]
        if t_count <= 2048:
            tri = jnp.sum(
                (self.cdf[None, :] <= u2[:, None]).astype(jnp.int32), axis=1
            )
        else:
            tri = jnp.searchsorted(self.cdf, u2, side="right").astype(jnp.int32)
        tri = jnp.clip(tri, 0, t_count - 1).astype(jnp.int32)
        b0, b1 = square_to_uniform_triangle(u0, u1)
        from fermat_tpu.ops.gather import gather_rows

        r = gather_rows(self.rows, tri)
        vec = lambda cidx: Vec3(r[:, cidx], r[:, cidx + 1], r[:, cidx + 2])
        p0, e1, e2, n, le = vec(0), vec(3), vec(6), vec(9), vec(12)
        pos = p0 + e1 * b0 + e2 * b1
        pdf = r[:, 15]
        uv_u = r[:, 16] + r[:, 18] * b0 + r[:, 20] * b1
        uv_v = r[:, 17] + r[:, 19] * b0 + r[:, 21] * b1
        emap = r[:, 22].astype(jnp.int32)
        return pos, n, le, pdf, tri, uv_u, uv_v, emap

    def pdf_area_of(self, tri: Array) -> Array:
        """Area pdf for MIS when a BSDF ray hits an emitter (tri >= 0)."""
        from fermat_tpu.ops.gather import gather_rows

        return gather_rows(self.pdf_area[:, None], jnp.maximum(tri, 0))[:, 0]


def _emissive_of(mesh: MeshView, mid: Array) -> Vec3:
    """Per-lane emissive fetch via one-hot matmul over the tiny table."""
    from fermat_tpu.ops.gather import gather_rows

    em = mesh.materials.emissive
    rows = gather_rows(jnp.stack([em.x, em.y, em.z], axis=1), mid)
    return Vec3(rows[:, 0], rows[:, 1], rows[:, 2])


def emitter_radiance(
    mesh: MeshView, tri: Array, wo_world: Vec3, gn: Vec3 = None, mid: Array = None
) -> Vec3:
    """Le leaving a surface toward wo_world (front side only) — edf.h Lambert.

    Pass (gn, mid) when already fetched at the hit to avoid a second row
    fetch (the PT shade path has them from interpolate()).
    """
    if gn is None or mid is None:
        tri_c = jnp.maximum(tri, 0)
        p0, e1, e2, gn_f, *_rest, mid_f = mesh.fetch(tri_c)
        gn = gn_f if gn is None else gn
        mid = mid_f if mid is None else mid
    front = dot(gn, wo_world) > 0.0
    le = _emissive_of(mesh, mid)
    z = jnp.zeros_like(gn.x)
    return Vec3(
        jnp.where(front, le.x, z),
        jnp.where(front, le.y, z),
        jnp.where(front, le.z, z),
    )


class DirectionalLightsView(NamedTuple):
    """SoA directional lights (lights.h:249 DirectionalLight)."""

    dir_x: Array  # (L,) direction the light TRAVELS (towards the scene)
    dir_y: Array
    dir_z: Array
    col_x: Array
    col_y: Array
    col_z: Array

    @staticmethod
    def build(defs) -> "DirectionalLightsView":
        d = np.array([l.direction for l in defs], np.float32).reshape(-1, 3)
        if d.shape[0]:
            d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-20)
        c = np.array([l.color for l in defs], np.float32).reshape(-1, 3)
        j = jnp.asarray
        return DirectionalLightsView(
            j(d[:, 0]), j(d[:, 1]), j(d[:, 2]), j(c[:, 0]), j(c[:, 1]), j(c[:, 2])
        )

    @property
    def count(self) -> int:
        return self.dir_x.shape[0]
