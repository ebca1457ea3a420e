"""Mesh storage: host mirror + device view.

Reference analogs:
  * MeshStorage / DeviceMeshStorage (src/mesh/MeshStorage.h) — indexed
    triangle mesh with separate vertex/normal/uv index streams, per-triangle
    material indices, groups with names.
  * MeshView (src/mesh/MeshView.h:96-170) — the POD device view passed by
    value into kernels.

Differences: the device view is a pytree of flat SoA jnp arrays
(component-per-array), so triangle fetches are 1D gathers that vectorize over
the wavefront; "host -> device mirror" (renderer.cu:912 `m_mesh_d = m_mesh`)
is a single `jax.device_put` of the pytree (replicated across the device
mesh by the parallel layer).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.core.math import Vec3, cross, normalize
from fermat_tpu.scene.materials import HostMaterial, MaterialTable

Array = jax.Array


@dataclass
class MeshStorage:
    """Host-side mutable mesh (numpy), built by loaders; MeshStorage.h analog."""

    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    triangles: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    normal_indices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))  # -1 => face normal
    uvs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    uv_indices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))  # -1 => zero uv
    material_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int32))
    materials: List[HostMaterial] = field(default_factory=list)
    group_names: List[str] = field(default_factory=list)
    group_offsets: np.ndarray = field(default_factory=lambda: np.zeros((1,), np.int32))
    # compressed attribute storage (MeshStorage.h:146-147) — when set, the
    # float arrays above are empty and attributes decompress on demand
    normals_packed: "np.ndarray" = None  # (N,) uint32 octahedral 16+16
    uvs_packed: "np.ndarray" = None  # (N,) uint32 fixed 15-bit pair
    uv_bias: "np.ndarray" = None  # (2,) f32
    uv_scale: "np.ndarray" = None  # (2,) f32

    def compress_normals(self) -> "MeshStorage":
        """Swap float normals for the packed octahedral codec
        (MeshStorage::compress_normals, applied by renderer.cu:735)."""
        from fermat_tpu.scene.compression import compress_normals as _c

        if self.normals.shape[0] and self.normals_packed is None:
            self.normals_packed = _c(self.normals)
            self.normals = np.zeros((0, 3), np.float32)
        return self

    def compress_tex(self) -> "MeshStorage":
        """Swap float uvs for the fixed-point codec
        (MeshStorage::compress_tex, renderer.cu:736)."""
        from fermat_tpu.scene.compression import compress_uv, uv_bias_scale

        if self.uvs.shape[0] and self.uvs_packed is None:
            self.uv_bias, self.uv_scale = uv_bias_scale(self.uvs)
            self.uvs_packed = compress_uv(self.uvs, self.uv_bias, self.uv_scale)
            self.uvs = np.zeros((0, 2), np.float32)
        return self

    def _resolved_normals(self) -> np.ndarray:
        if self.normals_packed is not None and self.normals.shape[0] == 0:
            from fermat_tpu.scene.compression import decompress_normals

            return decompress_normals(self.normals_packed)
        return self.normals

    def _resolved_uvs(self) -> np.ndarray:
        if self.uvs_packed is not None and self.uvs.shape[0] == 0:
            from fermat_tpu.scene.compression import decompress_uv

            return decompress_uv(self.uvs_packed, self.uv_bias, self.uv_scale)
        return self.uvs

    @property
    def n_triangles(self) -> int:
        return self.triangles.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    # -- edits ------------------------------------------------------------
    def transform(self, m: np.ndarray) -> "MeshStorage":
        """Apply a 4x4 affine transform in place (fa-scene instancing)."""
        v = self.vertices @ m[:3, :3].T + m[:3, 3]
        self.vertices = v.astype(np.float32)
        if self.normals.shape[0]:
            ninv = np.linalg.inv(m[:3, :3]).T
            n = self.normals @ ninv.T
            n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
            self.normals = n.astype(np.float32)
        return self

    def merge(self, other: "MeshStorage") -> "MeshStorage":
        """Append another mesh (MeshStorage.h merge used by the .fa loader)."""
        mat_off = len(self.materials)
        vtx_off = self.n_vertices
        nrm_off = self.normals.shape[0]
        uv_off = self.uvs.shape[0]
        tri_off = self.n_triangles
        # an empty per-corner index array means "no attribute on this
        # mesh"; once meshes are merged that shorthand must become
        # explicit -1 rows or the row count diverges from n_triangles
        def idx_rows(idx, n):
            return idx if idx.shape[0] == n else np.full((n, 3), -1, np.int32)

        self.vertices = np.concatenate([self.vertices, other.vertices])
        self.normals = np.concatenate([self.normals, other.normals])
        oni = idx_rows(other.normal_indices, other.n_triangles).copy()
        oni[oni >= 0] += nrm_off
        self.normal_indices = np.concatenate(
            [idx_rows(self.normal_indices, tri_off), oni])
        self.uvs = np.concatenate([self.uvs, other.uvs])
        oui = idx_rows(other.uv_indices, other.n_triangles).copy()
        oui[oui >= 0] += uv_off
        self.uv_indices = np.concatenate(
            [idx_rows(self.uv_indices, tri_off), oui])
        self.triangles = np.concatenate([self.triangles, other.triangles + vtx_off])
        self.material_ids = np.concatenate(
            [self.material_ids, other.material_ids + mat_off]
        )
        self.materials = self.materials + list(other.materials)
        self.group_names = self.group_names + list(other.group_names)
        self.group_offsets = np.concatenate(
            [self.group_offsets[:-1], other.group_offsets + tri_off]
        )
        return self

    def bbox(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n_vertices == 0:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        return self.vertices.min(0), self.vertices.max(0)

    def filtered(self, keep: np.ndarray) -> "MeshStorage":
        """A copy with only the triangles where keep[t] (vertices shared).

        Used to build masked shadow-ray geometry (the reference instead
        filters per-ray in the any-hit, optix_base_shadow_shaders.h:55-59;
        with static flags a pre-filtered triangle set is the simpler shape).
        Groups collapse to one — occlusion rays never read group names.
        """
        keep = np.asarray(keep, bool)
        t = self.triangles[keep]
        return MeshStorage(
            vertices=self.vertices,
            triangles=t,
            normals=self.normals,
            normal_indices=self.normal_indices[keep]
            if self.normal_indices.shape[0] == self.n_triangles
            else np.full_like(t, -1),
            uvs=self.uvs,
            uv_indices=self.uv_indices[keep]
            if self.uv_indices.shape[0] == self.n_triangles
            else np.full_like(t, -1),
            material_ids=self.material_ids[keep],
            materials=self.materials,
            group_names=["shadow"],
            group_offsets=np.asarray([0, t.shape[0]], np.int32),
        )

    def device_view(self) -> "MeshView":
        """Build the kernel-facing SoA pytree (MeshView.h:96 analog)."""
        t = self.triangles.astype(np.int32)
        v = self.vertices.astype(np.float32)
        # Resolve per-corner shading normals to dense (T,3)-corner arrays at
        # upload time: -1 slots fall back to the geometric normal. This trades
        # memory for removing one indirection from the hot gather path.
        p0 = v[t[:, 0]]
        p1 = v[t[:, 1]]
        p2 = v[t[:, 2]]
        gn = np.cross(p1 - p0, p2 - p0)
        gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
        corner_n = np.repeat(gn[:, None, :], 3, axis=1)  # (T,3corner,3)
        normals = self._resolved_normals()
        if normals.shape[0]:
            ni = self.normal_indices
            ok = ni >= 0
            corner_n[ok] = normals[np.where(ok, ni, 0)][ok]
        corner_uv = np.zeros((self.n_triangles, 3, 2), np.float32)
        uvs = self._resolved_uvs()
        if uvs.shape[0]:
            ui = self.uv_indices
            ok = ui >= 0
            corner_uv[ok] = uvs[np.where(ok, ui, 0)][ok]

        mat = [m.finalize_flags() for m in self.materials] or [HostMaterial("default")]
        # texture-LOD base: uv-space area vs world-space area per triangle
        wld_area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1)
        uv_e1 = corner_uv[:, 1] - corner_uv[:, 0]
        uv_e2 = corner_uv[:, 2] - corner_uv[:, 0]
        uv_area = 0.5 * np.abs(uv_e1[:, 0] * uv_e2[:, 1] - uv_e1[:, 1] * uv_e2[:, 0])
        lod_base = 0.5 * np.log2(
            (uv_area + 1e-20) / (wld_area + 1e-20)
        ).astype(np.float32)
        j = jnp.asarray
        return MeshView(
            p0=Vec3(j(p0[:, 0]), j(p0[:, 1]), j(p0[:, 2])),
            e1=Vec3(j((p1 - p0)[:, 0]), j((p1 - p0)[:, 1]), j((p1 - p0)[:, 2])),
            e2=Vec3(j((p2 - p0)[:, 0]), j((p2 - p0)[:, 1]), j((p2 - p0)[:, 2])),
            gn=Vec3(j(gn[:, 0]), j(gn[:, 1]), j(gn[:, 2])),
            n0=Vec3(j(corner_n[:, 0, 0]), j(corner_n[:, 0, 1]), j(corner_n[:, 0, 2])),
            n1=Vec3(j(corner_n[:, 1, 0]), j(corner_n[:, 1, 1]), j(corner_n[:, 1, 2])),
            n2=Vec3(j(corner_n[:, 2, 0]), j(corner_n[:, 2, 1]), j(corner_n[:, 2, 2])),
            uv0=j(corner_uv[:, 0]),
            uv1=j(corner_uv[:, 1]),
            uv2=j(corner_uv[:, 2]),
            material_id=j(
                self.material_ids.astype(np.int32)
                if self.material_ids.shape[0]
                else np.zeros(self.n_triangles, np.int32)
            ),
            lod_base=j(lod_base),
            materials=MaterialTable.from_host(mat),
        )


class MeshView(NamedTuple):
    """Device-side triangle soup, pre-gathered per corner (MeshView.h:96-170).

    Triangles stored as (p0, e1, e2) so Moller-Trumbore needs no vertex
    indirection; shading normals/uvs pre-resolved per corner.
    """

    p0: Vec3  # (T,)
    e1: Vec3  # p1 - p0
    e2: Vec3  # p2 - p0
    gn: Vec3  # geometric unit normal
    n0: Vec3  # shading normals at corners
    n1: Vec3
    n2: Vec3
    uv0: Array  # (T, 2)
    uv1: Array
    uv2: Array
    material_id: Array  # (T,)
    lod_base: Array  # (T,) 0.5*log2(uv_area/world_area) for ray-cone LOD
    materials: MaterialTable

    @property
    def n_triangles(self) -> int:
        return self.material_id.shape[0]

    def packed_rows(self) -> Array:
        """All per-triangle attributes as one (T, 28) row matrix.

        Column layout: p0(0:3) e1(3:6) e2(6:9) gn(9:12) n0(12:15) n1(15:18)
        n2(18:21) uv0(21:23) uv1(23:25) uv2(25:27) mat_id(27).
        Built inside jit (XLA folds/CSEs it); lets a hit fetch move one row
        instead of ~28 scalar gathers (fermat_tpu.ops.gather).
        """
        return jnp.stack(
            [
                self.p0.x, self.p0.y, self.p0.z,
                self.e1.x, self.e1.y, self.e1.z,
                self.e2.x, self.e2.y, self.e2.z,
                self.gn.x, self.gn.y, self.gn.z,
                self.n0.x, self.n0.y, self.n0.z,
                self.n1.x, self.n1.y, self.n1.z,
                self.n2.x, self.n2.y, self.n2.z,
                self.uv0[:, 0], self.uv0[:, 1],
                self.uv1[:, 0], self.uv1[:, 1],
                self.uv2[:, 0], self.uv2[:, 1],
                self.material_id.astype(jnp.float32),
                self.lod_base,
            ],
            axis=1,
        )

    def fetch(self, tri: Array):
        """Row fetch of all triangle attributes for hit lanes.

        Returns (p0, e1, e2, gn, n0, n1, n2, uv0, uv1, uv2, mat_id).
        """
        from fermat_tpu.ops.gather import gather_rows

        rows = gather_rows(self.packed_rows(), tri)
        vec = lambda c: Vec3(rows[:, c], rows[:, c + 1], rows[:, c + 2])
        return (
            vec(0), vec(3), vec(6), vec(9), vec(12), vec(15), vec(18),
            rows[:, 21:23], rows[:, 23:25], rows[:, 25:27],
            jnp.round(rows[:, 27]).astype(jnp.int32),
        )

    def fetch_lod_base(self, tri: Array) -> Array:
        """Per-tri texture-LOD base = 0.5*log2(uv_area/world_area) (ray cones)."""
        from fermat_tpu.ops.gather import gather_rows

        return gather_rows(self.packed_rows(), tri)[:, 28]

    def shade_rows(self) -> Array:
        """(T, 52) fully-joined shading table: packed_rows (29 cols —
        geometry, corner normals/uvs, mat_id, lod base) ++ the material row
        pre-gathered per TRIANGLE (19 float cols + 4 texture-slot ids).

        A hit shade becomes ONE row fetch instead of three separate
        fetches keyed by tri/mat_id/tri. The (M -> T)
        material join is loop-invariant, so XLA hoists it out of the
        bounce fori_loop; the per-bounce cost is the single 52-col fetch.
        """
        m = self.materials
        maps = jnp.stack(
            [m.diffuse_map, m.specular_map, m.emissive_map, m.bump_map],
            axis=1,
        ).astype(jnp.float32)
        mfull = jnp.concatenate([m.packed_rows(), maps], axis=1)
        return jnp.concatenate(
            [self.packed_rows(), mfull[self.material_id]], axis=1
        )

    def shade_fetch(self, tri: Array, u: Array, v: Array, table=None):
        """One-fetch differential geometry + material lanes at a hit.

        Returns (pos, gn, sn, uv (N,2), mat_id, lod_base,
        MaterialTable-of-lanes) — the fused equivalent of
        interpolate() + materials.gather() + fetch_lod_base(). Pass the
        precomputed `table` (shade_rows()) from OUTSIDE any bounce loop:
        XLA does not hoist the (M -> T) material join out of fori_loops.
        """
        from fermat_tpu.ops.gather import gather_rows

        r = gather_rows(self.shade_rows() if table is None else table, tri)
        # detach the geometry/uv columns: the joined table would otherwise
        # make hit positions symbolic functions of MATERIAL leaves (zero
        # tangents, but tracers), dragging the next bounce's ray origins
        # into the non-reverse-differentiable traversal while_loops.
        # Traversal geometry is detached by design (module docstring).
        r = jnp.concatenate(
            [jax.lax.stop_gradient(r[:, :29]), r[:, 29:]], axis=1
        )
        vec = lambda c: Vec3(r[:, c], r[:, c + 1], r[:, c + 2])
        p0, e1, e2, gn = vec(0), vec(3), vec(6), vec(9)
        n0, n1, n2 = vec(12), vec(15), vec(18)
        pos = p0 + e1 * u + e2 * v
        w = 1.0 - u - v
        sn = normalize(n0 * w + n1 * u + n2 * v)
        uv = (r[:, 21:23] * w[:, None] + r[:, 23:25] * u[:, None]
              + r[:, 25:27] * v[:, None])
        mat_id = jnp.round(r[:, 27]).astype(jnp.int32)
        lod_base = r[:, 28]
        mats = MaterialTable(
            diffuse=vec(29),
            specular=vec(32),
            emissive=vec(35),
            diffuse_trans=vec(38),
            reflectivity=vec(41),
            roughness=r[:, 44],
            ior=r[:, 45],
            opacity=r[:, 46],
            flags=jnp.round(r[:, 47]).astype(jnp.int32),
            diffuse_map=jnp.round(r[:, 48]).astype(jnp.int32),
            specular_map=jnp.round(r[:, 49]).astype(jnp.int32),
            emissive_map=jnp.round(r[:, 50]).astype(jnp.int32),
            bump_map=jnp.round(r[:, 51]).astype(jnp.int32),
        )
        return pos, gn, sn, uv, mat_id, lod_base, mats

    def interpolate(self, tri: Array, u: Array, v: Array):
        """Differential geometry at hit (tri, u, v) — setup_differential_geometry
        (src/vertex.h:69-115, src/mesh_utils.h) analog.

        Returns (position Vec3, geometric normal Vec3, shading normal Vec3,
        uv (N,2), material ids).
        """
        p0, e1, e2, gn, n0, n1, n2, uv0, uv1, uv2, mat_id = self.fetch(tri)
        pos = p0 + e1 * u + e2 * v
        w = 1.0 - u - v
        n = normalize(n0 * w + n1 * u + n2 * v)
        uv = uv0 * w[:, None] + uv1 * u[:, None] + uv2 * v[:, None]
        return pos, gn, n, uv, mat_id

    def triangle_areas(self) -> Array:
        c = cross(self.e1, self.e2)
        return 0.5 * jnp.sqrt(jnp.maximum(c.x * c.x + c.y * c.y + c.z * c.z, 0.0))
