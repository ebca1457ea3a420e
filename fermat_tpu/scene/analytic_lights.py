"""Analytic light types: Point / Disk / Rectangle.

Reference: src/lights.h LightType{Point, Disk, Rectangle, Directional, Mesh,
VTL} with manual-dispatch sample/eval (lights.h:47-330, DiskLight:175).

Routing:
  * Disk / Rectangle area lights become EMISSIVE GEOMETRY at scene build —
    tessellated into the mesh with an emissive material. Every integrator
    (PT NEE+MIS, BPT connections, RL clustering, PSF) then handles them
    through the one mesh-emitter path, exactly as the reference's mesh-light
    machinery subsumes its VTLs.
  * Point lights are delta distributions (no area) and are sampled in the
    delta-light NEE loop beside directional lights.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.scene.materials import HostMaterial
from fermat_tpu.scene.mesh import MeshStorage


def _emissive_material(radiance) -> HostMaterial:
    m = HostMaterial("light")
    m.emissive = tuple(float(c) for c in radiance)
    return m


def _basis(n: np.ndarray):
    n = n / max(np.linalg.norm(n), 1e-12)
    a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
    t = np.cross(n, a)
    t /= max(np.linalg.norm(t), 1e-12)
    return t, np.cross(n, t)


def add_rect_light(
    mesh: MeshStorage, center, normal, u_extent: float, v_extent: float, radiance
) -> MeshStorage:
    """Rectangle area light -> 2 emissive triangles (lights.h Rectangle)."""
    c = np.asarray(center, np.float32)
    t, b = _basis(np.asarray(normal, np.float32))
    corners = [
        c - t * u_extent - b * v_extent,
        c + t * u_extent - b * v_extent,
        c + t * u_extent + b * v_extent,
        c - t * u_extent + b * v_extent,
    ]
    sub = _quad_mesh(corners, radiance)
    return mesh.merge(sub)


def add_disk_light(
    mesh: MeshStorage, center, normal, radius: float, radiance, segments: int = 16
) -> MeshStorage:
    """Disk area light -> triangle fan (lights.h DiskLight:175)."""
    c = np.asarray(center, np.float32)
    t, b = _basis(np.asarray(normal, np.float32))
    verts = [c]
    for k in range(segments):
        a = 2 * np.pi * k / segments
        verts.append(c + (t * np.cos(a) + b * np.sin(a)) * radius)
    tris = []
    for k in range(segments):
        tris.append([0, 1 + k, 1 + (k + 1) % segments])
    v = np.asarray(verts, np.float32)
    tarr = np.asarray(tris, np.int32)
    sub = MeshStorage(
        vertices=v,
        triangles=tarr,
        normal_indices=np.full_like(tarr, -1),
        uv_indices=np.full_like(tarr, -1),
        material_ids=np.zeros(tarr.shape[0], np.int32),
        materials=[_emissive_material(radiance)],
        group_names=["disk_light"],
        group_offsets=np.asarray([0, tarr.shape[0]], np.int32),
    )
    return mesh.merge(sub)


def _quad_mesh(corners, radiance) -> MeshStorage:
    v = np.asarray(corners, np.float32)
    t = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return MeshStorage(
        vertices=v,
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1),
        material_ids=np.zeros(2, np.int32),
        materials=[_emissive_material(radiance)],
        group_names=["rect_light"],
        group_offsets=np.asarray([0, 2], np.int32),
    )


class PointLightsView(NamedTuple):
    """SoA point lights (delta; lights.h Point). Intensity in W/sr."""

    px: jax.Array
    py: jax.Array
    pz: jax.Array
    ix: jax.Array
    iy: jax.Array
    iz: jax.Array

    @staticmethod
    def build(defs) -> "PointLightsView":
        p = np.array([l[0] for l in defs], np.float32).reshape(-1, 3)
        i = np.array([l[1] for l in defs], np.float32).reshape(-1, 3)
        j = jnp.asarray
        return PointLightsView(
            j(p[:, 0]), j(p[:, 1]), j(p[:, 2]), j(i[:, 0]), j(i[:, 1]), j(i[:, 2])
        )

    @property
    def count(self) -> int:
        return self.px.shape[0]


class AreaLightsView(NamedTuple):
    """Analytic (un-tessellated) disk/rect area lights with exact
    sample/map/pdf forms (lights.h:175-249 DiskLight; kRectangle is declared
    in the reference enum, lights.h:51, with no struct — the rect form here
    follows the same pattern with pdf = 1/area).

    Like the reference (DiskLight::intersect_impl is a TODO returning
    t = -1), analytic lights are INVISIBLE to BSDF rays, so their NEE
    carries MIS weight 1. `kind`: 0 = disk (radius = ru), 1 = rect
    (half-extents ru, rv along u, v).
    """

    kind: "object"  # (L,) i32
    px: "object"; py: "object"; pz: "object"  # center
    ux: "object"; uy: "object"; uz: "object"  # tangent u (unit)
    vx: "object"; vy: "object"; vz: "object"  # tangent v (unit)
    nx: "object"; ny: "object"; nz: "object"  # emission normal (unit)
    cx: "object"; cy: "object"; cz: "object"  # radiance color
    ru: "object"  # (L,) disk radius / rect u half-extent
    rv: "object"  # (L,) rect v half-extent (unused for disks)

    @staticmethod
    def build(defs) -> "AreaLightsView":
        """defs: iterable of dicts {kind: 'disk'|'rect', pos, normal, color,
        radius | (u_extent, v_extent)}."""
        import jax.numpy as jnp

        rows = []
        for d in defs:
            n = np.asarray(d["normal"], np.float32)
            n = n / max(np.linalg.norm(n), 1e-12)
            t, b = _basis(n)
            kind = 0 if d.get("kind", "disk") == "disk" else 1
            ru = float(d.get("radius", d.get("u_extent", 1.0)))
            rv = float(d.get("v_extent", ru))
            rows.append((kind, *np.asarray(d["pos"], np.float32), *t, *b,
                         *n, *np.asarray(d["color"], np.float32), ru, rv))
        if not rows:
            z = jnp.zeros((0,), jnp.float32)
            zn = np.zeros((0,), np.float32)
            return AreaLightsView(np.zeros((0,), np.int32),
                                  *([z] * 15), zn, zn)
        a = np.asarray(rows, np.float32)
        c = lambda i: jnp.asarray(a[:, i])
        # kind / extents are STATIC host config (they steer python-level
        # branches at trace time), everything else is a device leaf
        return AreaLightsView(
            kind=a[:, 0].astype(np.int32),
            px=c(1), py=c(2), pz=c(3), ux=c(4), uy=c(5), uz=c(6),
            vx=c(7), vy=c(8), vz=c(9), nx=c(10), ny=c(11), nz=c(12),
            cx=c(13), cy=c(14), cz=c(15),
            ru=a[:, 16].copy(), rv=a[:, 17].copy(),
        )

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    def map(self, li: int, u0, u1):
        """(prim, uv) -> surface element: (pos Vec3, normal Vec3, Le Vec3,
        pdf_area). Disk: square_to_unit_disk warp, pdf = 1/(pi r^2)
        (lights.h:219-233); rect: bilinear in [-ru, ru] x [-rv, rv],
        pdf = 1/(4 ru rv)."""
        import jax.numpy as jnp

        from fermat_tpu.core.math import Vec3
        from fermat_tpu.core.sampling import square_to_uniform_disk

        dx, dy = square_to_uniform_disk(u0, u1)
        ru = float(self.ru[li])
        rv = float(self.rv[li])
        if int(self.kind[li]) == 0:
            ox = dx * ru
            oy = dy * ru
            pdf = 1.0 / (np.pi * ru * ru)
        else:
            ox = (u0 * 2.0 - 1.0) * ru
            oy = (u1 * 2.0 - 1.0) * rv
            pdf = 1.0 / (4.0 * ru * rv)
        pos = Vec3(
            self.px[li] + self.ux[li] * ox + self.vx[li] * oy,
            self.py[li] + self.uy[li] * ox + self.vy[li] * oy,
            self.pz[li] + self.uz[li] * ox + self.vz[li] * oy,
        )
        sh = jnp.shape(u0)
        nrm = Vec3(*(jnp.broadcast_to(a[li], sh)
                     for a in (self.nx, self.ny, self.nz)))
        le = Vec3(*(jnp.broadcast_to(a[li], sh)
                    for a in (self.cx, self.cy, self.cz)))
        return pos, nrm, le, jnp.full(sh, pdf, jnp.float32)

    def sample(self, li: int, u0, u1):
        """sample_impl: draw a surface element (same as map at (u0, u1))."""
        return self.map(li, u0, u1)

    def pdf_area(self, li: int):
        """Area pdf of the uniform surface sampler (constant per light)."""
        if int(self.kind[li]) == 0:
            return 1.0 / (np.pi * float(self.ru[li]) ** 2)
        return 1.0 / (4.0 * float(self.ru[li]) * float(self.rv[li]))
