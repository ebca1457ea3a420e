"""Material table — SoA analog of MeshMaterial (src/mesh/MeshView.h:55-90).

The reference stores one AoS MeshMaterial per slot {diffuse, diffuse_trans,
ambient, specular, emissive, reflectivity, roughness, IoR, opacity, flags,
6 texture refs}. Here the table is a struct-of-arrays so a wavefront of
rays can gather each field as a flat 1D gather (lane-friendly), and so every
field is differentiable (the inverse-rendering path takes gradients w.r.t.
this pytree directly).

Roughness from OBJ phong exponent follows MeshStorage.cpp:163:
roughness = 1/Ns (or 1 if Ns == 0).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.core.math import Vec3

Array = jax.Array

# material flags (src/mesh/MeshView.h flags + renderer.cu:734-744 flag setup).
# The low bits mirror the reference's shadow-ray masks: NEE shadow rays carry
# mask 0x1 (direct, pathtracer_core.h:981) or 0x2 (indirect, :1099) and the
# shadow any-hit ignores triangles with (ray.mask & flags) != 0
# (optix_base_shadow_shaders.h:59) — i.e. these bits make a material
# invisible to that class of shadow rays.
FLAG_SHADOW_DIRECT_IGNORE = 1 << 0
FLAG_SHADOW_INDIRECT_IGNORE = 1 << 1
FLAG_EMISSIVE = 1 << 8


class MaterialTable(NamedTuple):
    """Per-material arrays; index with a (N,) material-id gather."""

    diffuse: Vec3
    specular: Vec3
    emissive: Vec3
    diffuse_trans: Vec3
    reflectivity: Vec3
    roughness: Array  # (M,)
    ior: Array  # (M,)
    opacity: Array  # (M,)
    flags: Array  # (M,) int32
    # texture slots; -1 = none (texture storage in scene.textures)
    diffuse_map: Array  # (M,) int32
    specular_map: Array
    emissive_map: Array
    bump_map: Array

    @property
    def count(self) -> int:
        return self.roughness.shape[0]

    def packed_rows(self) -> Array:
        """Float fields as one (M, 19) row matrix (see ops.gather rationale):
        diffuse(0:3) specular(3:6) emissive(6:9) diffuse_trans(9:12)
        reflectivity(12:15) roughness(15) ior(16) opacity(17) flags(18)."""
        return jnp.stack(
            [
                self.diffuse.x, self.diffuse.y, self.diffuse.z,
                self.specular.x, self.specular.y, self.specular.z,
                self.emissive.x, self.emissive.y, self.emissive.z,
                self.diffuse_trans.x, self.diffuse_trans.y, self.diffuse_trans.z,
                self.reflectivity.x, self.reflectivity.y, self.reflectivity.z,
                self.roughness, self.ior, self.opacity,
                self.flags.astype(jnp.float32),
            ],
            axis=1,
        )

    def gather(self, mat_id: Array) -> "MaterialTable":
        """Per-lane material fetch: returns a MaterialTable of (N,) arrays.

        One gather_rows fetch over the packed row matrix instead of ~20
        scalar gathers per lane (texture-slot ids are fetched as plain
        gathers only because they are not needed on hot shading lanes yet).
        """
        from fermat_tpu.ops.gather import gather_rows

        r = gather_rows(self.packed_rows(), mat_id)
        vec = lambda c: Vec3(r[:, c], r[:, c + 1], r[:, c + 2])
        return MaterialTable(
            diffuse=vec(0),
            specular=vec(3),
            emissive=vec(6),
            diffuse_trans=vec(9),
            reflectivity=vec(12),
            roughness=r[:, 15],
            ior=r[:, 16],
            opacity=r[:, 17],
            flags=jnp.round(r[:, 18]).astype(jnp.int32),
            diffuse_map=self.diffuse_map[mat_id],
            specular_map=self.specular_map[mat_id],
            emissive_map=self.emissive_map[mat_id],
            bump_map=self.bump_map[mat_id],
        )

    @staticmethod
    def from_host(mats: "list[HostMaterial]") -> "MaterialTable":
        if not mats:
            mats = [HostMaterial(name="default")]
        f = np.float32
        v3 = lambda key: Vec3(
            jnp.asarray(np.array([getattr(m, key)[0] for m in mats], f)),
            jnp.asarray(np.array([getattr(m, key)[1] for m in mats], f)),
            jnp.asarray(np.array([getattr(m, key)[2] for m in mats], f)),
        )
        s = lambda key, dt=f: jnp.asarray(np.array([getattr(m, key) for m in mats], dt))
        return MaterialTable(
            diffuse=v3("diffuse"),
            specular=v3("specular"),
            emissive=v3("emissive"),
            diffuse_trans=v3("diffuse_trans"),
            reflectivity=v3("reflectivity"),
            roughness=s("roughness"),
            ior=s("ior"),
            opacity=s("opacity"),
            flags=s("flags", np.int32),
            diffuse_map=s("diffuse_map", np.int32),
            specular_map=s("specular_map", np.int32),
            emissive_map=s("emissive_map", np.int32),
            bump_map=s("bump_map", np.int32),
        )


class HostMaterial:
    """Mutable host-side material (loader staging), MeshBase.cpp:370-410 analog."""

    def __init__(self, name: str = ""):
        self.name = name
        self.diffuse = (0.0, 0.0, 0.0)
        self.specular = (0.0, 0.0, 0.0)
        self.emissive = (0.0, 0.0, 0.0)
        self.diffuse_trans = (0.0, 0.0, 0.0)
        self.reflectivity = (0.0, 0.0, 0.0)
        self.phong_exponent = 0.0
        self.ior = 1.0
        self.opacity = 1.0
        self.flags = 0
        self.diffuse_map = -1
        self.specular_map = -1
        self.emissive_map = -1
        self.bump_map = -1
        # texture file names resolved by the scene loader
        self.diffuse_map_name = ""
        self.specular_map_name = ""
        self.emissive_map_name = ""
        self.bump_map_name = ""

    @property
    def roughness(self) -> float:
        # MeshStorage.cpp:163
        return 1.0 / self.phong_exponent if self.phong_exponent else 1.0

    def finalize_flags(self):
        """Set derived flags (renderer.cu:734-744 material flag pass)."""
        if max(self.emissive) > 0.0:
            self.flags |= FLAG_EMISSIVE
        return self
