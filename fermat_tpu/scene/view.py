"""SceneView — the POD pytree handed to integrator kernels.

Reference analog: RenderingContextView (src/renderer_view.h:80-131), the
plain device view of the whole context passed by value into kernels. Here it
is a pytree: jit-stable, shardable, and differentiable (material fields and
the texture atlas inside it are leaves gradients can flow into).

Texture loading mirrors renderer.cu:784-882: every texture file referenced
by a material is loaded into the packed mip atlas and the material's map
slots become atlas indices.
"""
from __future__ import annotations

import os
import sys
from typing import NamedTuple, Optional

import jax
import numpy as np

from fermat_tpu.accel.bvh import BvhView, build_bvh_for_mesh
from fermat_tpu.core.camera import Camera
from fermat_tpu.scene.envmap import EnvMapView
from fermat_tpu.scene.lights import DirectionalLightsView, MeshLightsView
from fermat_tpu.scene.mesh import MeshStorage, MeshView
from fermat_tpu.scene.textures import TextureAtlas


class ShadowSet(NamedTuple):
    """Pre-filtered occlusion-only geometry for one shadow-ray mask bit
    (the any-hit-ignore set of optix_base_shadow_shaders.h:55-59)."""

    mesh: MeshView
    bvh: BvhView


class SceneView(NamedTuple):
    mesh: MeshView
    bvh: BvhView
    lights: MeshLightsView
    dir_lights: DirectionalLightsView
    camera: Camera
    textures: TextureAtlas
    env: "jax.Array"  # (3,) constant environment radiance (0 = none)
    point_lights: "object"  # PointLightsView (delta lights)
    vpls: "object" = None  # mesh_lights.VPLView (presampled emission-proportional points)
    # masked shadow-ray geometry (optix_base_shadow_shaders.h:55-59): a
    # (direct, indirect) pair of ShadowSet or None when no material carries
    # the FLAG_SHADOW_*_IGNORE bits (the common case — zero overhead)
    shadow_sets: "object" = None
    # textured infinite light (scene.envmap.EnvMapView) or None; when set,
    # `env` acts as an RGB scale on the map's radiance
    env_map: "object" = None
    # analytic (un-tessellated) disk/rect area lights with exact
    # sample/map/pdf forms (lights.h:175-249); None = none
    area_lights: "object" = None

    @property
    def has_textures(self) -> bool:
        """Static: whether any real texture was loaded (checked at trace time)."""
        return self.textures.texels.shape[0] > 1

    @staticmethod
    def build(
        storage: MeshStorage,
        camera: Camera,
        dir_light_defs=(),
        leaf_size: int = 4,
        texture_dir: Optional[str] = None,
        env_radiance=(0.0, 0.0, 0.0),
        point_light_defs=(),
        n_vpls: int = 256,
        env_map=None,
        area_light_defs=(),
    ) -> "SceneView":
        # resolve texture files referenced by materials (renderer.cu:784-882)
        images = []
        index = {}

        def tex_index(name: str) -> int:
            if not name:
                return -1
            if name in index:
                return index[name]
            candidates = [name]
            if texture_dir:
                candidates.insert(0, os.path.join(texture_dir, name))
                # prefer TGA siblings (the reference ships .tga for every .png)
                base, _ = os.path.splitext(name)
                candidates.insert(0, os.path.join(texture_dir, base + ".tga"))
            for c in candidates:
                if os.path.exists(c):
                    from fermat_tpu.utils.image import read_image

                    try:
                        images.append(read_image(c))
                        index[name] = len(images) - 1
                        return index[name]
                    except Exception as e:  # noqa: BLE001
                        print(f"[textures] failed {c}: {e}", file=sys.stderr)
            print(f"[textures] missing texture {name}", file=sys.stderr)
            index[name] = -1
            return -1

        for m in storage.materials:
            m.diffuse_map = tex_index(m.diffuse_map_name)
            m.specular_map = tex_index(m.specular_map_name)
            m.emissive_map = tex_index(m.emissive_map_name)
            m.bump_map = tex_index(m.bump_map_name)

        mesh = storage.device_view()
        bvh = build_bvh_for_mesh(mesh, leaf_size=leaf_size)
        # texture-integrated emissive CDF weights + VPL presampling
        # (mesh_lights.cu:158-380); weights default to lum x area when no
        # emitter has a texture
        from fermat_tpu.scene.mesh_lights import (
            build_vpls,
            textured_tri_energies,
        )

        energies = textured_tri_energies(mesh, images)
        lights = MeshLightsView.build(mesh, weights=energies)
        vpls = build_vpls(mesh, n_vpls=n_vpls, tri_energy=energies,
                          images=images) if n_vpls > 0 else None
        dl = DirectionalLightsView.build(list(dir_light_defs))
        atlas = TextureAtlas.build(images)
        import jax.numpy as jnp

        from fermat_tpu.scene.analytic_lights import (
            AreaLightsView,
            PointLightsView,
        )

        # masked shadow geometry: one pre-filtered set per shadow-ray mask
        # bit actually used by the scene's materials
        import numpy as np

        from fermat_tpu.scene.materials import (
            FLAG_SHADOW_DIRECT_IGNORE,
            FLAG_SHADOW_INDIRECT_IGNORE,
        )

        tri_flags = np.asarray(
            [m.flags for m in storage.materials], np.int32
        )[np.asarray(storage.material_ids)] if storage.n_triangles else np.zeros(0, np.int32)

        def shadow_set(bit):
            drop = (tri_flags & bit) != 0
            if not drop.any():
                return None
            sub = storage.filtered(~drop)
            smesh = sub.device_view()
            return ShadowSet(
                mesh=smesh,
                bvh=build_bvh_for_mesh(smesh, leaf_size=leaf_size),
            )

        sd = shadow_set(FLAG_SHADOW_DIRECT_IGNORE)
        si = shadow_set(FLAG_SHADOW_INDIRECT_IGNORE)
        shadow_sets = (sd, si) if (sd is not None or si is not None) else None

        # with a textured env map, `env` becomes an RGB scale on the map's
        # radiance — a zero default would black it out, so promote to 1
        if env_map is not None and tuple(env_radiance) == (0.0, 0.0, 0.0):
            env_radiance = (1.0, 1.0, 1.0)
        return SceneView(
            mesh=mesh, bvh=bvh, lights=lights, dir_lights=dl, camera=camera,
            textures=atlas, env=jnp.asarray(env_radiance, jnp.float32),
            point_lights=PointLightsView.build(list(point_light_defs)),
            vpls=vpls, shadow_sets=shadow_sets,
            env_map=(EnvMapView.build(env_map) if env_map is not None
                     else None),
            area_lights=(AreaLightsView.build(list(area_light_defs))
                         if area_light_defs else None),
        )
