"""Framebuffer: multi-channel AOVs, progressive blending, online variance,
tonemap.

Reference: src/framebuffer.h (FBufferStorage, 8 fixed float4 channels,
renderer_view.h:133-145 FBufferDesc) + the frame ops in renderer.cu:
multiply/rescale_frame (:403-416), update_variances (:333-362, Welford deltas
stored in the alpha component), to_rgba tonemap (:83-130: exposure,
c/(1+c), gamma).

Design: the framebuffer is an immutable pytree of (H, W, 3) arrays plus
(H, W) variance planes; progressive accumulation is functional
(fb' = fb * n/(n+1) + sample/(n+1)) so a pass is one pure jitted function.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array

# channel ids (FBufferDesc, renderer_view.h:133-145)
DIFFUSE_C = 0
SPECULAR_C = 1
DIRECT_C = 2
COMPOSITED_C = 3
DIFFUSE_A = 4
SPECULAR_A = 5


class Framebuffer(NamedTuple):
    diffuse: Array  # (H, W, 3) irradiance x albedo of diffuse-routed paths
    specular: Array  # (H, W, 3)
    direct: Array  # (H, W, 3) emissive/direct at the first vertex
    composited: Array  # (H, W, 3) everything
    diffuse_albedo: Array  # (H, W, 3) AOV
    specular_albedo: Array  # (H, W, 3) AOV
    var_luminance: Array  # (H, W, 4) online variance of (direct, diffuse, specular, composited)

    @staticmethod
    def create(res_y: int, res_x: int) -> "Framebuffer":
        z3 = jnp.zeros((res_y, res_x, 3), jnp.float32)
        z4 = jnp.zeros((res_y, res_x, 4), jnp.float32)
        return Framebuffer(z3, z3, z3, z3, z3, z3, z4)

    @property
    def res(self):
        return self.composited.shape[0], self.composited.shape[1]

    def scale(self, s) -> "Framebuffer":
        """multiply_frame (renderer.cu:403-410) — scales variances too."""
        return jax.tree_util.tree_map(lambda a: a * s, self)

    def accumulate_pass(
        self,
        instance: Array,
        diffuse: Array,
        specular: Array,
        direct: Array,
        composited: Array,
        diffuse_albedo: Array,
        specular_albedo: Array,
    ) -> "Framebuffer":
        """One progressive pass: old * n/(n+1) + new/(n+1), plus the Welford
        variance delta of update_variances_kernel (renderer.cu:333-362)."""
        n = instance.astype(jnp.float32) + 1.0  # frame count after this pass
        w_old = (n - 1.0) / n
        w_new = 1.0 / n

        new_diffuse = self.diffuse * w_old + diffuse * w_new
        new_specular = self.specular * w_old + specular * w_new
        new_direct = self.direct * w_old + direct * w_new
        new_comp = self.composited * w_old + composited * w_new
        new_da = self.diffuse_albedo * w_old + diffuse_albedo * w_new
        new_sa = self.specular_albedo * w_old + specular_albedo * w_new

        def lum(img):
            return jnp.max(img, axis=-1)

        old_lum = jnp.stack(
            [lum(self.direct), lum(self.diffuse), lum(self.specular), lum(self.composited)],
            axis=-1,
        )
        new_lum = jnp.stack(
            [lum(new_direct), lum(new_diffuse), lum(new_specular), lum(new_comp)],
            axis=-1,
        )
        delta = new_lum - old_lum
        delta_var = (n * delta) * ((n - 1.0) * delta) / (n * n)
        new_var = self.var_luminance * w_old + delta_var

        return Framebuffer(
            new_diffuse, new_specular, new_direct, new_comp, new_da, new_sa, new_var
        )


def tonemap(img: Array, exposure: float = 1.0, gamma: float = 2.2) -> Array:
    """HDR -> display: exposure, Reinhard c/(1+c), gamma (renderer.cu:83-108)."""
    c = jnp.maximum(img * exposure, 0.0)
    c = c / (c + 1.0)
    return jnp.power(c, 1.0 / gamma)


def to_rgba8(img: Array, exposure: float = 1.0, gamma: float = 2.2) -> Array:
    c = tonemap(img, exposure, gamma)
    return jnp.clip(c * 256.0, 0.0, 255.0).astype(jnp.uint8)


def rmse(a: Array, b: Array) -> Array:
    """Image RMSE (main.cu:63-126 diff/ref compare)."""
    d = a.astype(jnp.float32) - b.astype(jnp.float32)
    return jnp.sqrt(jnp.mean(d * d))


class GBuffer(NamedTuple):
    """First-hit geometry buffer (framebuffer.h:49-124 GBufferView analog)."""

    depth: Array  # (H, W)
    tri: Array  # (H, W) int32, -1 = miss
    normal: Array  # (H, W, 3) shading normal
    uv: Array  # (H, W, 2)
    material: Array  # (H, W) int32

    @staticmethod
    def create(res_y: int, res_x: int) -> "GBuffer":
        return GBuffer(
            depth=jnp.full((res_y, res_x), jnp.inf, jnp.float32),
            tri=jnp.full((res_y, res_x), -1, jnp.int32),
            normal=jnp.zeros((res_y, res_x, 3), jnp.float32),
            uv=jnp.zeros((res_y, res_x, 2), jnp.float32),
            material=jnp.full((res_y, res_x), -1, jnp.int32),
        )
