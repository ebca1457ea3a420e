"""Lat-long environment map with luminance importance sampling.

The reference declares environment hits everywhere ("hit the environment -
perform sky lighting", pathtracer_core.h:1251, bpt_kernels.h:905,
renderers/rpt.cu:426) but leaves the bodies empty; its pbrt importer maps
LightSource "infinite" to a constant. This module goes beyond that parity
point: a full textured infinite light with next-event estimation.

Design notes:
- sampling inverts ONE flattened (H*W,) CDF with a single vectorized
  `searchsorted` (binary search, log2(H*W) steps) instead of the classic
  marginal-then-conditional 2D inversion — the 2D form needs a per-lane
  (N, W) row gather which is pure device-memory traffic.
- the per-texel weight is luminance(texel) * sin(theta_row), so the flat
  CDF *is* the correct joint distribution; the solid-angle pdf of the
  procedure (uniform jitter inside the chosen texel) is
      p(omega) = (w / total) * (H * W) / (2 pi^2 sin theta)
  evaluated with sin(theta) at the ACTUAL sampled/queried direction,
  which makes eval-side MIS pdfs exact, not texel-center approximations.
- all lookups are row gathers into flat (H*W,) / (H, W, 3) arrays; the
  bilinear eval does 4 such gathers (same pattern as
  textures.TextureAtlas._level_fetch).

Mapping (standard lat-long):
  u = 0.5 + atan2(x, -z) / (2 pi)      v = acos(y) / pi     (v=0 at +Y)
  dir(u, v) = (sin th sin ph, cos th, -sin th cos ph),
              th = pi v, ph = 2 pi (u - 0.5)
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.core.math import Vec3

Array = jax.Array

_TWO_PI = 2.0 * math.pi
_INV_2PI = 1.0 / _TWO_PI
_INV_PI = 1.0 / math.pi


class EnvMapView(NamedTuple):
    """Device view of a lat-long radiance map + its sampling tables.

    H and W are static (array shapes), so the view nests in jitted
    pytrees (SceneView) with no traced-int hazards.
    """

    img: Array  # (H, W, 3) float32 radiance, row 0 = +Y pole (v=0)
    weight: Array  # (H*W,) luminance * sin(theta_row): sampling weights
    cdf: Array  # (H*W,) inclusive cumsum of weight
    total: Array  # () sum of weight (>0 guaranteed by build)

    @staticmethod
    def build(img: np.ndarray) -> "EnvMapView":
        """img: (H, W, 3) float32 HDR radiance, top row = +Y pole."""
        img = np.ascontiguousarray(np.asarray(img, np.float32))
        assert img.ndim == 3 and img.shape[2] == 3, img.shape
        h = img.shape[0]
        lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
        sin_t = np.sin((np.arange(h, dtype=np.float32) + 0.5) * math.pi / h)
        wt = (lum * sin_t[:, None]).reshape(-1)
        if wt.sum() <= 0.0:  # black map: keep a valid uniform distribution
            wt = np.ones_like(wt)
        return EnvMapView(
            img=jnp.asarray(img),
            weight=jnp.asarray(wt),
            cdf=jnp.cumsum(jnp.asarray(wt)),
            total=jnp.asarray(wt.sum(), jnp.float32),
        )

    def dir_to_uv(self, d: Vec3):
        u = 0.5 + jnp.arctan2(d.x, -d.z) * _INV_2PI
        v = jnp.arccos(jnp.clip(d.y, -1.0, 1.0)) * _INV_PI
        return u, v

    def uv_to_dir(self, u: Array, v: Array) -> Vec3:
        th = v * math.pi
        ph = (u - 0.5) * _TWO_PI
        st = jnp.sin(th)
        return Vec3(st * jnp.sin(ph), jnp.cos(th), -st * jnp.cos(ph))

    def eval(self, d: Vec3) -> Vec3:
        """Bilinear radiance lookup in the direction d (normalized)."""
        h, w, _ = self.img.shape
        tex = self.img.reshape(-1, 3)
        u, v = self.dir_to_uv(d)
        fu = u * w - 0.5
        fv = v * h - 0.5
        x0 = jnp.floor(fu)
        y0 = jnp.floor(fv)
        tx = (fu - x0)[:, None]
        ty = (fv - y0)[:, None]
        x0i = jnp.mod(x0.astype(jnp.int32), w)
        x1i = jnp.mod(x0i + 1, w)
        y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)  # clamp at poles
        y1i = jnp.clip(y0i + 1, 0, h - 1)

        def tap(xi, yi):
            return tex[yi * w + xi]  # (N, 3)

        c = (
            tap(x0i, y0i) * (1 - tx) * (1 - ty)
            + tap(x1i, y0i) * tx * (1 - ty)
            + tap(x0i, y1i) * (1 - tx) * ty
            + tap(x1i, y1i) * tx * ty
        )
        return Vec3(c[:, 0], c[:, 1], c[:, 2])

    def pdf(self, d: Vec3) -> Array:
        """Solid-angle pdf of sample() producing direction d (for MIS)."""
        h, w, _ = self.img.shape
        u, v = self.dir_to_uv(d)
        xi = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
        yi = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
        wt = self.weight[yi * w + xi]
        sin_t = jnp.sqrt(jnp.maximum(1.0 - d.y * d.y, 1e-12))
        return wt / self.total * (h * w) / (2.0 * math.pi * math.pi * sin_t)

    def sample(self, u1: Array, u2: Array):
        """Importance-sample a direction ~ luminance * sin(theta).

        Returns (dir, pdf_solid_angle, radiance) — radiance is the point
        value of the CHOSEN texel (not bilinear) so radiance/pdf stays a
        bounded, consistent estimator across sharp texel boundaries.
        """
        h, w, _ = self.img.shape
        target = u1 * self.total
        idx = jnp.clip(
            jnp.searchsorted(self.cdf, target, side="left"), 0, h * w - 1
        )
        prev = jnp.where(idx > 0, self.cdf[jnp.maximum(idx - 1, 0)], 0.0)
        wt = self.weight[idx]
        # remainder of the inversion is uniform in [0,1): reuse it as the
        # in-texel x jitter (one sequence dim inverts CDF + x together)
        rx = jnp.clip(
            (target - prev) / jnp.maximum(self.cdf[idx] - prev, 1e-20),
            0.0,
            1.0 - 1e-6,
        )
        yi = idx // w
        xi = idx - yi * w
        u = (xi.astype(jnp.float32) + rx) / w
        v = (yi.astype(jnp.float32) + jnp.clip(u2, 0.0, 1.0 - 1e-6)) / h
        d = self.uv_to_dir(u, v)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - d.y * d.y, 1e-12))
        pdf = wt / self.total * (h * w) / (2.0 * math.pi * math.pi * sin_t)
        rad = self.img.reshape(-1, 3)[idx]
        return d, pdf, Vec3(rad[:, 0], rad[:, 1], rad[:, 2])


def scene_env_radiance(view, d: Vec3) -> Vec3:
    """Environment radiance along d for a SceneView: the textured map
    scaled by view.env when present, else the constant view.env.

    Shared by every integrator's escaped-ray pickup (the reference leaves
    all of these as empty "perform sky lighting" stubs — bpt_kernels.h:905,
    renderers/rpt.cu:426, renderers/mlt_core.h:1031)."""
    if getattr(view, "env_map", None) is not None:
        e = view.env_map.eval(d)
        return Vec3(e.x * view.env[0], e.y * view.env[1], e.z * view.env[2])
    shp = jnp.shape(d.x)
    return Vec3(
        jnp.broadcast_to(view.env[0], shp),
        jnp.broadcast_to(view.env[1], shp),
        jnp.broadcast_to(view.env[2], shp),
    )
