"""LTC (linearly transformed cosine) glossy lobe.

Reference analog: cugar/bsdf/ltc.h (LTCBsdf — eval/sample/pdf through the
tabulated M / M^-1 matrices) + the `ltc_ggx` table loaded at renderer init
(renderer.cu:669-679). The table here (ltc_ggx.npz) is fit from scratch
against this framework's own GGX-Smith by tools/fit_ltc.py — method per
Heitz et al. 2016, data original.

The LTC density is an exactly normalized, analytically sampleable proxy of
the cosine-weighted GGX slice:
    D(w) = cos(M^-1 w)/pi * |det M^-1| / ||M^-1 w||^3
so pdf == D and eval = D * magnitude(roughness, cos_i) / cos_o.

Shape: the (32, 32, 4) parameter table is fetched with the same
gather-free one-hot bilinear matmul as the albedo table (ggx.py
glossy_reflectance; ROADMAP 1.6).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.core.math import Vec3

Array = jax.Array

_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ltc_ggx.npz")
_CACHE = {}


def _tables():
    if "t" not in _CACHE:
        data = np.load(_NPZ)
        _CACHE["t"] = (
            np.asarray(data["table"], np.float32),  # (R, R, 4)
            np.asarray(data["magnitude"], np.float32),  # (R, R)
            int(data["res"]),
        )
    return _CACHE["t"]


def _fetch_params(roughness: Array, cos_t: Array):
    """Bilinear (m00, m11, m02, m20, magnitude) at (roughness, |cos|)."""
    tab, mag, res = _tables()
    r = jnp.clip(roughness, 0.0, 1.0) * res - 0.5
    c = jnp.clip(jnp.abs(cos_t), 0.0, 1.0) * res - 0.5
    r0 = jnp.clip(jnp.floor(r), 0, res - 1).astype(jnp.int32)
    c0 = jnp.clip(jnp.floor(c), 0, res - 1).astype(jnp.int32)
    r1 = jnp.minimum(r0 + 1, res - 1)
    c1 = jnp.minimum(c0 + 1, res - 1)
    fr = jnp.clip(r - r0, 0.0, 1.0)
    fc = jnp.clip(c - c0, 0.0, 1.0)
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, res), 1)
    w_r = ((iota == r0[:, None]) * (1.0 - fr)[:, None]
           + (iota == r1[:, None]) * fr[:, None])  # (N, R)
    w_c = ((iota == c0[:, None]) * (1.0 - fc)[:, None]
           + (iota == c1[:, None]) * fc[:, None])
    planes = jnp.asarray(np.concatenate([tab, mag[..., None]], -1))  # (R,R,5)
    outs = []
    for k in range(5):
        rows = jnp.dot(w_r, planes[:, :, k], preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
        outs.append(jnp.sum(rows * w_c, axis=1))
    return outs  # m00, m11, m02, m20, magnitude


def _minv_apply(m00, m11, m02, m20, w: Vec3):
    """M^-1 w for M = [[m00,0,m02],[0,m11,0],[m20,0,1]] (closed form)."""
    det = m00 - m02 * m20  # det of the (x,z) 2x2 block
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    x = (w.x - m02 * w.z) * inv_det
    y = w.y / jnp.maximum(m11, 1e-12)
    z = (-m20 * w.x + m00 * w.z) * inv_det
    return Vec3(x, y, z), jnp.abs(inv_det) / jnp.maximum(m11, 1e-12)


def ltc_density(roughness: Array, wi: Vec3, wo: Vec3) -> Array:
    """The normalized LTC density (== solid-angle pdf) of wo about wi."""
    m00, m11, m02, m20, _ = _fetch_params(roughness, wi.z)
    lo, det_inv = _minv_apply(m00, m11, m02, m20, wo)
    ln2 = lo.x * lo.x + lo.y * lo.y + lo.z * lo.z
    ln = jnp.sqrt(jnp.maximum(ln2, 1e-24))
    cosl = jnp.maximum(lo.z / ln, 0.0)
    return (cosl / jnp.pi) * det_inv / jnp.maximum(ln2 * ln, 1e-24)


def ltc_eval(roughness: Array, wi: Vec3, wo: Vec3):
    """(f, pdf): the LTC proxy of GGX-Smith reflection f and its pdf.

    f = D * magnitude / cos_o (LTCBsdf::f; magnitude is the fitted
    directional albedo so energy matches GGX).
    """
    _, _, _, _, mag = _fetch_params(roughness, wi.z)
    d = ltc_density(roughness, wi, wo)
    same = (wi.z * wo.z) > 0.0
    cos_o = jnp.maximum(jnp.abs(wo.z), 1e-8)
    f = jnp.where(same, d * mag / cos_o, 0.0)
    return f, jnp.where(same, d, 0.0)


def ltc_sample(roughness: Array, wi: Vec3, u0: Array, u1: Array):
    """Sample wo ~ D: cosine sample the canonical lobe, transform by M.

    Returns (wo, pdf)."""
    m00, m11, m02, m20, _ = _fetch_params(roughness, wi.z)
    # cosine hemisphere
    r = jnp.sqrt(jnp.maximum(u0, 0.0))
    phi = 2.0 * jnp.pi * u1
    lx = r * jnp.cos(phi)
    ly = r * jnp.sin(phi)
    lz = jnp.sqrt(jnp.maximum(1.0 - u0, 0.0))
    # w = M l
    wx = m00 * lx + m02 * lz
    wy = m11 * ly
    wz = m20 * lx + lz
    n = jnp.sqrt(jnp.maximum(wx * wx + wy * wy + wz * wz, 1e-24))
    side = jnp.where(wi.z >= 0.0, 1.0, -1.0)
    wo = Vec3(wx / n, wy / n, side * wz / n)
    return wo, ltc_density(roughness, wi, wo)
