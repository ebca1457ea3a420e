"""GGX-Smith microfacet model: NDF, Smith masking, VNDF sampling,
reflection + transmission eval/pdf.

Reference analog: cugar/bsdf/ggx_smith.h:204 (GGXSmithBsdf sample/eval/invert)
and cugar/bsdf/ggx_common.h. This build samples the *visible* NDF
(Heitz 2018 spherical-cap method) rather than the plain NDF — strictly lower
variance at identical cost, and trivially vectorized.

All directions are in the local shading frame (+z = shading normal);
everything operates on flat (N,) lanes.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.core.math import Vec3, dot, normalize

Array = jax.Array

PI = 3.141592653589793
INV_PI = 0.3183098861837907
_MIN_ALPHA = 1e-4


def _alpha(roughness):
    return jnp.maximum(roughness * roughness, _MIN_ALPHA)


def ndf_d(alpha, nh) -> Array:
    """GGX NDF D(h)."""
    nh = jnp.maximum(nh, 0.0)
    a2 = alpha * alpha
    d = nh * nh * (a2 - 1.0) + 1.0
    return a2 / jnp.maximum(PI * d * d, 1e-20)


def _lambda(alpha, cos_t) -> Array:
    """Smith Lambda for GGX."""
    c = jnp.clip(jnp.abs(cos_t), 1e-6, 1.0)
    s2 = jnp.maximum(1.0 - c * c, 0.0)
    a2 = alpha * alpha
    return 0.5 * (jnp.sqrt(1.0 + a2 * s2 / (c * c)) - 1.0)


def smith_g1(alpha, cos_t) -> Array:
    return 1.0 / (1.0 + _lambda(alpha, cos_t))


def smith_g2(alpha, cos_i, cos_o) -> Array:
    """Height-correlated Smith masking-shadowing."""
    return 1.0 / (1.0 + _lambda(alpha, cos_i) + _lambda(alpha, cos_o))


def sample_vndf(alpha, wi: Vec3, u0, u1) -> Vec3:
    """Sample the GGX visible NDF (Heitz 2018) — returns the half vector.

    wi must be in the upper hemisphere of the local frame (z > 0).
    """
    # stretch view
    v = normalize(Vec3(alpha * wi.x, alpha * wi.y, wi.z))
    # orthonormal basis around v
    lensq = v.x * v.x + v.y * v.y
    inv = jax.lax.rsqrt(jnp.maximum(lensq, 1e-20))
    t1 = Vec3(
        jnp.where(lensq > 1e-12, -v.y * inv, 1.0),
        jnp.where(lensq > 1e-12, v.x * inv, 0.0),
        jnp.zeros_like(v.z),
    )
    t2 = Vec3(
        v.y * t1.z - v.z * t1.y,
        v.z * t1.x - v.x * t1.z,
        v.x * t1.y - v.y * t1.x,
    )
    # parameterize the projected area (spherical cap)
    r = jnp.sqrt(u0)
    phi = 2.0 * PI * u1
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + v.z)
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = jnp.sqrt(jnp.maximum(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = t1 * p1 + t2 * p2 + v * p3
    # unstretch
    h = normalize(Vec3(alpha * nh.x, alpha * nh.y, jnp.maximum(nh.z, 1e-6)))
    return h


def vndf_pdf(alpha, wi: Vec3, h: Vec3) -> Array:
    """pdf of sample_vndf in the half-vector measure."""
    ci = jnp.abs(wi.z)
    g1 = smith_g1(alpha, wi.z)
    d = ndf_d(alpha, jnp.abs(h.z))
    return g1 * jnp.maximum(dot(wi, h), 0.0) * d / jnp.maximum(ci, 1e-8)


# ---------------------------------------------------------------------------
# Reflection lobe
# ---------------------------------------------------------------------------

def reflect_eval(alpha, wi: Vec3, wo: Vec3) -> Array:
    """Scalar GGX-Smith reflection BRDF (Fresnel applied by the caller)."""
    ci = wi.z
    co = wo.z
    same = (ci * co) > 0.0
    h = normalize(wi + wo)
    h = Vec3(h.x, h.y, h.z) * jnp.where(h.z < 0, -1.0, 1.0)
    d = ndf_d(alpha, h.z)
    g = smith_g2(alpha, ci, co)
    f = d * g / jnp.maximum(4.0 * jnp.abs(ci) * jnp.abs(co), 1e-12)
    return jnp.where(same, f, 0.0)


def reflect_pdf(alpha, wi: Vec3, wo: Vec3) -> Array:
    """Solid-angle pdf of VNDF reflection sampling."""
    same = (wi.z * wo.z) > 0.0
    flip = jnp.where(wi.z < 0, -1.0, 1.0)
    wiu = Vec3(wi.x * flip, wi.y * flip, wi.z * flip)
    wou = Vec3(wo.x * flip, wo.y * flip, wo.z * flip)
    h = normalize(wiu + wou)
    ph = vndf_pdf(alpha, wiu, h)
    p = ph / jnp.maximum(4.0 * jnp.abs(dot(wiu, h)), 1e-12)
    return jnp.where(same, p, 0.0)


def reflect_sample(alpha, wi: Vec3, u0, u1) -> Tuple[Vec3, Array]:
    """Sample wo by VNDF; returns (wo, pdf). Handles wi in either hemisphere."""
    flip = jnp.where(wi.z < 0, -1.0, 1.0)
    wiu = Vec3(wi.x * flip, wi.y * flip, wi.z * flip)
    h = sample_vndf(alpha, wiu, u0, u1)
    wou = h * (2.0 * dot(wiu, h)) - wiu
    pdf = vndf_pdf(alpha, wiu, h) / jnp.maximum(4.0 * jnp.abs(dot(wiu, h)), 1e-12)
    wo = Vec3(wou.x * flip, wou.y * flip, wou.z * flip)
    # samples below the surface get pdf 0 (killed by caller)
    ok = wou.z > 1e-6
    return wo, jnp.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# Transmission lobe (Walter 2007 microfacet refraction)
# ---------------------------------------------------------------------------

def refract_eval(alpha, ior, wi: Vec3, wo: Vec3) -> Array:
    """Scalar GGX-Smith BTDF (Fresnel transmittance applied by caller).

    ior: eta_t/eta_i for wi.z > 0 side (the material's IoR).
    Radiance (non-adjoint) transport; the 1/eta^2 radiance-compression factor
    is intentionally omitted (matched at the integrator level like the
    reference's TransportType handling).
    """
    ci = wi.z
    co = wo.z
    opposite = (ci * co) < 0.0
    eta = jnp.where(ci > 0, ior, 1.0 / ior)  # eta_t / eta_i
    # half vector for refraction
    hx = wi.x + wo.x * eta
    hy = wi.y + wo.y * eta
    hz = wi.z + wo.z * eta
    h = normalize(Vec3(hx, hy, hz))
    h = h * jnp.where(h.z < 0, -1.0, 1.0)
    ih = dot(wi, h)
    oh = dot(wo, h)
    d = ndf_d(alpha, h.z)
    g = smith_g2(alpha, ci, co)
    denom = ih + eta * oh
    jac = eta * eta * jnp.abs(oh) / jnp.maximum(denom * denom, 1e-12)
    f = (
        jnp.abs(ih)
        * jac
        * d
        * g
        / jnp.maximum(jnp.abs(ci) * jnp.abs(co), 1e-12)
    )
    return jnp.where(opposite, f, 0.0)


def refract_pdf(alpha, ior, wi: Vec3, wo: Vec3) -> Array:
    ci = wi.z
    co = wo.z
    opposite = (ci * co) < 0.0
    eta = jnp.where(ci > 0, ior, 1.0 / ior)
    h = normalize(Vec3(wi.x + wo.x * eta, wi.y + wo.y * eta, wi.z + wo.z * eta))
    h = h * jnp.where(h.z < 0, -1.0, 1.0)
    flip = jnp.where(ci < 0, -1.0, 1.0)
    wiu = Vec3(wi.x * flip, wi.y * flip, wi.z * flip)
    hu = Vec3(h.x * flip, h.y * flip, h.z * flip)
    hu = hu * jnp.where(hu.z < 0, -1.0, 1.0)
    ph = vndf_pdf(alpha, wiu, hu)
    oh = dot(wo, h)
    ih = dot(wi, h)
    denom = ih + eta * oh
    jac = eta * eta * jnp.abs(oh) / jnp.maximum(denom * denom, 1e-12)
    return jnp.where(opposite, ph * jac, 0.0)


def refract_sample(alpha, ior, wi: Vec3, u0, u1) -> Tuple[Vec3, Array]:
    """Sample refraction through a sampled VNDF half vector.

    Returns (wo, pdf); pdf 0 on total internal reflection.
    """
    flip = jnp.where(wi.z < 0, -1.0, 1.0)
    wiu = Vec3(wi.x * flip, wi.y * flip, wi.z * flip)
    h = sample_vndf(alpha, wiu, u0, u1)
    eta_rel = jnp.where(wi.z > 0, 1.0 / ior, ior)  # eta_i / eta_t
    ih = dot(wiu, h)
    sin2_t = eta_rel * eta_rel * jnp.maximum(0.0, 1.0 - ih * ih)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    wou = (h * ih - wiu) * eta_rel - h * cos_t
    wou = normalize(wou)
    wo = Vec3(wou.x * flip, wou.y * flip, wou.z * flip)
    p = refract_pdf(alpha, ior, wi, wo)
    return wo, jnp.where(tir, 0.0, p)


# ---------------------------------------------------------------------------
# Directional albedo table (glossy_reflectance analog).
# The reference loads a precomputed table at init (renderer.cu:641-683) for
# the Kelemen-coupling diffuse weight; we integrate it once at import with
# numpy quadrature (F = 1).
# ---------------------------------------------------------------------------

_ALBEDO_RES = 32


def _build_albedo_table(res: int = _ALBEDO_RES) -> np.ndarray:
    """E[roughness, cos_theta] = directional-hemispherical reflectance of
    GGX-Smith with F=1, by GL quadrature."""
    from numpy.polynomial.legendre import leggauss

    nq = 32
    xs, ws = leggauss(nq)  # over [-1, 1]
    mu = 0.5 * (xs + 1.0)  # cos_theta_o in (0,1)
    wmu = 0.5 * ws
    phi = (np.arange(nq) + 0.5) / nq * 2.0 * np.pi
    wphi = 2.0 * np.pi / nq

    table = np.zeros((res, res), np.float64)
    r_grid = (np.arange(res) + 0.5) / res
    c_grid = (np.arange(res) + 0.5) / res
    for ri, rough in enumerate(r_grid):
        a = max(rough * rough, _MIN_ALPHA)
        for ci_, cv in enumerate(c_grid):
            si = np.sqrt(max(1.0 - cv * cv, 0.0))
            wi = np.array([si, 0.0, cv])
            # integrate over outgoing hemisphere
            co = mu[:, None]
            so = np.sqrt(np.maximum(1.0 - co**2, 0.0))
            lx = so * np.cos(phi)[None, :]
            ly = so * np.sin(phi)[None, :]
            lz = np.broadcast_to(co, lx.shape)
            hx = lx + wi[0]
            hy = ly + wi[1]
            hz = lz + wi[2]
            hl = np.sqrt(hx**2 + hy**2 + hz**2)
            hz_n = hz / np.maximum(hl, 1e-12)
            a2 = a * a
            dd = hz_n**2 * (a2 - 1.0) + 1.0
            D = a2 / np.maximum(np.pi * dd**2, 1e-20)

            def lam(c):
                c = np.clip(np.abs(c), 1e-6, 1.0)
                s2 = np.maximum(1.0 - c * c, 0.0)
                return 0.5 * (np.sqrt(1.0 + a2 * s2 / (c * c)) - 1.0)

            G = 1.0 / (1.0 + lam(cv) + lam(lz))
            f = D * G / np.maximum(4.0 * cv * lz, 1e-12)
            integrand = f * lz
            table[ri, ci_] = np.sum(integrand * wmu[:, None] * wphi)
    return np.clip(table, 0.0, 1.0).astype(np.float32)


_ALBEDO_TABLE_NP = None


def glossy_reflectance(roughness: Array, cos_theta: Array) -> Array:
    """Bilinear lookup of the F=1 GGX directional albedo (Kelemen coupling).

    GATHER-FREE: the bilinear interpolation weights are placed directly
    into sparse row/column weight matrices and the lookup becomes one
    (N, 32) @ (32, 32) matmul + a lane reduction — numerically identical
    to the 4-corner gather formulation. It was chosen for hardware with
    slow 2D gathers; whether the gather form is faster on the GPU is open
    (ROADMAP 1.6).

    The table is cached as a HOST numpy array and converted per call: jnp
    constants created inside a jit trace would leak tracers across traces;
    jnp.asarray of a host constant is folded by XLA.
    """
    global _ALBEDO_TABLE_NP
    if _ALBEDO_TABLE_NP is None:
        _ALBEDO_TABLE_NP = _build_albedo_table()
    res = _ALBEDO_RES
    t = jnp.asarray(_ALBEDO_TABLE_NP)
    r = jnp.clip(roughness, 0.0, 1.0) * res - 0.5
    c = jnp.clip(jnp.abs(cos_theta), 0.0, 1.0) * res - 0.5
    r0 = jnp.clip(jnp.floor(r), 0, res - 1).astype(jnp.int32)
    c0 = jnp.clip(jnp.floor(c), 0, res - 1).astype(jnp.int32)
    r1 = jnp.minimum(r0 + 1, res - 1)
    c1 = jnp.minimum(c0 + 1, res - 1)
    fr = jnp.clip(r - r0, 0.0, 1.0)
    fc = jnp.clip(c - c0, 0.0, 1.0)
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, res), 1)
    w_r = (
        (iota == r0[:, None]) * (1.0 - fr)[:, None]
        + (iota == r1[:, None]) * fr[:, None]
    )
    w_c = (
        (iota == c0[:, None]) * (1.0 - fc)[:, None]
        + (iota == c1[:, None]) * fc[:, None]
    )
    rows = jnp.dot(w_r, t, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)  # (N, res)
    return jnp.sum(rows * w_c, axis=1)
