"""Composite layered BSDF: Lambert refl/trans + GGX-Smith refl/trans with
Fresnel-weighted layering and Kelemen-coupled energy conservation.

Reference: src/bsdf.h:123-1280 (`Bsdf`). Component structure mirrors
bsdf.h:127-155:
  0 diffuse reflection    rho_d / pi         weight t_coeff * opacity * k
  1 diffuse transmission  rho_dt / pi        weight t_coeff * opacity * k
  2 glossy reflection     GGX-Smith          weight r_coeff (Schlick, F0 = specular/pi)
  3 glossy transmission   GGX-Smith refract  weight t_coeff * (1 - opacity)
where r_coeff = fresnel_schlick(VoH, F0) (bsdf.h:632-667),
t_coeff = 1 - max_comp(r_coeff), and k is the Kelemen-Szirmay-Kalos coupling
(1 - E_g(NoV)) * (1 - E_g(NoL)) (bsdf.h:722-744). The reference looks E_g up
in a precomputed 4D (eta, F0, roughness, cos) table loaded at init
(renderer.cu:641-683); here E_g = max_comp(schlick(cos, F0)) * E_{F=1}(
roughness, cos) with the F=1 albedo table integrated at import (ggx.py).

The clearcoat layer (component 4, bsdf.h:102-135) is the perfectly-specular
coat whose IOR derives from `reflectivity`; see `clearcoat_fresnel` and the
`clearcoat` flag on f_and_pdf/f_split/sample (compiled out when the scene
has no coated material). The glossy reflection lobe can optionally run as
an LTC proxy (`glossy="ltc"`, bsdf/ltc.py) mirroring the reference's
USE_LTC switch (bsdf.h:89).

Sampling is one-sample MIS over the four lobes: pick a lobe by its
luminance-weighted selection probability, sample it, and return the FULL
composite f and the mixture pdf (sum of per-lobe pdfs times selection
probabilities) — exactly the estimator structure of Bsdf::sample
(bsdf.h:830-1000), with g = f / p_proj.

All quantities are flat (N,) lanes in the local shading frame.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from fermat_tpu.bsdf import ggx
from fermat_tpu.bsdf.fresnel import schlick
from fermat_tpu.core.math import Vec3, dot, normalize
from fermat_tpu.core.sampling import INV_PI, square_to_cosine_hemisphere

Array = jax.Array

# component indices (bsdf.h:129-135; clearcoat is the 5th layer)
DIFFUSE_REFL = 0
DIFFUSE_TRANS = 1
GLOSSY_REFL = 2
GLOSSY_TRANS = 3
CLEARCOAT_REFL = 4

# finite stand-in for the delta clearcoat's infinite pdf (the reference
# stores float_infinity, bsdf.h:1118); kept finite so MIS ratio forms stay
# NaN-free — any NEE-vs-delta power weight evaluates to ~1 as it should
_DELTA_PDF = 1.0e30


class BsdfParams(NamedTuple):
    """Per-lane material parameters (post texture modulation)."""

    diffuse: Vec3
    diffuse_trans: Vec3
    specular: Vec3  # raw material specular; F0 = specular / pi (bsdf.h:234)
    roughness: Array
    ior: Array
    opacity: Array
    reflectivity: Vec3 = None  # clearcoat normal-incidence reflectivity

    @staticmethod
    def from_materials(m) -> "BsdfParams":
        """From a gathered MaterialTable row-set (fermat_tpu.scene.materials)."""
        return BsdfParams(
            diffuse=m.diffuse,
            diffuse_trans=m.diffuse_trans,
            specular=m.specular,
            roughness=m.roughness,
            ior=m.ior,
            opacity=m.opacity,
            reflectivity=m.reflectivity,
        )

    @property
    def f0(self) -> Vec3:
        return Vec3(
            self.specular.x * INV_PI,
            self.specular.y * INV_PI,
            self.specular.z * INV_PI,
        )


def _max_comp(v: Vec3) -> Array:
    return jnp.maximum(jnp.maximum(v.x, v.y), v.z)


def _e_glossy(p: BsdfParams, cos_t: Array, e_fn=None) -> Array:
    """Fresnel-scaled glossy directional albedo (table analog, see module doc).

    The Fresnel factor uses the hemispherical-average Schlick reflectance
    F_avg = F0 + (1 - F0)/21, so F0 = 0 yields exactly 0 (pure diffuse stays
    lossless) — the reference's 4D table encodes the same limit at its
    base_spec = 0 slice.
    """
    e1 = (e_fn or ggx.glossy_reflectance)(p.roughness, cos_t)
    f0m = _max_comp(p.f0)
    favg = f0m + (1.0 - f0m) / 21.0
    favg = jnp.where(f0m <= 0.0, 0.0, favg)
    e = jnp.clip(e1 * favg, 0.0, 1.0)
    return jnp.where(p.ior == 0.0, 0.0, e)


def clearcoat_fresnel(p: BsdfParams, wi: Vec3) -> Vec3:
    """Fresnel reflection of the perfectly-specular clearcoat layer
    (bsdf.h:1202-1232): the coat's IOR derives from the material's
    normal-incidence `reflectivity` as ior = (1+sqrt(R0))/(1-sqrt(R0)); the
    exact dielectric Fresnel then interpolates the per-channel reflectivity
    toward white at grazing angles. reflectivity == 0 -> exactly 0 (no
    coat)."""
    r0 = jnp.minimum(_max_comp(p.reflectivity), 0.95)
    sq = jnp.sqrt(jnp.maximum(r0, 0.0))
    ior_c = (1.0 + sq) / jnp.maximum(1.0 - sq, 1e-6)
    ci = jnp.abs(wi.z)
    # entering a denser medium: no TIR; exact dielectric Fresnel
    eta = 1.0 / ior_c
    s2t = eta * eta * jnp.maximum(1.0 - ci * ci, 0.0)
    ct = jnp.sqrt(jnp.maximum(1.0 - s2t, 0.0))
    rs = (ci - ior_c * ct) / jnp.maximum(ci + ior_c * ct, 1e-8)
    rp = (ior_c * ci - ct) / jnp.maximum(ior_c * ci + ct, 1e-8)
    f_s = 0.5 * (rs * rs + rp * rp)
    w = jnp.clip((f_s - r0) / jnp.maximum(1.0 - r0, 1e-6), 0.0, 1.0)
    lerp = lambda a: a + (1.0 - a) * w
    off = _max_comp(p.reflectivity) <= 0.0
    return Vec3(
        jnp.where(off, 0.0, lerp(p.reflectivity.x)),
        jnp.where(off, 0.0, lerp(p.reflectivity.y)),
        jnp.where(off, 0.0, lerp(p.reflectivity.z)),
    )


def scene_clearcoat(materials_host) -> bool:
    """Static: whether any material carries a clearcoat (reflectivity > 0);
    scenes without one compile the 4-lobe model unchanged."""
    return any(max(m.reflectivity) > 0 for m in materials_host)


def component_weights(
    p: BsdfParams, wi: Vec3, wo: Vec3, e_fn=None
) -> Tuple[Vec3, Array, Array, Array]:
    """(glossy_refl r_coeff Vec3, diffuse_w, diffuse_trans_w, glossy_trans_w).

    Mirrors inner_component_weights (bsdf.h:722-744): VoH Schlick for the
    glossy layer, Kelemen coupling for the diffuse floor.
    """
    # half vector (reflection); falls back to N at grazing/transmission
    h = normalize(wi + wo)
    voh = jnp.abs(dot(wi, h))
    # degenerate (wi == -wo) -> use NoV
    voh = jnp.where(jnp.isfinite(voh), voh, jnp.abs(wi.z))
    r_coeff = schlick(voh, p.f0)
    suppressed = p.ior == 0.0  # ior==0 signals glossy suppression (bsdf.h:638)
    r_coeff = Vec3(
        jnp.where(suppressed, 0.0, r_coeff.x),
        jnp.where(suppressed, 0.0, r_coeff.y),
        jnp.where(suppressed, 0.0, r_coeff.z),
    )
    t = 1.0 - _max_comp(r_coeff)
    k = (1.0 - _e_glossy(p, jnp.abs(wi.z), e_fn)) * (
        1.0 - _e_glossy(p, jnp.abs(wo.z), e_fn))
    diffuse_w = t * p.opacity * k
    diffuse_trans_w = t * p.opacity * k
    glossy_trans_w = t * (1.0 - p.opacity)
    return r_coeff, diffuse_w, diffuse_trans_w, glossy_trans_w


ALL_LOBES = (True, True, True, True)  # (dr, dt, gr, gt)


def scene_lobes(materials_host) -> tuple:
    """Static lobe mask from host material inspection: scenes without
    transmissive materials skip the (expensive) transmission lobes entirely
    — the analog of the reference's DIFFUSE_ONLY/SUPPRESS_* compile-time
    switches (bsdf.h:648-663), derived automatically per scene."""
    has_dt = any(max(m.diffuse_trans) > 0 for m in materials_host)
    has_gt = any(m.opacity < 1.0 for m in materials_host)
    return (True, has_dt, True, has_gt)


def f(p: BsdfParams, wi: Vec3, wo: Vec3, lobes=ALL_LOBES) -> Vec3:
    """Full composite BSDF value (bsdf.h:312-334)."""
    val, _ = f_and_pdf(p, wi, wo, lobes)
    return val


def pdf(p: BsdfParams, wi: Vec3, wo: Vec3, lobes=ALL_LOBES) -> Array:
    """Mixture solid-angle pdf matching `sample` (bsdf.h:415-460)."""
    _, pd = f_and_pdf(p, wi, wo, lobes)
    return pd


def _selection_probs(p: BsdfParams, wi: Vec3, lobes=ALL_LOBES,
                     clearcoat: bool = False, e_fn=None):
    """Lobe selection probabilities from view-dependent weight luminances.

    With the clearcoat layer, the coat reflection takes probability
    mean(Fc) and the inner lobes share the remaining 1 - mean(Fc)
    (bsdf.h:999-1001 coat_reflection_prob)."""
    nov = jnp.abs(wi.z)
    r_lum = _max_comp(schlick(nov, p.f0))
    r_lum = jnp.where(p.ior == 0.0, 0.0, r_lum)
    t = 1.0 - r_lum
    k = 1.0 - _e_glossy(p, nov, e_fn)
    zero = jnp.zeros_like(nov)
    w_dr = t * p.opacity * k * _max_comp(p.diffuse) if lobes[0] else zero
    w_dt = t * p.opacity * k * _max_comp(p.diffuse_trans) if lobes[1] else zero
    w_gr = r_lum if lobes[2] else zero
    w_gt = t * (1.0 - p.opacity) if lobes[3] else zero
    total = w_dr + w_dt + w_gr + w_gt
    inv = 1.0 / jnp.maximum(total, 1e-12)
    dead = total <= 1e-12
    # dead lanes fall back to diffuse so probs stay normalized
    p_dr = jnp.where(dead, 1.0, w_dr * inv)
    p_dt = jnp.where(dead, 0.0, w_dt * inv)
    p_gr = jnp.where(dead, 0.0, w_gr * inv)
    p_gt = jnp.where(dead, 0.0, w_gt * inv)
    if clearcoat:
        fc = clearcoat_fresnel(p, wi)
        p_cc = (fc.x + fc.y + fc.z) / 3.0
        s = 1.0 - p_cc
        return p_dr * s, p_dt * s, p_gr * s, p_gt * s, p_cc
    return p_dr, p_dt, p_gr, p_gt, zero


def _glossy_refl_eval(p: BsdfParams, alpha, wi, wo, glossy: str):
    """Glossy reflection (f, pdf) — GGX-Smith or the LTC proxy (the
    reference's USE_LTC switch, bsdf.h:89,159-231)."""
    if glossy == "ltc":
        from fermat_tpu.bsdf.ltc import ltc_eval

        return ltc_eval(p.roughness, wi, wo)
    return ggx.reflect_eval(alpha, wi, wo), ggx.reflect_pdf(alpha, wi, wo)


def f_and_pdf(
    p: BsdfParams, wi: Vec3, wo: Vec3, lobes=ALL_LOBES, clearcoat: bool = False,
    glossy: str = "ggx", e_fn=None
) -> Tuple[Vec3, Array]:
    """Composite f and the mixture pdf of `sample` (bsdf.h:336-413).

    With `clearcoat`, inner-layer f is attenuated by the coat transmission
    Tc(w_i) and the mixture pdf by the inner selection mass (the delta coat
    reflection contributes no density at a.e. directions; second-interface
    refraction deliberately ignored, bsdf.h:780-784)."""
    alpha = ggx._alpha(p.roughness)
    r_coeff, w_d, w_dt, w_gt = component_weights(p, wi, wo, e_fn)
    same = (wi.z * wo.z) > 0.0
    abs_co = jnp.abs(wo.z)
    zero = jnp.zeros_like(abs_co)

    f_dr = jnp.where(same, INV_PI, 0.0) * w_d if lobes[0] else zero
    f_dt = jnp.where(~same, INV_PI, 0.0) * w_dt if lobes[1] else zero
    if lobes[2]:
        g_r, _pdf_gr_shared = _glossy_refl_eval(p, alpha, wi, wo, glossy)
    else:
        g_r, _pdf_gr_shared = zero, zero
    g_t = ggx.refract_eval(alpha, p.ior, wi, wo) * w_gt if lobes[3] else zero

    fx = p.diffuse.x * f_dr + p.diffuse_trans.x * f_dt + r_coeff.x * g_r + g_t
    fy = p.diffuse.y * f_dr + p.diffuse_trans.y * f_dt + r_coeff.y * g_r + g_t
    fz = p.diffuse.z * f_dr + p.diffuse_trans.z * f_dt + r_coeff.z * g_r + g_t

    p_dr, p_dt, p_gr, p_gt, _p_cc = _selection_probs(p, wi, lobes, clearcoat,
                                                     e_fn)
    if clearcoat:
        tc = clearcoat_fresnel(p, wi)
        fx = fx * (1.0 - tc.x)
        fy = fy * (1.0 - tc.y)
        fz = fz * (1.0 - tc.z)
    pdf_dr = jnp.where(same, abs_co * INV_PI, 0.0) if lobes[0] else zero
    pdf_dt = jnp.where(~same, abs_co * INV_PI, 0.0) if lobes[1] else zero
    pdf_gr = _pdf_gr_shared
    pdf_gt = ggx.refract_pdf(alpha, p.ior, wi, wo) if lobes[3] else zero
    mix_pdf = p_dr * pdf_dr + p_dt * pdf_dt + p_gr * pdf_gr + p_gt * pdf_gt
    return Vec3(fx, fy, fz), mix_pdf


def f_split(
    p: BsdfParams, wi: Vec3, wo: Vec3, lobes=ALL_LOBES, clearcoat: bool = False,
    glossy: str = "ggx", e_fn=None
) -> Tuple[Vec3, Vec3, Array]:
    """(f_diffuse, f_glossy, mixture_pdf) — the per-component split the
    reference's PTVertexProcessor uses to route diffuse vs specular framebuffer
    channels (src/renderers/pathtracer_vertex_processor.h)."""
    alpha = ggx._alpha(p.roughness)
    r_coeff, w_d, w_dt, w_gt = component_weights(p, wi, wo, e_fn)
    same = (wi.z * wo.z) > 0.0
    abs_co = jnp.abs(wo.z)
    zero = jnp.zeros_like(abs_co)
    f_dr = jnp.where(same, INV_PI, 0.0) * w_d if lobes[0] else zero
    f_dt = jnp.where(~same, INV_PI, 0.0) * w_dt if lobes[1] else zero
    if lobes[2]:
        g_r, pdf_gr_shared = _glossy_refl_eval(p, alpha, wi, wo, glossy)
    else:
        g_r, pdf_gr_shared = zero, zero
    g_t = ggx.refract_eval(alpha, p.ior, wi, wo) * w_gt if lobes[3] else zero
    fd = Vec3(
        p.diffuse.x * f_dr + p.diffuse_trans.x * f_dt,
        p.diffuse.y * f_dr + p.diffuse_trans.y * f_dt,
        p.diffuse.z * f_dr + p.diffuse_trans.z * f_dt,
    )
    fg = Vec3(r_coeff.x * g_r + g_t, r_coeff.y * g_r + g_t, r_coeff.z * g_r + g_t)
    p_dr, p_dt, p_gr, p_gt, _p_cc = _selection_probs(p, wi, lobes, clearcoat,
                                                     e_fn)
    if clearcoat:
        tc = clearcoat_fresnel(p, wi)
        fd = Vec3(fd.x * (1.0 - tc.x), fd.y * (1.0 - tc.y), fd.z * (1.0 - tc.z))
        fg = Vec3(fg.x * (1.0 - tc.x), fg.y * (1.0 - tc.y), fg.z * (1.0 - tc.z))
    mix_pdf = (
        p_dr * (jnp.where(same, abs_co * INV_PI, 0.0) if lobes[0] else zero)
        + p_dt * (jnp.where(~same, abs_co * INV_PI, 0.0) if lobes[1] else zero)
        + p_gr * pdf_gr_shared
        + p_gt * (ggx.refract_pdf(alpha, p.ior, wi, wo) if lobes[3] else zero)
    )
    return fd, fg, mix_pdf


class BsdfSample(NamedTuple):
    wo: Vec3  # sampled direction (local frame)
    f: Vec3  # composite BSDF value
    pdf: Array  # mixture solid-angle pdf
    g: Vec3  # f * |cos| / pdf — the throughput weight (bsdf.h `out_g`)
    component: Array  # which lobe was sampled (int32)
    valid: Array  # pdf > 0


def sample(p: BsdfParams, wi: Vec3, u0, u1, u2, lobes=ALL_LOBES,
           clearcoat: bool = False, glossy: str = "ggx",
           e_fn=None) -> BsdfSample:
    """One-sample-MIS lobe sampling (Bsdf::sample, bsdf.h:830-1140).

    With `clearcoat`, the coat's perfectly-specular reflection is a 5th,
    delta component sampled with probability mean(Fc): wo mirrors wi about
    the shading normal, g = Fc/p (bsdf.h:1108-1118), pdf is the delta
    stand-in so downstream MIS weights collapse to 1."""
    p_dr, p_dt, p_gr, p_gt, p_cc = _selection_probs(p, wi, lobes, clearcoat,
                                                    e_fn)
    alpha = ggx._alpha(p.roughness)
    side = jnp.where(wi.z >= 0, 1.0, -1.0)

    c0 = p_dr
    c1 = c0 + p_dt
    c2 = c1 + p_gr
    c3 = c2 + p_gt
    comp = (
        jnp.where(u2 < c0, DIFFUSE_REFL,
        jnp.where(u2 < c1, DIFFUSE_TRANS,
        jnp.where(u2 < c2, GLOSSY_REFL,
        jnp.where(u2 < c3, GLOSSY_TRANS, CLEARCOAT_REFL))))
    ).astype(jnp.int32)
    if not clearcoat:
        comp = jnp.minimum(comp, GLOSSY_TRANS)

    # sample every lobe (cheap, branchless) and select
    d_loc = square_to_cosine_hemisphere(u0, u1)
    wo_dr = Vec3(d_loc.x, d_loc.y, d_loc.z * side)
    wo_dt = Vec3(d_loc.x, d_loc.y, -d_loc.z * side)
    if not lobes[2]:
        wo_gr = wo_dr
    elif glossy == "ltc":
        from fermat_tpu.bsdf.ltc import ltc_sample

        wo_gr, _ = ltc_sample(p.roughness, wi, u0, u1)
    else:
        wo_gr, _ = ggx.reflect_sample(alpha, wi, u0, u1)
    if lobes[3]:
        wo_gt, pdf_gt_s = ggx.refract_sample(alpha, p.ior, wi, u0, u1)
    else:
        wo_gt, pdf_gt_s = wo_dr, jnp.ones_like(u0)

    is_dr = comp == DIFFUSE_REFL
    is_dt = comp == DIFFUSE_TRANS
    is_gr = comp == GLOSSY_REFL
    is_gt = comp == GLOSSY_TRANS

    wo = Vec3(
        jnp.where(is_dr, wo_dr.x, jnp.where(is_dt, wo_dt.x, jnp.where(is_gr, wo_gr.x, wo_gt.x))),
        jnp.where(is_dr, wo_dr.y, jnp.where(is_dt, wo_dt.y, jnp.where(is_gr, wo_gr.y, wo_gt.y))),
        jnp.where(is_dr, wo_dr.z, jnp.where(is_dt, wo_dt.z, jnp.where(is_gr, wo_gr.z, wo_gt.z))),
    )
    if clearcoat:
        # mirror about the shading normal: out = 2 cos_i * N - in
        is_cc = comp == CLEARCOAT_REFL
        wo = Vec3(
            jnp.where(is_cc, -wi.x, wo.x),
            jnp.where(is_cc, -wi.y, wo.y),
            jnp.where(is_cc, wi.z, wo.z),
        )

    # DETACHED sampling (differentiable-rendering convention, cf. Mitsuba 3):
    # the sampled direction and pdf are constants of the estimator; parameter
    # gradients flow through f only. This also kills 1/pdf^2 backward
    # blowups on near-zero-pdf lanes.
    wo = Vec3(
        jax.lax.stop_gradient(wo.x),
        jax.lax.stop_gradient(wo.y),
        jax.lax.stop_gradient(wo.z),
    )
    fv, mix_pdf = f_and_pdf(p, wi, wo, lobes, clearcoat, glossy, e_fn=e_fn)
    # glossy-trans TIR lanes have pdf 0
    mix_pdf = jnp.where(is_gt & (pdf_gt_s <= 0.0), 0.0, mix_pdf)
    mix_pdf = jax.lax.stop_gradient(mix_pdf)
    valid = mix_pdf > 1e-12
    inv_pdf = jnp.where(valid, 1.0 / jnp.where(valid, mix_pdf, 1.0), 0.0)
    cos_o = jnp.abs(wo.z)
    g = Vec3(fv.x * cos_o * inv_pdf, fv.y * cos_o * inv_pdf, fv.z * cos_o * inv_pdf)
    if clearcoat:
        # delta coat reflection: g = Fc / p_comp, f delta, pdf = delta
        # stand-in (bsdf.h:1110-1118)
        is_cc = comp == CLEARCOAT_REFL
        fc = clearcoat_fresnel(p, wi)
        p_cc_safe = jnp.maximum(p_cc, 1e-12)
        cc_ok = is_cc & (p_cc > 1e-7)
        g = Vec3(
            jnp.where(is_cc, jnp.where(cc_ok, fc.x / p_cc_safe, 0.0), g.x),
            jnp.where(is_cc, jnp.where(cc_ok, fc.y / p_cc_safe, 0.0), g.y),
            jnp.where(is_cc, jnp.where(cc_ok, fc.z / p_cc_safe, 0.0), g.z),
        )
        fv = Vec3(
            jnp.where(is_cc, 0.0, fv.x),
            jnp.where(is_cc, 0.0, fv.y),
            jnp.where(is_cc, 0.0, fv.z),
        )
        mix_pdf = jnp.where(is_cc, _DELTA_PDF, mix_pdf)
        valid = jnp.where(is_cc, cc_ok, valid)
    return BsdfSample(wo=wo, f=fv, pdf=mix_pdf, g=g, component=comp, valid=valid)
