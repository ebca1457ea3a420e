"""RPT — reuse-based path tracer (Bekaert et al. 2002).

Reference analogs: src/renderers/rpt.h:54-229 (RPTVPLView/Storage — the
per-pixel "VPL" encoding of each path's secondary vertex), rpt.cu:
  * shade_hits_kernel (:172-340) — the PT-style pass that records VPLs,
  * macrotile_group (:510-840) — the reuse kernel: pixels in a tile
    evaluate every neighbor's VPL with pairwise-MIS weights
    w_k* = 1 / sum_i p(i,k) (the "First/Second Phase" comments), then draw
    REUSE_SHADOW_SAMPLES stochastic shadow rays from a CDF over the
    accumulated contributions.

Shape: one jitted pass, two phases.

  Phase A (record): a PT walk. At the primary vertex x: direct lighting as
  usual (NEE + emissive). The sampled continuation hits the secondary
  vertex y; the VPL stores y's geometry + material id, the incident
  radiance estimates at y (in_alpha = radiance arriving along y's own
  sampled continuation in_dir, from the remaining PT walk; in_alpha2 = the
  NEE sample's incident radiance along in_dir2), and the primary sampling
  pdf. Everything lives in flat (N,) SoA arrays — no atomics, no queues.

  Phase B (reuse): pixels reshape to (tiles, P). Each pixel x_j evaluates
  every VPL y_k in its tile:
      C_jk = f_x^diffuse(eye->out_jk) * G'(x_j,y_k)
             * [ f_y(in_k -> -out_jk) * alpha_k
               + f_y(in2_k -> -out_jk) * alpha2_k ]
             / sum_i p(i,k)
  (Bekaert's pairwise MIS: p(i,k) = solid-angle pdf of pixel i generating
  y_k, converted to area measure). Only the receiver's diffuse lobe reuses
  neighbors — the glossy-received component keeps the pixel's own sample
  (rpt.cu's indirect_glossy=false default) via the lobe-indicator
  estimator. Visibility is stochastic: S connections per pixel drawn from
  the per-pixel contribution CDF, traced as real shadow rays (unbiased, as
  the reference's REUSE_SHADOW_SAMPLES scheme).

Tile membership is re-randomized every pass by rolling the pixel grid by a
per-instance offset (the reference's permuted macro-tiles, rpt.cu:484-508).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fermat_tpu.bsdf.composite import (
    BsdfParams,
    GLOSSY_REFL,
    f_split,
    f_and_pdf,
    sample as bsdf_sample,
)
from fermat_tpu.core.camera import generate_camera_rays
from fermat_tpu.core.math import Vec3, dot, normalize, orthonormal_basis, to_local, to_world
from fermat_tpu.core.rng import TiledSequence
from fermat_tpu.core.sampling import power_heuristic
from fermat_tpu.integrators.pt import _offset_origin, _pick_tracers, PTOptions, _PassOutput
from fermat_tpu.scene.view import SceneView

Array = jax.Array
_sg = jax.lax.stop_gradient
_BIG = 3.0e38


class RPTOptions(NamedTuple):
    """rpt.h:117-150 subset."""

    max_path_length: int = 6
    tile_w: int = 4  # reuse tile is tile_w x tile_h pixels
    tile_h: int = 4
    reuse_shadow_samples: int = 2  # REUSE_SHADOW_SAMPLES analog
    direct_lighting_nee: bool = True
    visible_lights: bool = True
    rr: bool = True
    lobes: tuple = (True, True, True, True)
    ray_eps: float = 1.0e-4
    tracer: str = "auto"
    dims_per_bounce: int = 8


def _lum(v: Vec3) -> Array:
    return 0.2126 * v.x + 0.7152 * v.y + 0.0722 * v.z


def render_pass(
    view: SceneView,
    opts: RPTOptions,
    res_x: int,
    res_y: int,
    instance: Array,
    seed: int = 0,
):
    """One RPT pass; returns ((N,) composited Vec3, rays counter)."""
    n = res_x * res_y
    pix = jnp.arange(n, dtype=jnp.uint32)
    eps = opts.ray_eps
    lobes = opts.lobes
    seq = TiledSequence.create(seed=seed).set_instance(instance)
    pt_opts = PTOptions(tracer=opts.tracer)
    closest, anyhit = _pick_tracers(view, pt_opts)
    n_rays = jnp.zeros((), jnp.float32)
    mesh = view.mesh

    def params_of(mid):
        return BsdfParams.from_materials(mesh.materials.gather(mid))

    # =================== Phase A: trace + record VPLs ===================
    jx, jy = seq.sample_2d(pix, jnp.uint32(0))
    o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy, pix)

    radiance = Vec3.zeros((n,))

    # --- primary hit x ---
    hit = closest(o, d, jnp.float32(eps), jnp.float32(_BIG), jnp.ones(n, bool))
    n_rays = n_rays + jnp.asarray(n, jnp.float32)
    x_valid = hit.hit_mask
    # directly-visible environment (reference stub: renderers/rpt.cu:426)
    from fermat_tpu.scene.envmap import scene_env_radiance

    env_x = scene_env_radiance(view, Vec3(d.x, d.y, d.z))
    radiance = Vec3(
        radiance.x + jnp.where(~x_valid, env_x.x, 0.0),
        radiance.y + jnp.where(~x_valid, env_x.y, 0.0),
        radiance.z + jnp.where(~x_valid, env_x.z, 0.0),
    )
    tri_c = jnp.maximum(hit.tri, 0)
    x_pos, x_gn, x_sn, _xuv, x_mat = mesh.interpolate(tri_c, hit.u, hit.v)
    wi = -d
    flip = jnp.where(dot(x_gn, wi) < 0.0, -1.0, 1.0)
    x_gn, x_sn = x_gn * flip, x_sn * flip
    x_t, x_b = orthonormal_basis(x_sn)
    x_wi_loc = to_local(wi, x_t, x_b, x_sn)
    x_params = params_of(x_mat)

    # visible emitters
    if opts.visible_lights:
        from fermat_tpu.scene.lights import _emissive_of

        le = _emissive_of(mesh, x_mat)
        front = dot(x_gn, wi) > 0.0
        m = x_valid & front
        radiance = Vec3(
            radiance.x + jnp.where(m, le.x, 0.0),
            radiance.y + jnp.where(m, le.y, 0.0),
            radiance.z + jnp.where(m, le.z, 0.0),
        )

    # direct lighting at x (NEE with MIS vs the BSDF continuation)
    if opts.direct_lighting_nee:
        ul0, ul1, ul2 = seq.sample_3d(pix, jnp.uint32(2))
        lpos, ln, lle, lpdf_a, _lt = view.lights.sample(mesh, ul0, ul1, ul2)
        to_l = lpos - x_pos
        d2 = jnp.maximum(dot(to_l, to_l), 1e-12)
        dist = jnp.sqrt(d2)
        wo = to_l * (1.0 / dist)
        cos_l = dot(ln, -wo)
        wo_loc = to_local(wo, x_t, x_b, x_sn)
        fd, fg, bsdf_pdf = f_split(x_params, x_wi_loc, wo_loc, lobes)
        pdf_sa = _sg(lpdf_a * d2 / jnp.maximum(jnp.abs(cos_l), 1e-8))
        w_mis = _sg(power_heuristic(pdf_sa, bsdf_pdf))
        cos_s = jnp.abs(wo_loc.z)
        able = (
            x_valid & view.lights.has_lights & (cos_l > 1e-6) & (pdf_sa > 1e-12)
            & ((fd.x + fd.y + fd.z + fg.x + fg.y + fg.z) > 0.0)
        )
        so = _offset_origin(x_pos, x_gn, wo, eps)
        occ = anyhit(so, wo, jnp.float32(0.0), dist * (1.0 - 1e-3), able)
        n_rays = n_rays + jnp.sum(able.astype(jnp.float32))
        lit = able & ~occ
        s_ = cos_s * w_mis / jnp.maximum(pdf_sa, 1e-12)
        radiance = Vec3(
            radiance.x + jnp.where(lit, (fd.x + fg.x) * lle.x * s_, 0.0),
            radiance.y + jnp.where(lit, (fd.y + fg.y) * lle.y * s_, 0.0),
            radiance.z + jnp.where(lit, (fd.z + fg.z) * lle.z * s_, 0.0),
        )

    # continuation: sample the BSDF at x, trace to the secondary vertex y
    ub0, ub1, ub2 = seq.sample_3d(pix, jnp.uint32(5))
    sx = bsdf_sample(x_params, x_wi_loc, ub0, ub1, ub2, lobes)
    d1 = to_world(sx.wo, x_t, x_b, x_sn)
    o1 = _offset_origin(x_pos, x_gn, d1, eps)
    go = x_valid & sx.valid
    hit_y = closest(o1, d1, jnp.float32(eps), jnp.float32(_BIG), go)
    n_rays = n_rays + jnp.sum(go.astype(jnp.float32))
    y_valid = go & hit_y.hit_mask
    # continuation escaped to the environment: the pixel's own s=0 sky
    # path (weight 1 — NEE never samples the env)
    env_y = scene_env_radiance(view, Vec3(d1.x, d1.y, d1.z))
    m_env_y = go & ~hit_y.hit_mask
    radiance = Vec3(
        radiance.x + jnp.where(m_env_y, sx.g.x * env_y.x, 0.0),
        radiance.y + jnp.where(m_env_y, sx.g.y * env_y.y, 0.0),
        radiance.z + jnp.where(m_env_y, sx.g.z * env_y.z, 0.0),
    )
    ytri = jnp.maximum(hit_y.tri, 0)
    y_pos, y_gn, y_sn, _yuv, y_mat = mesh.interpolate(ytri, hit_y.u, hit_y.v)
    y_wi = -d1
    yflip = jnp.where(dot(y_gn, y_wi) < 0.0, -1.0, 1.0)
    y_gn, y_sn = y_gn * yflip, y_sn * yflip
    y_t, y_b = orthonormal_basis(y_sn)
    y_wi_loc = to_local(y_wi, y_t, y_b, y_sn)
    y_params = params_of(y_mat)

    # emissive seen through the continuation — the pixel's own s=0 path,
    # MIS-weighted against NEE at x (kept own-pixel: emitters are not reused)
    from fermat_tpu.scene.lights import _emissive_of

    y_le = _emissive_of(mesh, y_mat)
    y_front = dot(y_gn, y_wi) > 0.0
    pdf_area_y = view.lights.pdf_area_of(ytri)
    t_safe = jnp.where(y_valid, hit_y.t, 1.0)
    pdf_sa_l = pdf_area_y * t_safe * t_safe / jnp.maximum(jnp.abs(dot(y_gn, y_wi)), 1e-8)
    w_em = _sg(power_heuristic(sx.pdf, pdf_sa_l)) if opts.direct_lighting_nee else 1.0
    m_em = y_valid & y_front
    radiance = Vec3(
        radiance.x + jnp.where(m_em, sx.g.x * y_le.x * w_em, 0.0),
        radiance.y + jnp.where(m_em, sx.g.y * y_le.y * w_em, 0.0),
        radiance.z + jnp.where(m_em, sx.g.z * y_le.z * w_em, 0.0),
    )

    # --- NEE at y -> in_alpha2 (incident radiance from the light sample) ---
    un0, un1, un2 = seq.sample_3d(pix, jnp.uint32(10))
    l2pos, l2n, l2le, l2pdf_a, _l2t = view.lights.sample(mesh, un0, un1, un2)
    to_l2 = l2pos - y_pos
    d2_2 = jnp.maximum(dot(to_l2, to_l2), 1e-12)
    dist2 = jnp.sqrt(d2_2)
    in_dir2 = to_l2 * (1.0 / dist2)  # direction from y toward the light
    cos_l2 = dot(l2n, -in_dir2)
    pdf2_sa = _sg(l2pdf_a * d2_2 / jnp.maximum(jnp.abs(cos_l2), 1e-8))
    able2 = (
        y_valid & view.lights.has_lights & (cos_l2 > 1e-6) & (pdf2_sa > 1e-12)
    )
    so2 = _offset_origin(y_pos, y_gn, in_dir2, eps)
    occ2 = anyhit(so2, in_dir2, jnp.float32(0.0), dist2 * (1.0 - 1e-3), able2)
    n_rays = n_rays + jnp.sum(able2.astype(jnp.float32))
    lit2 = able2 & ~occ2
    inv_p2 = 1.0 / jnp.maximum(pdf2_sa, 1e-12)
    # MIS vs the continuation pdf at y (the walk below continues by BSDF)
    wo2_loc = to_local(in_dir2, y_t, y_b, y_sn)
    _fd2, _fg2, pdf_b2 = f_split(y_params, y_wi_loc, wo2_loc, lobes)
    w2_mis = _sg(power_heuristic(pdf2_sa, pdf_b2))
    alpha2 = Vec3(
        jnp.where(lit2, l2le.x * inv_p2 * w2_mis, 0.0),
        jnp.where(lit2, l2le.y * inv_p2 * w2_mis, 0.0),
        jnp.where(lit2, l2le.z * inv_p2 * w2_mis, 0.0),
    )

    # --- continuation walk from y -> in_alpha (radiance along in_dir) ---
    uc0, uc1, uc2 = seq.sample_3d(pix, jnp.uint32(13))
    sy = bsdf_sample(y_params, y_wi_loc, uc0, uc1, uc2, lobes)
    in_dir = to_world(sy.wo, y_t, y_b, y_sn)  # continuation direction at y
    # walk the remaining bounces with a standard PT loop, collecting the
    # radiance that arrives at y along in_dir, divided by the continuation
    # pdf... NOTE: alpha stores E[L_in] (radiance estimate), so the 1/pdf +
    # f/cos of y's own scatter are NOT folded in — they are re-applied by
    # the reuse formula through f_y and the MIS weights.
    # sample-based estimate: L_in ~ (emitted + NEE + ...) along the path,
    # starting at the vertex z = hit(y, in_dir).
    alpha = Vec3.zeros((n,))
    thr = Vec3.full((n,), 1.0, 1.0, 1.0)
    alive = y_valid & sy.valid
    oz = _offset_origin(y_pos, y_gn, in_dir, eps)
    dz = in_dir
    prev_pdf = sy.pdf
    for b in range(2, opts.max_path_length):
        hz = closest(oz, dz, jnp.float32(eps), jnp.float32(_BIG), alive)
        n_rays = n_rays + jnp.sum(alive.astype(jnp.float32))
        zv = alive & hz.hit_mask
        # escaped continuation: env radiance joins the reused incident
        # estimate (weight 1)
        env_z = scene_env_radiance(view, Vec3(dz.x, dz.y, dz.z))
        m_env_z = alive & ~hz.hit_mask
        alpha = Vec3(
            alpha.x + jnp.where(m_env_z, thr.x * env_z.x, 0.0),
            alpha.y + jnp.where(m_env_z, thr.y * env_z.y, 0.0),
            alpha.z + jnp.where(m_env_z, thr.z * env_z.z, 0.0),
        )
        ztri = jnp.maximum(hz.tri, 0)
        z_pos, z_gn, z_sn, _zuv, z_mat = mesh.interpolate(ztri, hz.u, hz.v)
        zwi = -dz
        zflip = jnp.where(dot(z_gn, zwi) < 0.0, -1.0, 1.0)
        z_gn, z_sn = z_gn * zflip, z_sn * zflip
        z_t, z_b = orthonormal_basis(z_sn)
        z_wi_loc = to_local(zwi, z_t, z_b, z_sn)
        z_params = params_of(z_mat)

        # emissive with MIS vs NEE at the previous vertex
        z_le = _emissive_of(mesh, z_mat)
        z_front = dot(z_gn, zwi) > 0.0
        pdf_a_z = view.lights.pdf_area_of(ztri)
        tz = jnp.where(zv, hz.t, 1.0)
        pdf_sa_z = pdf_a_z * tz * tz / jnp.maximum(jnp.abs(dot(z_gn, zwi)), 1e-8)
        w_z = _sg(power_heuristic(prev_pdf, pdf_sa_z))
        mz = zv & z_front
        alpha = Vec3(
            alpha.x + jnp.where(mz, thr.x * z_le.x * w_z, 0.0),
            alpha.y + jnp.where(mz, thr.y * z_le.y * w_z, 0.0),
            alpha.z + jnp.where(mz, thr.z * z_le.z * w_z, 0.0),
        )

        # NEE at z
        uz0, uz1, uz2 = seq.sample_3d(pix, jnp.uint32(20 + b * opts.dims_per_bounce))
        lz_pos, lz_n, lz_le, lz_pdf, _ = view.lights.sample(mesh, uz0, uz1, uz2)
        to_lz = lz_pos - z_pos
        dz2 = jnp.maximum(dot(to_lz, to_lz), 1e-12)
        distz = jnp.sqrt(dz2)
        woz = to_lz * (1.0 / distz)
        cos_lz = dot(lz_n, -woz)
        woz_loc = to_local(woz, z_t, z_b, z_sn)
        fdz, fgz, pdf_bz = f_split(z_params, z_wi_loc, woz_loc, lobes)
        pdf_sa_lz = _sg(lz_pdf * dz2 / jnp.maximum(jnp.abs(cos_lz), 1e-8))
        wz_mis = _sg(power_heuristic(pdf_sa_lz, pdf_bz))
        cos_sz = jnp.abs(woz_loc.z)
        ablez = (
            zv & view.lights.has_lights & (cos_lz > 1e-6) & (pdf_sa_lz > 1e-12)
            & ((fdz.x + fdz.y + fdz.z + fgz.x + fgz.y + fgz.z) > 0.0)
        )
        soz = _offset_origin(z_pos, z_gn, woz, eps)
        occz = anyhit(soz, woz, jnp.float32(0.0), distz * (1.0 - 1e-3), ablez)
        n_rays = n_rays + jnp.sum(ablez.astype(jnp.float32))
        litz = ablez & ~occz
        sc = cos_sz * wz_mis / jnp.maximum(pdf_sa_lz, 1e-12)
        alpha = Vec3(
            alpha.x + jnp.where(litz, thr.x * (fdz.x + fgz.x) * lz_le.x * sc, 0.0),
            alpha.y + jnp.where(litz, thr.y * (fdz.y + fgz.y) * lz_le.y * sc, 0.0),
            alpha.z + jnp.where(litz, thr.z * (fdz.z + fgz.z) * lz_le.z * sc, 0.0),
        )

        # scatter + RR
        us0, us1, us2 = seq.sample_3d(pix, jnp.uint32(23 + b * opts.dims_per_bounce))
        sz = bsdf_sample(z_params, z_wi_loc, us0, us1, us2, lobes)
        thr = Vec3(thr.x * sz.g.x, thr.y * sz.g.y, thr.z * sz.g.z)
        alive = zv & sz.valid
        if opts.rr:
            u_rr = seq.sample_1d(pix, jnp.uint32(26 + b * opts.dims_per_bounce))
            q = jnp.clip(jnp.maximum(jnp.maximum(thr.x, thr.y), thr.z), 0.05, 1.0)
            q = _sg(q)
            alive = alive & (u_rr < q)
            inv_q = 1.0 / q
            thr = Vec3(thr.x * inv_q, thr.y * inv_q, thr.z * inv_q)
        thr = Vec3(
            jnp.where(alive, thr.x, 0.0),
            jnp.where(alive, thr.y, 0.0),
            jnp.where(alive, thr.z, 0.0),
        )
        wz_world = to_world(sz.wo, z_t, z_b, z_sn)
        oz = _offset_origin(z_pos, z_gn, wz_world, eps)
        dz = wz_world
        prev_pdf = sz.pdf

    # fold the incident cosines + sampling pdf into the stored alphas
    # (the reference packs exactly this product into in_alpha/in_alpha2, so
    # the reuse formula is just f_y * alpha): alpha_k estimates
    # integral(L_in * cos_in) for its strategy.
    cos_cont = jnp.abs(dot(y_sn, in_dir))
    inv_pc = jnp.where(sy.valid, 1.0 / jnp.maximum(sy.pdf, 1e-12), 0.0)
    cos_nee = jnp.abs(wo2_loc.z)
    alpha = Vec3(
        alpha.x * cos_cont * inv_pc,
        alpha.y * cos_cont * inv_pc,
        alpha.z * cos_cont * inv_pc,
    )
    alpha2 = Vec3(alpha2.x * cos_nee, alpha2.y * cos_nee, alpha2.z * cos_nee)

    # pixel's own glossy-received indirect (not reused; lobe indicator):
    # the x-sample covers the glossy lobes with the full mixture pdf, so
    # gating on the sampled component being glossy is unbiased for the
    # glossy-received component (rpt.cu indirect_glossy=false default).
    f_cont, _p_c = f_and_pdf(y_params, to_local(in_dir, y_t, y_b, y_sn), y_wi_loc, lobes)
    f_nee_y, _p_n = f_and_pdf(y_params, wo2_loc, y_wi_loc, lobes)
    Lyx = Vec3(  # outgoing radiance estimate y -> x
        f_cont.x * alpha.x + f_nee_y.x * alpha2.x,
        f_cont.y * alpha.y + f_nee_y.y * alpha2.y,
        f_cont.z * alpha.z + f_nee_y.z * alpha2.z,
    )
    own_glossy = sx.component >= GLOSSY_REFL
    inv_px = jnp.where(sx.valid, 1.0 / jnp.maximum(sx.pdf, 1e-12), 0.0)
    # receiving-side split: diffuse part goes through reuse; glossy own-path
    _fx_d, fx_g = _split_recv(x_params, x_wi_loc, sx.wo, lobes)
    cos_x = jnp.abs(sx.wo.z)
    mg = y_valid & own_glossy
    radiance = Vec3(
        radiance.x + jnp.where(mg, fx_g.x * cos_x * inv_px * Lyx.x, 0.0),
        radiance.y + jnp.where(mg, fx_g.y * cos_x * inv_px * Lyx.y, 0.0),
        radiance.z + jnp.where(mg, fx_g.z * cos_x * inv_px * Lyx.z, 0.0),
    )

    # =================== Phase B: tile reuse ===================
    # per-pass random tile offset (permuted macro-tiles analog): roll the
    # pixel grid so tile membership changes every pass. roll + reshape +
    # transpose are layout ops — no (N,) gathers on the hot path.
    P = opts.tile_w * opts.tile_h
    from fermat_tpu.core.rng import hash_u32, _u32

    off_x = (hash_u32(_u32(instance) * _u32(7919) + _u32(seed)) % _u32(opts.tile_w)).astype(jnp.int32)
    off_y = (hash_u32(_u32(instance) * _u32(104729) + _u32(seed + 1)) % _u32(opts.tile_h)).astype(jnp.int32)

    tw, th = opts.tile_w, opts.tile_h
    assert res_x % tw == 0 and res_y % th == 0, "resolution must tile evenly"
    n_tx = res_x // tw
    n_ty = res_y // th
    n_tiles = n_tx * n_ty

    def tile_of(a):
        img = a.reshape(res_y, res_x)
        img = jnp.roll(img, shift=(off_y, off_x), axis=(0, 1))
        return (
            img.reshape(n_ty, th, n_tx, tw)
            .transpose(0, 2, 1, 3)
            .reshape(n_tiles, P)
        )

    def tile_of3(v: Vec3):
        return Vec3(tile_of(v.x), tile_of(v.y), tile_of(v.z))

    T_xpos = tile_of3(x_pos)
    T_xsn = tile_of3(x_sn)
    T_xgn = tile_of3(x_gn)
    T_xwi = tile_of3(wi)
    T_ypos = tile_of3(y_pos)
    T_ysn = tile_of3(y_sn)
    T_ywi = tile_of3(y_wi)
    T_in2 = tile_of3(in_dir2)
    T_ind = tile_of3(in_dir)
    T_alpha = tile_of3(alpha)
    T_alpha2 = tile_of3(alpha2)
    T_yv = tile_of(y_valid)
    T_xv = tile_of(x_valid)

    # pairwise geometry: receiver j (axis 1), VPL k (axis 2)
    def pair(a):  # (n_tiles, P) -> (n_tiles, P, 1) receiver
        return a[:, :, None]

    def pairk(a):  # VPL axis
        return a[:, None, :]

    ox_ = Vec3(pair(T_xpos.x), pair(T_xpos.y), pair(T_xpos.z))
    yk_ = Vec3(pairk(T_ypos.x), pairk(T_ypos.y), pairk(T_ypos.z))
    cx = Vec3(yk_.x - ox_.x, yk_.y - ox_.y, yk_.z - ox_.z)
    cd2 = jnp.maximum(cx.x * cx.x + cx.y * cx.y + cx.z * cx.z, 1e-12)
    cd = jnp.sqrt(cd2)
    out = Vec3(cx.x / cd, cx.y / cd, cx.z / cd)  # (n_tiles, P, P)

    # receiver-side: diffuse f and pdf of sampling out_jk
    # local frames per receiver, broadcast over k
    def locd(v: Vec3, t: Vec3, b: Vec3, nrm: Vec3) -> Vec3:
        return Vec3(
            v.x * pair(t.x) + v.y * pair(t.y) + v.z * pair(t.z),
            v.x * pair(b.x) + v.y * pair(b.y) + v.z * pair(b.z),
            v.x * pair(nrm.x) + v.y * pair(nrm.y) + v.z * pair(nrm.z),
        )

    T_xt, T_xb = orthonormal_basis(T_xsn)
    out_loc = locd(out, T_xt, T_xb, T_xsn)
    wi_loc_j = to_local(T_xwi, T_xt, T_xb, T_xsn)  # (n_tiles, P)
    wi_loc_jb = Vec3(pair(wi_loc_j.x), pair(wi_loc_j.y), pair(wi_loc_j.z))

    # flatten pairwise to lanes for the BSDF helpers
    shp = out_loc.x.shape

    def flat3(v):
        return Vec3(v.x.reshape(-1), v.y.reshape(-1), v.z.reshape(-1))

    def bparams_rep(params_tiled, reps):
        return BsdfParams(
            diffuse=flat3(Vec3(*(jnp.broadcast_to(pair(c), shp) for c in (params_tiled.diffuse.x, params_tiled.diffuse.y, params_tiled.diffuse.z)))),
            diffuse_trans=flat3(Vec3(*(jnp.broadcast_to(pair(c), shp) for c in (params_tiled.diffuse_trans.x, params_tiled.diffuse_trans.y, params_tiled.diffuse_trans.z)))),
            specular=flat3(Vec3(*(jnp.broadcast_to(pair(c), shp) for c in (params_tiled.specular.x, params_tiled.specular.y, params_tiled.specular.z)))),
            roughness=jnp.broadcast_to(pair(params_tiled.roughness), shp).reshape(-1),
            ior=jnp.broadcast_to(pair(params_tiled.ior), shp).reshape(-1),
            opacity=jnp.broadcast_to(pair(params_tiled.opacity), shp).reshape(-1),
        )

    def tile_params(params, proj):
        return BsdfParams(
            diffuse=Vec3(proj(params.diffuse.x), proj(params.diffuse.y), proj(params.diffuse.z)),
            diffuse_trans=Vec3(proj(params.diffuse_trans.x), proj(params.diffuse_trans.y), proj(params.diffuse_trans.z)),
            specular=Vec3(proj(params.specular.x), proj(params.specular.y), proj(params.specular.z)),
            roughness=proj(params.roughness),
            ior=proj(params.ior),
            opacity=proj(params.opacity),
        )

    Tx_params = tile_params(x_params, tile_of)
    Ty_params = tile_params(y_params, tile_of)

    Px_rep = bparams_rep(Tx_params, None)  # receiver params per (j,k) lane
    wi_jk = Vec3(
        jnp.broadcast_to(wi_loc_jb.x, shp),
        jnp.broadcast_to(wi_loc_jb.y, shp),
        jnp.broadcast_to(wi_loc_jb.z, shp),
    )
    fd_jk, _fg_jk, pdf_jk = f_split(Px_rep, flat3(wi_jk), flat3(out_loc), lobes)
    fd_jk = Vec3(fd_jk.x.reshape(shp), fd_jk.y.reshape(shp), fd_jk.z.reshape(shp))
    pdf_jk = pdf_jk.reshape(shp)  # solid-angle pdf of j sampling out_jk

    # VPL-side BSDF: f_y(in -> -out) and f_y(in2 -> -out)
    T_yt, T_yb = orthonormal_basis(T_ysn)

    def lock(v: Vec3) -> Vec3:  # into VPL k's frame
        return Vec3(
            v.x * pairk(T_yt.x) + v.y * pairk(T_yt.y) + v.z * pairk(T_yt.z),
            v.x * pairk(T_yb.x) + v.y * pairk(T_yb.y) + v.z * pairk(T_yb.z),
            v.x * pairk(T_ysn.x) + v.y * pairk(T_ysn.y) + v.z * pairk(T_ysn.z),
        )

    neg_out = Vec3(-out.x, -out.y, -out.z)
    nout_loc = lock(neg_out)
    in_loc_k = to_local(T_ind, T_yt, T_yb, T_ysn)
    in2_loc_k = to_local(T_in2, T_yt, T_yb, T_ysn)

    def bparams_repk(params_tiled):
        return BsdfParams(
            diffuse=flat3(Vec3(*(jnp.broadcast_to(pairk(c), shp) for c in (params_tiled.diffuse.x, params_tiled.diffuse.y, params_tiled.diffuse.z)))),
            diffuse_trans=flat3(Vec3(*(jnp.broadcast_to(pairk(c), shp) for c in (params_tiled.diffuse_trans.x, params_tiled.diffuse_trans.y, params_tiled.diffuse_trans.z)))),
            specular=flat3(Vec3(*(jnp.broadcast_to(pairk(c), shp) for c in (params_tiled.specular.x, params_tiled.specular.y, params_tiled.specular.z)))),
            roughness=jnp.broadcast_to(pairk(params_tiled.roughness), shp).reshape(-1),
            ior=jnp.broadcast_to(pairk(params_tiled.ior), shp).reshape(-1),
            opacity=jnp.broadcast_to(pairk(params_tiled.opacity), shp).reshape(-1),
        )

    Py_rep = bparams_repk(Ty_params)
    in_k_b = Vec3(
        jnp.broadcast_to(pairk(in_loc_k.x), shp),
        jnp.broadcast_to(pairk(in_loc_k.y), shp),
        jnp.broadcast_to(pairk(in_loc_k.z), shp),
    )
    in2_k_b = Vec3(
        jnp.broadcast_to(pairk(in2_loc_k.x), shp),
        jnp.broadcast_to(pairk(in2_loc_k.y), shp),
        jnp.broadcast_to(pairk(in2_loc_k.z), shp),
    )
    fL, _ = f_and_pdf(Py_rep, flat3(Vec3(in_k_b.x, in_k_b.y, in_k_b.z)), flat3(nout_loc), lobes)
    fL2, _ = f_and_pdf(Py_rep, flat3(Vec3(in2_k_b.x, in2_k_b.y, in2_k_b.z)), flat3(nout_loc), lobes)
    fL = Vec3(fL.x.reshape(shp), fL.y.reshape(shp), fL.z.reshape(shp))
    fL2 = Vec3(fL2.x.reshape(shp), fL2.y.reshape(shp), fL2.z.reshape(shp))

    # G' and pairwise pdfs in area measure: p(j,k) = pdf_jk * cos_y / d^2
    cos_y = jnp.abs(nout_loc.z)  # |cos| at the VPL
    cos_x_jk = jnp.abs(out_loc.z)
    Gp = cos_y / cd2  # G' (no receiver cos: folded into f * cos below)
    p_area = _sg(pdf_jk) * Gp  # p(j,k) in area measure
    # exclude invalid receivers from the MIS sum (they never sample y_k)
    valid_pair = pair(T_xv) & pairk(T_yv)
    p_area = jnp.where(valid_pair, p_area, 0.0)
    p_sum = jnp.sum(p_area, axis=1, keepdims=True)  # sum_i p(i,k) -> (n_tiles,1,P)

    # Bekaert estimator: C_jk = f_x * cos_x * G' * [fL*alpha + fL2*alpha2] / sum_i p(i,k)
    inv_psum = jnp.where(p_sum > 0.0, 1.0 / jnp.maximum(p_sum, 1e-30), 0.0)
    a_k = Vec3(
        jnp.broadcast_to(pairk(T_alpha.x), shp),
        jnp.broadcast_to(pairk(T_alpha.y), shp),
        jnp.broadcast_to(pairk(T_alpha.z), shp),
    )
    a2_k = Vec3(
        jnp.broadcast_to(pairk(T_alpha2.x), shp),
        jnp.broadcast_to(pairk(T_alpha2.y), shp),
        jnp.broadcast_to(pairk(T_alpha2.z), shp),
    )
    Ljk = Vec3(
        fL.x * a_k.x + fL2.x * a2_k.x,
        fL.y * a_k.y + fL2.y * a2_k.y,
        fL.z * a_k.z + fL2.z * a2_k.z,
    )
    scale = cos_x_jk * Gp * inv_psum
    C = Vec3(
        jnp.where(valid_pair, fd_jk.x * Ljk.x * scale, 0.0),
        jnp.where(valid_pair, fd_jk.y * Ljk.y * scale, 0.0),
        jnp.where(valid_pair, fd_jk.z * Ljk.z * scale, 0.0),
    )

    # stochastic visibility: S connections per receiver from the C-lum CDF
    lumC = 0.2126 * C.x + 0.7152 * C.y + 0.0722 * C.z
    lumC = jnp.where(jnp.isfinite(lumC), jnp.maximum(lumC, 0.0), 0.0)
    cdf = jnp.cumsum(lumC, axis=2)  # (n_tiles, P, P)
    tot = cdf[:, :, -1]
    reuse = Vec3.zeros((n_tiles, P))
    S = opts.reuse_shadow_samples
    for si in range(S):
        u = tile_of(seq.sample_1d(pix, jnp.uint32(60 + si)))  # (n_tiles, P)
        r = u * tot
        k_pick = jnp.sum((cdf <= r[:, :, None]).astype(jnp.int32), axis=2)
        k_pick = jnp.minimum(k_pick, P - 1)
        pickk = lambda a: jnp.take_along_axis(a, k_pick[:, :, None], axis=2)[:, :, 0]
        C_p = Vec3(pickk(C.x), pickk(C.y), pickk(C.z))
        lum_p = pickk(lumC)
        # shadow ray x_j -> y_{k_pick}
        ypk = Vec3(
            jnp.take_along_axis(T_ypos.x, k_pick, axis=1),
            jnp.take_along_axis(T_ypos.y, k_pick, axis=1),
            jnp.take_along_axis(T_ypos.z, k_pick, axis=1),
        )
        to_y = Vec3(ypk.x - T_xpos.x, ypk.y - T_xpos.y, ypk.z - T_xpos.z)
        dd2 = jnp.maximum(to_y.x**2 + to_y.y**2 + to_y.z**2, 1e-12)
        dd = jnp.sqrt(dd2)
        dirn = Vec3(to_y.x / dd, to_y.y / dd, to_y.z / dd)
        flat = lambda a: a.reshape(n_tiles * P)
        f3 = lambda v: Vec3(flat(v.x), flat(v.y), flat(v.z))
        able_v = flat((tot > 0.0) & T_xv)
        so_v = _offset_origin(f3(T_xpos), f3(T_xgn), f3(dirn), eps)
        occ_v = anyhit(so_v, f3(dirn), jnp.float32(0.0),
                       flat(dd) * (1.0 - 1e-3), able_v)
        n_rays = n_rays + jnp.sum(able_v.astype(jnp.float32))
        vis = (~occ_v).reshape(n_tiles, P)
        # estimator: tot * (C_k / lum_k) * vis / S  (RIS over connections)
        amp = jnp.where((lum_p > 0.0) & vis & (tot > 0.0),
                        tot / jnp.maximum(lum_p, 1e-30) / S, 0.0)
        reuse = Vec3(
            reuse.x + C_p.x * amp, reuse.y + C_p.y * amp, reuse.z + C_p.z * amp
        )

    # un-tile back to pixel order and add the diffuse-received reuse
    def back(a):
        img = (
            a.reshape(n_ty, n_tx, th, tw)
            .transpose(0, 2, 1, 3)
            .reshape(res_y, res_x)
        )
        return jnp.roll(img, shift=(-off_y, -off_x), axis=(0, 1)).reshape(n)

    radiance = Vec3(
        radiance.x + back(reuse.x),
        radiance.y + back(reuse.y),
        radiance.z + back(reuse.z),
    )
    return radiance, n_rays


def _split_recv(p, wi_loc, wo_loc, lobes):
    """Receiver-side diffuse/glossy f split (same as f_split's two parts)."""
    fd, fg, _ = f_split(p, wi_loc, wo_loc, lobes)
    return fd, fg


def render_pass_fb(
    view: SceneView,
    opts: RPTOptions,
    res_x: int,
    res_y: int,
    instance: Array,
    seed: int = 0,
    pix: Array = None,
):
    """Framebuffer-shaped adapter (registry entry)."""
    rad, n_rays = render_pass(view, opts, res_x, res_y, instance, seed)
    npix = res_x * res_y
    zero3 = Vec3.zeros((npix,))
    return _PassOutput(
        direct=zero3, diffuse=zero3, specular=zero3, composited=rad,
        diffuse_albedo=zero3, specular_albedo=zero3,
        depth=jnp.full(npix, jnp.inf, jnp.float32),
        tri=jnp.full(npix, -1, jnp.int32), normal=zero3, position=zero3,
        uv=jnp.zeros((npix, 2), jnp.float32),
        material=jnp.full(npix, -1, jnp.int32),
        rays=n_rays,
    )
