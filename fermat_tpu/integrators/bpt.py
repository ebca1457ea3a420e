"""Bidirectional path tracer (BPT) with recursive MIS.

Reference analogs:
  * BPTLib: bpt_context.h:53-100 (BPTContextBase: light-vertex storage +
    queues), bpt_control.h:312-511 (sample_light_subpaths /
    sample_eye_subpaths phase drivers), bpt_kernels.h (generate/process
    light & eye vertices, connections, camera connections),
    bpt_utils.h:110-230 (TempPathWeights — the recursive MIS quantities),
    vertex_storage.h:51-106 (SoA light-vertex storage).
  * renderers/bpt* (bpt_impl.h:122-260): non-atomic sink for eye-indexed
    strategies, atomic sink for light tracing.

Shape: one jitted pass. Light subpaths are walked first and stored
as (N, L) SoA slot arrays (the VertexStorage analog — fixed capacity, masked
slots, no append queues). The eye walk then runs PT-style with, at each eye
vertex: the s=0 emissive strategy, the s=1 NEE strategy, and s>=2 vertex
connections against this pixel's own light subpath slots. Light tracing
(t=1) projects every stored light vertex to the camera and splats with a
scatter-add (`.at[].add` — the segment-sum replacement for the reference's
atomic ConnectionsSink<true>, bpt_impl.h:143-155).

MIS uses the SmallVCM-style recursive quantities (dVCM, dVC) — an exact
reformulation of the reference's TempPathWeights recursion — with the
balance heuristic. All sampling decisions are detached (see pt.py).

Light-subpath scattering and every light-side connection eval carry the
adjoint shading-normal correction (Veach eq. 5.19; the reference's
TransportType plumbing) — see `_adjoint_corr`. Texture modulation applies on
BOTH subpaths (`_textured_params`), matching PT's textured shading path, so
BPT == PT on textured scenes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.bsdf.composite import (
    BsdfParams,
    f_and_pdf,
    sample as bsdf_sample,
)
from fermat_tpu.core.camera import CameraSampler, generate_camera_rays
from fermat_tpu.core.math import Vec3, dot, normalize, orthonormal_basis, to_local, to_world
from fermat_tpu.core.rng import TiledSequence
from fermat_tpu.core.sampling import INV_PI, PI, square_to_cosine_hemisphere
from fermat_tpu.integrators.pt import _offset_origin, _pick_tracers, PTOptions
from fermat_tpu.scene.lights import _emissive_of
from fermat_tpu.scene.view import SceneView

Array = jax.Array

_sg = jax.lax.stop_gradient


class BPTOptions(NamedTuple):
    """bpt_options.h:64-92 subset."""

    max_path_length: int = 6  # vertices per subpath
    light_tracing: bool = True  # t=1 strategies (camera splats)
    single_connection: bool = False  # connect to one sampled light vertex only
    rr: bool = False  # RR disabled by default for BPT (ref default off for light paths)
    lobes: tuple = (True, True, True, True)
    ray_eps: float = 1.0e-4
    tracer: str = "auto"
    dims_per_bounce: int = 8
    # env tail trace (escape ray off the last eye vertex): None = auto
    # (on when an env map is present, or when the constant env is
    # concretely nonzero). Under jit-with-view-as-argument (sharded) or
    # grad w.r.t. env, the constant is a tracer and auto resolves OFF —
    # set True explicitly there for constant-env scenes.
    env_tail: "object" = None


def _mis(x):
    """Balance-heuristic accumulator transform (SmallVCM Mis())."""
    return x


class LightVertices(NamedTuple):
    """(N, L) SoA light-vertex slots (vertex_storage.h analog)."""

    px: Array  # position
    py: Array
    pz: Array
    nx: Array  # shading normal (flipped to incoming side)
    ny: Array
    nz: Array
    gnx: Array  # geometric normal (flipped)
    gny: Array
    gnz: Array
    wix: Array  # direction towards the previous vertex (unit)
    wiy: Array
    wiz: Array
    thr_x: Array  # path throughput up to and including this vertex
    thr_y: Array
    thr_z: Array
    d_vcm: Array
    d_vc: Array
    mat: Array  # material id
    uvx: Array  # texture coords at the vertex (for _textured_params)
    uvy: Array
    valid: Array  # bool

    def at_slot(self, j: int):
        g = lambda a: a[:, j]
        return (
            Vec3(g(self.px), g(self.py), g(self.pz)),
            Vec3(g(self.nx), g(self.ny), g(self.nz)),
            Vec3(g(self.gnx), g(self.gny), g(self.gnz)),
            Vec3(g(self.wix), g(self.wiy), g(self.wiz)),
            Vec3(g(self.thr_x), g(self.thr_y), g(self.thr_z)),
            g(self.d_vcm),
            g(self.d_vc),
            g(self.mat),
            (g(self.uvx), g(self.uvy)),
            g(self.valid),
        )


def _eval_both(params: BsdfParams, wi_loc: Vec3, wo_loc: Vec3, lobes):
    """f(wi->wo), pdf(wi->wo), pdf(wo->wi) — the connection kernel needs the
    reverse pdf for the MIS recursion (bpt_utils.h pdf products)."""
    f, pdf_fwd = f_and_pdf(params, wi_loc, wo_loc, lobes)
    _, pdf_rev = f_and_pdf(params, wo_loc, wi_loc, lobes)
    return f, _sg(pdf_fwd), _sg(pdf_rev)


def _textured_params(view: SceneView, mat_id: Array, uv) -> BsdfParams:
    """Material params with diffuse/specular texture modulation at uv —
    BPT's analog of PT's textured shading path (pt.py:300-317; the
    reference's BPT shades through the same TextureView lookups its PT
    does). BPT carries no ray cones, so lookups read mip level 0.

    uv: (N, 2) array or an (u, v) pair of (N,) arrays.
    """
    mats = view.mesh.materials.gather(mat_id)
    params = BsdfParams.from_materials(mats)
    if view.has_textures:
        from fermat_tpu.scene.textures import modulate

        if isinstance(uv, tuple):
            uu, vv = uv
        else:
            uu, vv = uv[:, 0], uv[:, 1]
        rgba_d = view.textures.sample(mats.diffuse_map, uu, vv, None)
        rgba_s = view.textures.sample(mats.specular_map, uu, vv, None)
        params = params._replace(
            diffuse=modulate(params.diffuse, rgba_d),
            specular=modulate(params.specular, rgba_s),
        )
    return params


def _adjoint_corr(wi: Vec3, wo: Vec3, sn: Vec3, gn: Vec3) -> Array:
    """Veach eq. 5.19 importance-transport correction for shading normals:
    |wi.sn * wo.gn| / |wi.gn * wo.sn|, applied wherever a BSDF scatters
    LIGHT-subpath energy (the reference's TransportType::Importance path).
    Clamped to suppress the classic grazing-angle fireflies (Veach 5.3.4
    discusses the unbounded ratio)."""
    num = jnp.abs(dot(wi, sn) * dot(wo, gn))
    den = jnp.maximum(jnp.abs(dot(wi, gn) * dot(wo, sn)), 1e-8)
    return jnp.minimum(num / den, 8.0)


def render_pass(
    view: SceneView,
    opts: BPTOptions,
    res_x: int,
    res_y: int,
    instance: Array,
    seed: int = 0,
    pix: Array = None,
    sequence=None,
    return_splat_list: bool = False,
):
    """One BPT pass: light subpaths + eye subpaths + connections + splats.

    Returns (per-lane eye-strategy radiance Vec3, (H*W,3) light-tracing splat
    image, rays counter). `sequence` overrides the QMC sampler (PSSMLT feeds
    a MatrixSequence of chain-controlled primary coordinates, the
    PerturbedPrimaryCoords analog, bpt_samplers.h:90-121). With
    `return_splat_list`, also returns the raw per-lane light-tracing splats
    as (pix (N, L-1) i32, rgb (N, L-1, 3)) so MCMC samplers can carry a
    path's full contribution set through accept/reject.
    """
    if pix is None:
        pix = jnp.arange(res_x * res_y, dtype=jnp.uint32)
    n = pix.shape[0]
    L = opts.max_path_length
    eps = opts.ray_eps
    seq = (
        sequence
        if sequence is not None
        else TiledSequence.create(seed=seed).set_instance(instance)
    )
    pt_opts = PTOptions(tracer=opts.tracer)
    closest, anyhit = _pick_tracers(view, pt_opts)
    cam_sampler = CameraSampler.create(view.camera, res_x / res_y)
    n_rays = jnp.zeros((), jnp.float32)

    # -------------------------------------------------------------------
    # Phase 1: light subpaths (bpt_control.h:312-374)
    # -------------------------------------------------------------------
    u0, u1 = seq.sample_2d(pix, jnp.uint32(100))
    u2 = seq.sample_1d(pix, jnp.uint32(102))
    if view.has_textures:
        # textured emitters: radiance modulated by the emissive map at the
        # sampled point (matches PT's NEE, pt.py:424-432)
        from fermat_tpu.scene.textures import modulate as _mod_le

        (lpos, ln, lle, lpdf_a, ltri, lu, lvv, lemap) = view.lights.sample_ex(
            view.mesh, u0, u1, u2)
        lle = _mod_le(lle, view.textures.sample(lemap, lu, lvv, None))
    else:
        lpos, ln, lle, lpdf_a, ltri = view.lights.sample(view.mesh, u0, u1, u2)
    has_light = view.lights.has_lights & (lpdf_a > 0.0)

    # emission direction: cosine-hemisphere about the light normal
    ue0, ue1 = seq.sample_2d(pix, jnp.uint32(103))
    d_loc = square_to_cosine_hemisphere(ue0, ue1)
    lt, lb = orthonormal_basis(ln)
    d0 = to_world(d_loc, lt, lb, ln)
    cos_emit = jnp.maximum(d_loc.z, 1e-8)
    pdf_emit_w = cos_emit * INV_PI  # EDF direction pdf (lambert_edf.h:105)
    pdf_emit = _sg(lpdf_a * pdf_emit_w)  # full emission pdf (area x sr)
    pdf_direct = _sg(lpdf_a)  # pdf of NEE sampling this point

    # initial throughput: Le * cos / pdf_emit
    inv_pe = jnp.where(has_light, 1.0 / jnp.maximum(pdf_emit, 1e-20), 0.0)
    thr = Vec3(lle.x * cos_emit * inv_pe, lle.y * cos_emit * inv_pe, lle.z * cos_emit * inv_pe)
    # SmallVCM light-state init
    d_vcm = _mis(pdf_direct / jnp.maximum(pdf_emit, 1e-20))
    d_vc = _mis(cos_emit / jnp.maximum(pdf_emit, 1e-20))

    o = _offset_origin(lpos, ln, d0, eps)
    d = d0
    alive = has_light

    empty = jnp.zeros((n, L), jnp.float32)
    lv = LightVertices(
        px=empty, py=empty, pz=empty, nx=empty, ny=empty, nz=empty,
        gnx=empty, gny=empty, gnz=empty,
        wix=empty, wiy=empty, wiz=empty,
        thr_x=empty, thr_y=empty, thr_z=empty,
        d_vcm=empty, d_vc=empty,
        mat=jnp.zeros((n, L), jnp.int32),
        uvx=empty, uvy=empty,
        valid=jnp.zeros((n, L), bool),
    )

    def set_slot(lv: LightVertices, j: int, **kw) -> LightVertices:
        upd = {}
        for k, v in kw.items():
            upd[k] = getattr(lv, k).at[:, j].set(v)
        return lv._replace(**upd)

    for j in range(L - 1):  # light subpath has at most L vertices incl. y0
        hit = closest(o, d, jnp.float32(eps), jnp.float32(3.0e38), alive)
        n_rays = n_rays + jnp.sum(alive.astype(jnp.float32))
        valid = alive & hit.hit_mask
        tri_c = jnp.maximum(hit.tri, 0)
        pos, gn, sn, uv, mat_id = view.mesh.interpolate(tri_c, hit.u, hit.v)
        wi = -d
        flip = jnp.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        gn_f = gn * flip
        sn_f = sn * flip
        cos_in = jnp.maximum(jnp.abs(dot(sn_f, wi)), 1e-8)
        t_safe = jnp.where(valid, hit.t, 1.0)
        # hit update (SmallVCM): dVCM *= d^2; both /= cosIn
        dv_vcm = d_vcm * _mis(t_safe * t_safe) / _mis(cos_in)
        dv_vc = d_vc / _mis(cos_in)

        lv = set_slot(
            lv, j,
            px=jnp.where(valid, pos.x, 0.0), py=jnp.where(valid, pos.y, 0.0),
            pz=jnp.where(valid, pos.z, 0.0),
            nx=jnp.where(valid, sn_f.x, 0.0), ny=jnp.where(valid, sn_f.y, 0.0),
            nz=jnp.where(valid, sn_f.z, 0.0),
            gnx=jnp.where(valid, gn_f.x, 0.0), gny=jnp.where(valid, gn_f.y, 0.0),
            gnz=jnp.where(valid, gn_f.z, 0.0),
            wix=jnp.where(valid, wi.x, 0.0), wiy=jnp.where(valid, wi.y, 0.0),
            wiz=jnp.where(valid, wi.z, 0.0),
            thr_x=jnp.where(valid, thr.x, 0.0), thr_y=jnp.where(valid, thr.y, 0.0),
            thr_z=jnp.where(valid, thr.z, 0.0),
            d_vcm=jnp.where(valid, dv_vcm, 0.0), d_vc=jnp.where(valid, dv_vc, 0.0),
            mat=jnp.where(valid, mat_id, 0),
            uvx=jnp.where(valid, uv[:, 0], 0.0),
            uvy=jnp.where(valid, uv[:, 1], 0.0),
            valid=valid,
        )

        # scatter continuation
        t_b, b_b = orthonormal_basis(sn_f)
        wi_loc = to_local(wi, t_b, b_b, sn_f)
        params = _textured_params(view, mat_id, uv)
        ub0, ub1, ub2 = seq.sample_3d(pix, jnp.uint32(110 + j * opts.dims_per_bounce))
        s = bsdf_sample(params, wi_loc, ub0, ub1, ub2, opts.lobes)
        # reverse pdf of the chosen direction (for the recursion)
        _, pdf_rev = f_and_pdf(params, s.wo, wi_loc, opts.lobes)
        pdf_rev = _sg(pdf_rev)
        cos_out = jnp.maximum(jnp.abs(s.wo.z), 1e-8)
        pdf_fwd = _sg(jnp.maximum(s.pdf, 1e-20))
        new_d_vc = _mis(cos_out / pdf_fwd) * (dv_vc * _mis(pdf_rev) + dv_vcm)
        new_d_vcm = _mis(1.0 / pdf_fwd)
        d_vc = new_d_vc
        d_vcm = new_d_vcm
        wo_world = to_world(s.wo, t_b, b_b, sn_f)
        # adjoint shading-normal correction for importance transport
        adj = _adjoint_corr(wi, wo_world, sn_f, gn_f)
        thr = Vec3(thr.x * s.g.x * adj, thr.y * s.g.y * adj, thr.z * s.g.z * adj)
        alive = valid & s.valid
        thr = Vec3(
            jnp.where(alive, thr.x, 0.0),
            jnp.where(alive, thr.y, 0.0),
            jnp.where(alive, thr.z, 0.0),
        )
        o = _offset_origin(pos, gn, wo_world, eps)
        d = wo_world

    # -------------------------------------------------------------------
    # Phase 2: light tracing — connect stored vertices to the camera
    # (bpt_control.h:575-598, bpt_kernels.h:1084; atomic splat sink)
    # -------------------------------------------------------------------
    splat = jnp.zeros((res_x * res_y, 3), jnp.float32)
    splat_pix_list = []
    splat_rgb_list = []
    if opts.light_tracing:
        eye = view.camera.eye
        for j in range(L - 1):
            (vp, vn, vgn, vwi, vthr, v_vcm, v_vc, vmat, vuv,
             vvalid) = lv.at_slot(j)
            to_cam = Vec3(eye.x - vp.x, eye.y - vp.y, eye.z - vp.z)
            dist2 = jnp.maximum(dot(to_cam, to_cam), 1e-12)
            dist = jnp.sqrt(dist2)
            wo = to_cam * (1.0 / dist)
            # image coordinates
            ix, iy = cam_sampler.invert(-wo)
            on_screen = (ix >= 0.0) & (ix < 1.0) & (iy >= 0.0) & (iy < 1.0)
            px_i = jnp.clip((ix * res_x).astype(jnp.int32), 0, res_x - 1)
            py_i = jnp.clip((iy * res_y).astype(jnp.int32), 0, res_y - 1)
            pixel = py_i * res_x + px_i
            t_b, b_b = orthonormal_basis(vn)
            wi_loc = to_local(vwi, t_b, b_b, vn)
            wo_loc = to_local(wo, t_b, b_b, vn)
            params = _textured_params(view, vmat, vuv)
            f, pdf_fwd, pdf_rev = _eval_both(params, wi_loc, wo_loc, opts.lobes)
            # importance transport through this vertex -> adjoint correction
            adj = _adjoint_corr(vwi, wo, vn, vgn)
            f = Vec3(f.x * adj, f.y * adj, f.z * adj)
            cos_cam = jnp.abs(wo_loc.z)
            # Unit scheme: the camera direction pdf is normalized over the
            # whole screen; with N_light_paths == N_pixels the pixel-count
            # factors cancel everywhere (cf. SmallVCM's pixel-unit scheme
            # where cameraPdfA carries n_pix and is divided by path count).
            # Area pdf of the EYE strategy generating this vertex:
            #   cameraPdfA = pdfW_screen * cosToCam / d^2
            cam_pdf_a = _sg(cam_sampler.pdf(-wo, projected=False) * cos_cam / dist2)
            # splat estimator: thr * f * cameraPdfA
            scale = cam_pdf_a
            able = vvalid & on_screen & (cos_cam > 1e-6) & ((f.x + f.y + f.z) > 0.0)
            so = _offset_origin(vp, vgn, wo, eps)
            occluded = anyhit(so, wo, jnp.float32(0.0), dist * (1.0 - 1e-3), able)
            n_rays = n_rays + jnp.sum(able.astype(jnp.float32))
            lit = able & ~occluded
            # MIS: against all eye-side strategies
            w_light = _mis(cam_pdf_a) * (v_vcm + v_vc * _mis(pdf_rev))
            w = 1.0 / (w_light + 1.0)
            amp = jnp.where(lit, scale * w, 0.0)
            cx = vthr.x * f.x * amp
            cy = vthr.y * f.y * amp
            cz = vthr.z * f.z * amp
            rgb = jnp.stack([cx, cy, cz], axis=-1)
            splat = splat.at[pixel].add(rgb, mode="drop")
            splat_pix_list.append(jnp.where(lit, pixel, -1))
            splat_rgb_list.append(rgb)

    # -------------------------------------------------------------------
    # Phase 3: eye subpaths + s=0 / s=1 / connections
    # (bpt_control.h:433-511)
    # -------------------------------------------------------------------
    jx, jy = seq.sample_2d(pix, jnp.uint32(0))
    o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy, pix)
    # eye-state init: dVCM = 1 / pdfW_screen (the n_paths/cameraPdfW of
    # SmallVCM with both expressed per-pixel — counts cancel, see above)
    cam_pdf_w = _sg(cam_sampler.pdf(d, projected=False))
    d_vcm = _mis(1.0 / jnp.maximum(cam_pdf_w, 1e-20))
    d_vc = jnp.zeros(n, jnp.float32)
    thr = Vec3.full((n,), 1.0, 1.0, 1.0)
    alive = jnp.ones(n, bool)
    radiance = Vec3.zeros((n,))

    for t_idx in range(L - 1):  # eye vertices x1.. (t = t_idx + 2 incl camera)
        hit = closest(o, d, jnp.float32(eps), jnp.float32(3.0e38), alive)
        n_rays = n_rays + jnp.sum(alive.astype(jnp.float32))
        valid = alive & hit.hit_mask
        # escaped eye rays pick up the environment (weight 1: no light
        # subpath can start at infinity, so no competing strategy exists;
        # the reference stubs this out at bpt_kernels.h:905)
        from fermat_tpu.scene.envmap import scene_env_radiance

        missed = alive & ~hit.hit_mask
        env_l = scene_env_radiance(view, Vec3(d.x, d.y, d.z))
        radiance = Vec3(
            radiance.x + jnp.where(missed, thr.x * env_l.x, 0.0),
            radiance.y + jnp.where(missed, thr.y * env_l.y, 0.0),
            radiance.z + jnp.where(missed, thr.z * env_l.z, 0.0),
        )
        tri_c = jnp.maximum(hit.tri, 0)
        pos, gn, sn, uv, mat_id = view.mesh.interpolate(tri_c, hit.u, hit.v)
        wi = -d
        flip = jnp.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        gn_f = gn * flip
        sn_f = sn * flip
        cos_in = jnp.maximum(jnp.abs(dot(sn_f, wi)), 1e-8)
        t_safe = jnp.where(valid, hit.t, 1.0)
        d_vcm = d_vcm * _mis(t_safe * t_safe) / _mis(cos_in)
        d_vc = d_vc / _mis(cos_in)

        t_b, b_b = orthonormal_basis(sn_f)
        wi_loc = to_local(wi, t_b, b_b, sn_f)
        params = _textured_params(view, mat_id, uv)

        # ---- s=0: emissive hit (SmallVCM GetLightRadiance) ----
        le = _emissive_of(view.mesh, mat_id)
        if view.has_textures:
            from fermat_tpu.scene.textures import modulate as _mod

            emap = view.mesh.materials.gather(mat_id).emissive_map
            rgba_e = view.textures.sample(emap, uv[:, 0], uv[:, 1], None)
            le = _mod(le, rgba_e)
        is_emitter = (le.x + le.y + le.z) > 0.0
        front = dot(gn, wi) > 0.0
        pdf_direct_a = _sg(view.lights.pdf_area_of(tri_c))
        cos_l = jnp.maximum(dot(gn, wi), 1e-8)
        pdf_emit = _sg(pdf_direct_a * cos_l * INV_PI)
        if t_idx == 0:
            w = jnp.ones(n, jnp.float32)
        else:
            w_cam = _mis(pdf_direct_a) * d_vcm + _mis(pdf_emit) * d_vc
            w = 1.0 / (1.0 + w_cam)
        m = valid & is_emitter & front
        radiance = Vec3(
            radiance.x + jnp.where(m, thr.x * le.x * w, 0.0),
            radiance.y + jnp.where(m, thr.y * le.y * w, 0.0),
            radiance.z + jnp.where(m, thr.z * le.z * w, 0.0),
        )

        # ---- s=1: NEE (SmallVCM DirectIllumination) ----
        un0, un1 = seq.sample_2d(pix, jnp.uint32(200 + t_idx * opts.dims_per_bounce))
        un2 = seq.sample_1d(pix, jnp.uint32(202 + t_idx * opts.dims_per_bounce))
        if view.has_textures:
            from fermat_tpu.scene.textures import modulate as _mod_ne

            (spos, snl, sle, spdf_a, _stri, su, sv, semap) = (
                view.lights.sample_ex(view.mesh, un0, un1, un2))
            sle = _mod_ne(sle, view.textures.sample(semap, su, sv, None))
        else:
            spos, snl, sle, spdf_a, _stri = view.lights.sample(
                view.mesh, un0, un1, un2)
        to_l = spos - pos
        ldist2 = jnp.maximum(dot(to_l, to_l), 1e-12)
        ldist = jnp.sqrt(ldist2)
        wo = to_l * (1.0 / ldist)
        cos_at_light = dot(snl, -wo)
        wo_loc = to_local(wo, t_b, b_b, sn_f)
        f, pdf_fwd, pdf_rev = _eval_both(params, wi_loc, wo_loc, opts.lobes)
        cos_here = jnp.abs(wo_loc.z)
        pdf_light_sa = _sg(spdf_a * ldist2 / jnp.maximum(jnp.abs(cos_at_light), 1e-8))
        w_light = _mis(pdf_fwd / jnp.maximum(pdf_light_sa, 1e-20))
        # wCamera = Mis(emissionPdfW * cosHere / (directPdfW * cosAtLight))
        #           * (dVCM + dVC * Mis(bsdfRevPdfW))
        # with directPdfW = pdf_light_sa (sr), emissionPdfW = spdf_a * cos/pi
        emis_full = _sg(spdf_a * jnp.maximum(cos_at_light, 0.0) * INV_PI)
        w_cam = _mis(
            emis_full * cos_here /
            (jnp.maximum(pdf_light_sa, 1e-20) * jnp.maximum(jnp.abs(cos_at_light), 1e-8))
        ) * (d_vcm + d_vc * _mis(pdf_rev))
        w = 1.0 / (w_light + 1.0 + w_cam)
        able = (
            valid
            & view.lights.has_lights
            & (cos_at_light > 1e-6)
            & (spdf_a > 0.0)
            & ((f.x + f.y + f.z) > 0.0)
        )
        so = _offset_origin(pos, gn, wo, eps)
        occluded = anyhit(so, wo, jnp.float32(0.0), ldist * (1.0 - 1e-3), able)
        n_rays = n_rays + jnp.sum(able.astype(jnp.float32))
        lit = able & ~occluded
        scale = cos_here * w / jnp.maximum(pdf_light_sa, 1e-20)
        radiance = Vec3(
            radiance.x + jnp.where(lit, thr.x * f.x * sle.x * scale, 0.0),
            radiance.y + jnp.where(lit, thr.y * f.y * sle.y * scale, 0.0),
            radiance.z + jnp.where(lit, thr.z * f.z * sle.z * scale, 0.0),
        )

        # ---- s>=2: vertex connections (SmallVCM ConnectVertices) ----
        for j in range(L - 1):
            (vp, vn, vgn, vwi, vthr, v_vcm, v_vc, vmat, vuv,
             vvalid) = lv.at_slot(j)
            conn = vp - pos
            cdist2 = jnp.maximum(dot(conn, conn), 1e-12)
            cdist = jnp.sqrt(cdist2)
            cdir = conn * (1.0 / cdist)
            # eye-side bsdf
            co_loc = to_local(cdir, t_b, b_b, sn_f)
            fe, pdf_e_fwd, pdf_e_rev = _eval_both(params, wi_loc, co_loc, opts.lobes)
            cos_e = jnp.abs(co_loc.z)
            # light-side bsdf
            lt_b, lb_b = orthonormal_basis(vn)
            lwi_loc = to_local(vwi, lt_b, lb_b, vn)
            lwo_loc = to_local(-cdir, lt_b, lb_b, vn)
            lparams = _textured_params(view, vmat, vuv)
            fl, pdf_l_fwd, pdf_l_rev = _eval_both(lparams, lwi_loc, lwo_loc, opts.lobes)
            # light-side scatter = importance transport -> adjoint correction
            ladj = _adjoint_corr(vwi, -cdir, vn, vgn)
            fl = Vec3(fl.x * ladj, fl.y * ladj, fl.z * ladj)
            cos_lv = jnp.abs(lwo_loc.z)
            g = cos_e * cos_lv / cdist2
            # area pdfs of generating the other vertex
            pdf_e_fwd_a = _sg(pdf_e_fwd * cos_lv / cdist2)
            pdf_l_fwd_a = _sg(pdf_l_fwd * cos_e / cdist2)
            w_light = _mis(pdf_e_fwd_a) * (v_vcm + v_vc * _mis(pdf_l_rev))
            w_cam = _mis(pdf_l_fwd_a) * (d_vcm + d_vc * _mis(pdf_e_rev))
            w = 1.0 / (w_light + 1.0 + w_cam)
            able = (
                valid & vvalid & (g > 0.0)
                & ((fe.x + fe.y + fe.z) > 0.0)
                & ((fl.x + fl.y + fl.z) > 0.0)
            )
            so = _offset_origin(pos, gn_f, cdir, eps)
            occluded = anyhit(so, cdir, jnp.float32(0.0), cdist * (1.0 - 1e-3), able)
            n_rays = n_rays + jnp.sum(able.astype(jnp.float32))
            lit = able & ~occluded
            amp = jnp.where(lit, g * w, 0.0)
            radiance = Vec3(
                radiance.x + thr.x * fe.x * vthr.x * fl.x * amp,
                radiance.y + thr.y * fe.y * vthr.y * fl.y * amp,
                radiance.z + thr.z * fe.z * vthr.z * fl.z * amp,
            )

        # ---- continue the eye walk ----
        ub0, ub1, ub2 = seq.sample_3d(pix, jnp.uint32(300 + t_idx * opts.dims_per_bounce))
        s = bsdf_sample(params, wi_loc, ub0, ub1, ub2, opts.lobes)
        _, pdf_rev_w = f_and_pdf(params, s.wo, wi_loc, opts.lobes)
        pdf_rev_w = _sg(pdf_rev_w)
        cos_out = jnp.maximum(jnp.abs(s.wo.z), 1e-8)
        pdf_fwd_w = _sg(jnp.maximum(s.pdf, 1e-20))
        new_d_vc = _mis(cos_out / pdf_fwd_w) * (d_vc * _mis(pdf_rev_w) + d_vcm)
        d_vcm = _mis(1.0 / pdf_fwd_w)
        d_vc = new_d_vc
        wo_world = to_world(s.wo, t_b, b_b, sn_f)
        thr = Vec3(thr.x * s.g.x, thr.y * s.g.y, thr.z * s.g.z)
        alive = valid & s.valid
        thr = Vec3(
            jnp.where(alive, thr.x, 0.0),
            jnp.where(alive, thr.y, 0.0),
            jnp.where(alive, thr.z, 0.0),
        )
        o = _offset_origin(pos, gn, wo_world, eps)
        d = wo_world

    # env tail: the eye loop traces L-1 segments, so the escape ray off
    # the LAST eye vertex is otherwise never traced and env-lit surfaces
    # go dark. One extra any-env trace, statically skipped for env-free
    # scenes (zero cost on the common path).
    if opts.env_tail is not None:
        has_env = bool(opts.env_tail)
    elif view.env_map is not None:
        has_env = True
    else:
        try:
            has_env = bool(
                (np.asarray(jax.device_get(view.env)) != 0.0).any())
        except Exception:
            # traced constant env (sharded pass / grad): resolve OFF so
            # jitted and closure-traced passes stay bit-identical; use
            # env_tail=True to opt in
            has_env = False
    if has_env:
        from fermat_tpu.scene.envmap import scene_env_radiance

        hit_t = closest(o, d, jnp.float32(eps), jnp.float32(3.0e38), alive)
        n_rays = n_rays + jnp.sum(alive.astype(jnp.float32))
        missed_t = alive & ~hit_t.hit_mask
        env_t = scene_env_radiance(view, Vec3(d.x, d.y, d.z))
        radiance = Vec3(
            radiance.x + jnp.where(missed_t, thr.x * env_t.x, 0.0),
            radiance.y + jnp.where(missed_t, thr.y * env_t.y, 0.0),
            radiance.z + jnp.where(missed_t, thr.z * env_t.z, 0.0),
        )

    if return_splat_list:
        if splat_pix_list:
            sp = jnp.stack(splat_pix_list, axis=1)
            sr = jnp.stack(splat_rgb_list, axis=1)
        else:
            sp = jnp.full((n, 0), -1, jnp.int32)
            sr = jnp.zeros((n, 0, 3), jnp.float32)
        return radiance, splat, n_rays, sp, sr
    return radiance, splat, n_rays


def render_pass_fb(
    view: SceneView,
    opts: BPTOptions,
    res_x: int,
    res_y: int,
    instance: Array,
    seed: int = 0,
    pix: Array = None,
):
    """Framebuffer-shaped adapter (context registry entry, like PT's pass).

    Eye-strategy radiance + light-tracing splats land in COMPOSITED (the
    reference's BPT also composites all strategies into one channel,
    bpt_impl.h:196-260); gbuffer fields are empty.
    """
    from fermat_tpu.integrators.pt import _PassOutput

    rad, splat, n_rays = render_pass(view, opts, res_x, res_y, instance, seed, pix)
    n = rad.x.shape[0]
    if pix is None:
        pix_idx = jnp.arange(n)
    else:
        pix_idx = pix.astype(jnp.int32)
    comp = Vec3(
        rad.x + splat[pix_idx, 0],
        rad.y + splat[pix_idx, 1],
        rad.z + splat[pix_idx, 2],
    )
    zero3 = Vec3.zeros((n,))
    return _PassOutput(
        direct=zero3,
        diffuse=zero3,
        specular=zero3,
        composited=comp,
        diffuse_albedo=zero3,
        specular_albedo=zero3,
        depth=jnp.full(n, jnp.inf, jnp.float32),
        tri=jnp.full(n, -1, jnp.int32),
        normal=zero3,
        position=zero3,
        uv=jnp.zeros((n, 2), jnp.float32),
        material=jnp.full(n, -1, jnp.int32),
        rays=n_rays,
    )
