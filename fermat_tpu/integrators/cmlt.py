"""CMLT — charted Metropolis light transport (Pantaleoni 2017).

Reference analogs: src/renderers/cmlt.{h,cu} —
  * chains live in PRIMARY SAMPLE SPACE PER (s,t) CHART: each chain carries
    a light-subpath coordinate vector u_L, an eye-subpath vector u_E, and a
    chart label (s,t) with s+t-1 = path segments (cmlt.cu:93-150 CMLTContext
    u_L/u_E/st state),
  * within-chart mutations are Kelemen perturbations re-traced through the
    bidirectional evaluator (cmlt.cu perturbations via PerturbedPrimaryCoords),
  * CHART SWAPS re-express the SAME path in a neighbouring chart by
    inverting the scatter decisions that change sides, accepting with the
    inversion-pdf ratio (chart_swap_kernel cmlt.cu:559-680; the +-1
    random-walk-on-s proposal implemented here is the reference's own
    alternative at cmlt.cu:580-582, which avoids the st_norms CDF while
    keeping the chart chain ergodic over s at fixed path length),
  * seeding follows pssmlt: uniform candidates, luminance-proportional
    chart+coordinate resampling, global image brightness b as the MH
    normalization (cmlt.cu:687-714 sample_seeds + st counters).

Shape: chains = lanes; one jitted step per pass. The evaluator
traces the light subpath to its maximum stored depth and the eye subpath to
max_path_length with explicit per-slot records (vertex ids, throughputs,
SmallVCM dVCM/dVC MIS accumulators, incoming pdfs), then SELECTS the
per-lane (s,t) end vertices with masked one-hot selects and performs a
single connection + shadow ray. All strategy math matches integrators/mlt.py
(validated by MLT-vs-PT convergence); the swap-move inversions come from
fermat_tpu.bsdf.inversion (path_inversion.h analog).

Acceptance for a swap uses the true luminance ratio of the re-expressed
path (the proposal is re-traced anyway) times the moved decision's density
ratio in area measure times the +-1 proposal asymmetry:

    a = [lum' / lum] * [pdf_removed / pdf_added] * [P_rev / P_fwd]

which is the chart_swap acceptance (cmlt.cu:628-633) with the re-traced
luminance ratio standing in for the reference's st_norms expectation ratio.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from fermat_tpu.bsdf.composite import (
    BsdfParams,
    f_and_pdf,
    sample as bsdf_sample,
)
from fermat_tpu.bsdf import inversion as binv
from fermat_tpu.core.camera import CameraSampler
from fermat_tpu.core.math import (
    Vec3,
    dot,
    normalize,
    orthonormal_basis,
    to_local,
    to_world,
)
from fermat_tpu.core.rng import hash_combine, uniform_from_bits, _u32
from fermat_tpu.core.sampling import (
    INV_PI,
    square_to_cosine_hemisphere,
    square_to_uniform_triangle,
)
from fermat_tpu.integrators.bpt import _eval_both
from fermat_tpu.integrators.mlt import _sel_a, _sel_v, _where3, _lum
from fermat_tpu.integrators.pt import _offset_origin, _pick_tracers, PTOptions
from fermat_tpu.scene.lights import _emissive_of
from fermat_tpu.scene.view import SceneView

Array = jax.Array
_sg = jax.lax.stop_gradient
_BIG = 3.0e38
_U32 = jnp.uint32


class CMLTOptions(NamedTuple):
    """cmlt.h:55-128 subset."""

    max_path_length: int = 6  # K: max segments (needs >= 3)
    n_chains: int = 0  # 0 -> one chain per pixel
    swap_frequency: int = 3  # every Nth step proposes a chart swap
    large_step_prob: float = 0.3
    small_step_size: float = 1.0 / 64.0
    # brightness b is the MH normalization: it multiplies the whole image,
    # so its MC error is a uniform image bias (measured: b 13% low at 2
    # rounds on glossy cornell -> image uniformly 12% dim). The (s=0,t=2)
    # visible-emitter chart is heavy-tailed and needs the extra samples.
    n_seed_rounds: int = 8
    lobes: tuple = (True, True, True, True)
    ray_eps: float = 1.0e-4
    tracer: str = "auto"


# coordinate layout ---------------------------------------------------------
# u_L: [0:3] light point pick (bary u0,u1 + CDF u2); [3:5] emission
#      direction; triple j >= 0 at [5+3j : 8+3j] = scatter at y_{j+1}.
# u_E: [0:2] screen uv; triple i >= 0 at [2+3i : 5+3i] = scatter at x_{i+1}.

def _dims_l(K: int) -> int:
    ls = K - 2
    return 5 + 3 * max(ls - 1, 0)


def _dims_e(K: int) -> int:
    return 2 + 3 * (K - 1)


class CMLTState(NamedTuple):
    u_l: Array  # (N, DL)
    u_e: Array  # (N, DE)
    s: Array  # (N,) chart light-vertex count (>= 0)
    t: Array  # (N,) chart eye-vertex count (>= 2)
    lum: Array  # (N,) current path luminance
    contrib: Array  # (N, 3)
    pixel: Array  # (N,)
    brightness: Array  # scalar b
    key: Array  # u32
    step_idx: Array  # u32 step counter (drives swap cadence)


# ---------------------------------------------------------------------------
# Charted bidirectional evaluator
# ---------------------------------------------------------------------------

class _Walk(NamedTuple):
    """Per-slot subpath records (vertex_storage.h analog, slots as python
    lists so downstream selects stay one-hot)."""

    # eye slots i: x_{i+1}
    e_tri: list
    e_u: list
    e_v: list
    e_valid: list
    e_pos: list
    e_gn: list
    e_sn: list
    e_mat: list
    e_wi: list
    e_thr: list
    e_dvcm: list
    e_dvc: list
    e_pdf_in: list  # solid-angle pdf of the decision that made this vertex
    e_cos_in: list  # |dot(sn, wi)|
    e_d2: list  # squared incoming segment length
    e_d: list  # eye-walk direction per step (env escape candidates)
    e_esc: list  # escaped-at-this-step mask
    # light origin y_0
    l0_tri: Array
    l0_pos: Vec3
    l0_n: Vec3
    l0_le: Vec3
    l0_pdf_a: Array
    l0_valid: Array
    # light slots j: y_{j+1}
    l_tri: list
    l_u: list
    l_v: list
    l_valid: list
    l_pos: list
    l_gn: list
    l_sn: list
    l_mat: list
    l_wi: list
    l_thr: list
    l_dvcm: list
    l_dvc: list
    l_pdf_in: list
    l_cos_in: list
    l_d2: list


def _params_of(view, mat_id):
    return BsdfParams.from_materials(view.mesh.materials.gather(mat_id))


def _walk(view: SceneView, opts: CMLTOptions, closest, cam: CameraSampler,
          u_l: Array, u_e: Array):
    """Trace both subpaths to max depth from explicit primary coordinates.

    Mirrors the MLT presample walks (integrators/mlt.py) but driven by the
    chain's own (u_L, u_E) matrices instead of hash-based randoms."""
    K = opts.max_path_length
    ET = K  # eye surface slots x_1..x_K
    LS = K - 2  # light surface slots y_1..y_{K-2}
    n = u_e.shape[0]
    eps = opts.ray_eps
    lobes = opts.lobes
    mesh = view.mesh
    n_rays = jnp.zeros((), jnp.float32)

    # ---- light subpath ----
    lpos, ln, lle, lpdf_a, ltri = view.lights.sample(
        mesh, u_l[:, 0], u_l[:, 1], u_l[:, 2]
    )
    has_light = view.lights.has_lights & (lpdf_a > 0.0)
    d_loc = square_to_cosine_hemisphere(u_l[:, 3], u_l[:, 4])
    lt_, lb_ = orthonormal_basis(ln)
    d = to_world(d_loc, lt_, lb_, ln)
    cos_emit = jnp.maximum(d_loc.z, 1e-8)
    pdf_emit = _sg(lpdf_a * cos_emit * INV_PI)
    pdf_direct = _sg(lpdf_a)
    inv_pe = jnp.where(has_light, 1.0 / jnp.maximum(pdf_emit, 1e-20), 0.0)
    l_thr = Vec3(lle.x * cos_emit * inv_pe, lle.y * cos_emit * inv_pe,
                 lle.z * cos_emit * inv_pe)
    l_dvcm = pdf_direct / jnp.maximum(pdf_emit, 1e-20)
    l_dvc = cos_emit / jnp.maximum(pdf_emit, 1e-20)
    pdf_in_sa = _sg(cos_emit * INV_PI)  # emission direction pdf (solid angle)
    o = _offset_origin(lpos, ln, d, eps)
    alive = has_light

    L = {k: [] for k in ("tri", "u", "v", "valid", "pos", "gn", "sn", "mat",
                         "wi", "thr", "dvcm", "dvc", "pdf_in", "cos_in", "d2")}
    for j in range(LS):
        hit = closest(o, d, jnp.float32(eps), jnp.float32(_BIG), alive)
        n_rays = n_rays + jnp.sum(alive.astype(jnp.float32))
        valid = alive & hit.hit_mask
        tri_c = jnp.maximum(hit.tri, 0)
        pos, gn, sn, _uv, mat_id = mesh.interpolate(tri_c, hit.u, hit.v)
        wi = -d
        flip = jnp.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        gn_f, sn_f = gn * flip, sn * flip
        cos_in = jnp.maximum(jnp.abs(dot(sn_f, wi)), 1e-8)
        t_safe = jnp.where(valid, hit.t, 1.0)
        dvcm = l_dvcm * (t_safe * t_safe) / cos_in
        dvc = l_dvc / cos_in
        L["tri"].append(jnp.where(valid, hit.tri, 0))
        L["u"].append(jnp.where(valid, hit.u, 0.0))
        L["v"].append(jnp.where(valid, hit.v, 0.0))
        L["valid"].append(valid)
        L["pos"].append(pos)
        L["gn"].append(gn_f)
        L["sn"].append(sn_f)
        L["mat"].append(mat_id)
        L["wi"].append(wi)
        L["thr"].append(Vec3(jnp.where(valid, l_thr.x, 0.0),
                             jnp.where(valid, l_thr.y, 0.0),
                             jnp.where(valid, l_thr.z, 0.0)))
        L["dvcm"].append(jnp.where(valid, dvcm, 0.0))
        L["dvc"].append(jnp.where(valid, dvc, 0.0))
        L["pdf_in"].append(pdf_in_sa)
        L["cos_in"].append(cos_in)
        L["d2"].append(jnp.maximum(t_safe * t_safe, 1e-12))
        if j + 1 < LS:
            t_b, b_b = orthonormal_basis(sn_f)
            wi_loc = to_local(wi, t_b, b_b, sn_f)
            p = _params_of(view, mat_id)
            base = 5 + 3 * j
            sm = bsdf_sample(p, wi_loc, u_l[:, base], u_l[:, base + 1],
                             u_l[:, base + 2], lobes)
            _, pdf_rev = f_and_pdf(p, sm.wo, wi_loc, lobes)
            pdf_rev = _sg(pdf_rev)
            cos_out = jnp.maximum(jnp.abs(sm.wo.z), 1e-8)
            pdf_fwd = _sg(jnp.maximum(sm.pdf, 1e-20))
            l_dvc = (cos_out / pdf_fwd) * (dvc * pdf_rev + dvcm)
            l_dvcm = 1.0 / pdf_fwd
            pdf_in_sa = pdf_fwd
            wo_w = to_world(sm.wo, t_b, b_b, sn_f)
            l_thr = Vec3(l_thr.x * sm.g.x, l_thr.y * sm.g.y, l_thr.z * sm.g.z)
            alive = valid & sm.valid
            l_thr = Vec3(jnp.where(alive, l_thr.x, 0.0),
                         jnp.where(alive, l_thr.y, 0.0),
                         jnp.where(alive, l_thr.z, 0.0))
            o = _offset_origin(pos, gn, wo_w, eps)
            d = wo_w

    # ---- eye subpath ----
    d = cam.sample_direction(u_e[:, 0], u_e[:, 1])
    cam_eye = Vec3(
        jnp.broadcast_to(view.camera.eye.x, (n,)),
        jnp.broadcast_to(view.camera.eye.y, (n,)),
        jnp.broadcast_to(view.camera.eye.z, (n,)),
    )
    o = cam_eye
    e_dvcm = jnp.zeros(n, jnp.float32)  # light tracing excluded (mlt.h:77)
    e_dvc = jnp.zeros(n, jnp.float32)
    e_thr = Vec3.full((n,), 1.0, 1.0, 1.0)
    alive = jnp.ones(n, bool)
    pdf_in_sa = jnp.zeros(n, jnp.float32)  # camera slot: unused by swaps
    E = {k: [] for k in ("tri", "u", "v", "valid", "pos", "gn", "sn", "mat",
                         "wi", "thr", "dvcm", "dvc", "pdf_in", "cos_in", "d2",
                         "d", "esc")}
    for i in range(ET):
        hit = closest(o, d, jnp.float32(eps), jnp.float32(_BIG), alive)
        n_rays = n_rays + jnp.sum(alive.astype(jnp.float32))
        valid = alive & hit.hit_mask
        # env-escape record: the eye walk left the scene on segment i+1
        E["d"].append(d)
        E["esc"].append(alive & ~hit.hit_mask)
        tri_c = jnp.maximum(hit.tri, 0)
        pos, gn, sn, _uv, mat_id = mesh.interpolate(tri_c, hit.u, hit.v)
        wi = -d
        flip = jnp.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        gn_f, sn_f = gn * flip, sn * flip
        cos_in = jnp.maximum(jnp.abs(dot(sn_f, wi)), 1e-8)
        t_safe = jnp.where(valid, hit.t, 1.0)
        e_dvcm = e_dvcm * (t_safe * t_safe) / cos_in
        e_dvc = e_dvc / cos_in
        E["tri"].append(jnp.where(valid, hit.tri, 0))
        E["u"].append(jnp.where(valid, hit.u, 0.0))
        E["v"].append(jnp.where(valid, hit.v, 0.0))
        E["valid"].append(valid)
        E["pos"].append(pos)
        E["gn"].append(gn_f)
        E["sn"].append(sn_f)
        E["mat"].append(mat_id)
        E["wi"].append(wi)
        E["thr"].append(Vec3(e_thr.x, e_thr.y, e_thr.z))
        E["dvcm"].append(e_dvcm)
        E["dvc"].append(e_dvc)
        E["pdf_in"].append(pdf_in_sa)
        E["cos_in"].append(cos_in)
        E["d2"].append(jnp.maximum(t_safe * t_safe, 1e-12))
        if i + 1 < ET:
            t_b, b_b = orthonormal_basis(sn_f)
            wi_loc = to_local(wi, t_b, b_b, sn_f)
            p = _params_of(view, mat_id)
            base = 2 + 3 * i
            sm = bsdf_sample(p, wi_loc, u_e[:, base], u_e[:, base + 1],
                             u_e[:, base + 2], lobes)
            _, pdf_rev = f_and_pdf(p, sm.wo, wi_loc, lobes)
            pdf_rev = _sg(pdf_rev)
            cos_out = jnp.maximum(jnp.abs(sm.wo.z), 1e-8)
            pdf_fwd = _sg(jnp.maximum(sm.pdf, 1e-20))
            e_dvc = (cos_out / pdf_fwd) * (e_dvc * pdf_rev + e_dvcm)
            e_dvcm = 1.0 / pdf_fwd
            pdf_in_sa = pdf_fwd
            wo_w = to_world(sm.wo, t_b, b_b, sn_f)
            e_thr = Vec3(e_thr.x * sm.g.x, e_thr.y * sm.g.y, e_thr.z * sm.g.z)
            alive = valid & sm.valid
            e_thr = Vec3(jnp.where(alive, e_thr.x, 0.0),
                         jnp.where(alive, e_thr.y, 0.0),
                         jnp.where(alive, e_thr.z, 0.0))
            o = _offset_origin(pos, gn, wo_w, eps)
            d = wo_w

    rec = _Walk(
        e_tri=E["tri"], e_u=E["u"], e_v=E["v"], e_valid=E["valid"],
        e_pos=E["pos"], e_gn=E["gn"], e_sn=E["sn"], e_mat=E["mat"],
        e_wi=E["wi"], e_thr=E["thr"], e_dvcm=E["dvcm"], e_dvc=E["dvc"],
        e_pdf_in=E["pdf_in"], e_cos_in=E["cos_in"], e_d2=E["d2"],
        e_d=E["d"], e_esc=E["esc"],
        l0_tri=ltri, l0_pos=lpos, l0_n=ln, l0_le=lle, l0_pdf_a=lpdf_a,
        l0_valid=has_light,
        l_tri=L["tri"], l_u=L["u"], l_v=L["v"], l_valid=L["valid"],
        l_pos=L["pos"], l_gn=L["gn"], l_sn=L["sn"], l_mat=L["mat"],
        l_wi=L["wi"], l_thr=L["thr"], l_dvcm=L["dvcm"], l_dvc=L["dvc"],
        l_pdf_in=L["pdf_in"], l_cos_in=L["cos_in"], l_d2=L["d2"],
    )
    return rec, n_rays


def _connect(view: SceneView, opts: CMLTOptions, anyhit, rec: _Walk,
             s, t, n: int):
    """MIS-weighted contribution F_{s,t} of the selected chart per lane.

    s, t may be per-lane int32 arrays (chain eval) or python ints (seeding
    enumeration). Strategy math identical to integrators/mlt.py presample.
    """
    lobes = opts.lobes
    eps = opts.ray_eps
    mesh = view.mesh
    s = jnp.asarray(s, jnp.int32)
    t = jnp.asarray(t, jnp.int32)
    n_rays = jnp.zeros((), jnp.float32)

    i_sel = t - 2  # eye slot of x_{t-1}
    ex_valid = _sel_a(i_sel, [v.astype(jnp.int32) for v in rec.e_valid]) > 0
    ex_tri = _sel_a(i_sel, rec.e_tri)
    ex_pos = _sel_v(i_sel, rec.e_pos)
    ex_gn = _sel_v(i_sel, rec.e_gn)
    ex_sn = _sel_v(i_sel, rec.e_sn)
    ex_mat = _sel_a(i_sel, rec.e_mat)
    ex_wi = _sel_v(i_sel, rec.e_wi)
    ex_thr = _sel_v(i_sel, rec.e_thr)
    ex_dvcm = _sel_a(i_sel, rec.e_dvcm)
    ex_dvc = _sel_a(i_sel, rec.e_dvc)
    et_, eb_ = orthonormal_basis(ex_sn)
    wi_loc = to_local(ex_wi, et_, eb_, ex_sn)
    p_e = _params_of(view, ex_mat)

    is0 = s == 0
    is1 = s == 1
    is2 = s >= 2

    # ---- s = 0: emissive hit at x_{t-1} ----
    le = _emissive_of(mesh, ex_mat)
    front = dot(ex_gn, ex_wi) > 0.0
    pdf_direct_a = _sg(view.lights.pdf_area_of(ex_tri))
    cos_l0 = jnp.maximum(dot(ex_gn, ex_wi), 1e-8)
    pdf_emit_hit = _sg(pdf_direct_a * cos_l0 * INV_PI)
    w_cam0 = pdf_direct_a * ex_dvcm + pdf_emit_hit * ex_dvc
    w0 = jnp.where(t == 2, 1.0, 1.0 / (1.0 + w_cam0))
    m0 = ex_valid & front & ((le.x + le.y + le.z) > 0.0)
    F0 = Vec3(
        jnp.where(m0, ex_thr.x * le.x * w0, 0.0),
        jnp.where(m0, ex_thr.y * le.y * w0, 0.0),
        jnp.where(m0, ex_thr.z * le.z * w0, 0.0),
    )

    # ---- connection target: y_0 (s=1) or y_{s-1} (s>=2) ----
    j_sel = s - 2
    ly_pos = _where3(is2, _sel_v(j_sel, rec.l_pos), rec.l0_pos)
    ly_sn = _where3(is2, _sel_v(j_sel, rec.l_sn), rec.l0_n)
    ly_valid = jnp.where(
        is2, _sel_a(j_sel, [v.astype(jnp.int32) for v in rec.l_valid]) > 0,
        rec.l0_valid,
    )
    conn = ly_pos - ex_pos
    cd2 = jnp.maximum(dot(conn, conn), 1e-12)
    cd = jnp.sqrt(cd2)
    cdir = conn * (1.0 / cd)
    co_loc = to_local(cdir, et_, eb_, ex_sn)
    fe, pdf_e_fwd, pdf_e_rev = _eval_both(p_e, wi_loc, co_loc, lobes)
    cos_e = jnp.abs(co_loc.z)

    # s = 1 weight (mlt.py presample s=1 block)
    cos_at_l = dot(rec.l0_n, -cdir)
    pdf_l_sa = _sg(rec.l0_pdf_a * cd2 / jnp.maximum(jnp.abs(cos_at_l), 1e-8))
    w_light1 = pdf_e_fwd / jnp.maximum(pdf_l_sa, 1e-20)
    emis_full = _sg(rec.l0_pdf_a * jnp.maximum(cos_at_l, 0.0) * INV_PI)
    w_cam1 = (
        emis_full * cos_e
        / (jnp.maximum(pdf_l_sa, 1e-20) * jnp.maximum(jnp.abs(cos_at_l), 1e-8))
    ) * (ex_dvcm + ex_dvc * pdf_e_rev)
    w1 = 1.0 / (w_light1 + 1.0 + w_cam1)
    scale1 = cos_e * w1 / jnp.maximum(pdf_l_sa, 1e-20)
    F1 = Vec3(ex_thr.x * fe.x * rec.l0_le.x * scale1,
              ex_thr.y * fe.y * rec.l0_le.y * scale1,
              ex_thr.z * fe.z * rec.l0_le.z * scale1)
    ok1 = cos_at_l > 1e-6

    # s >= 2 weight (mlt.py presample s>=2 block)
    ly_wi = _sel_v(j_sel, rec.l_wi)
    ly_mat = _sel_a(j_sel, rec.l_mat)
    ly_thr = _sel_v(j_sel, rec.l_thr)
    ly_dvcm = _sel_a(j_sel, rec.l_dvcm)
    ly_dvc = _sel_a(j_sel, rec.l_dvc)
    lt_b, lb_b = orthonormal_basis(ly_sn)
    lwi_loc = to_local(ly_wi, lt_b, lb_b, ly_sn)
    lwo_loc = to_local(-cdir, lt_b, lb_b, ly_sn)
    p_l = _params_of(view, ly_mat)
    fl, pdf_l_fwd, pdf_l_rev = _eval_both(p_l, lwi_loc, lwo_loc, lobes)
    cos_lv = jnp.abs(lwo_loc.z)
    g2 = cos_e * cos_lv / cd2
    pdf_e_fwd_a = _sg(pdf_e_fwd * cos_lv / cd2)
    pdf_l_fwd_a = _sg(pdf_l_fwd * cos_e / cd2)
    w_light2 = pdf_e_fwd_a * (ly_dvcm + ly_dvc * pdf_l_rev)
    w_cam2 = pdf_l_fwd_a * (ex_dvcm + ex_dvc * pdf_e_rev)
    w2 = 1.0 / (w_light2 + 1.0 + w_cam2)
    amp2 = g2 * w2
    F2 = Vec3(ex_thr.x * fe.x * ly_thr.x * fl.x * amp2,
              ex_thr.y * fe.y * ly_thr.y * fl.y * amp2,
              ex_thr.z * fe.z * ly_thr.z * fl.z * amp2)
    ok2 = (g2 > 0.0) & ((fl.x + fl.y + fl.z) > 0.0)

    # one shadow ray for the connection lanes
    need_vis = (~is0) & (s >= 1) & ex_valid & ly_valid \
        & ((fe.x + fe.y + fe.z) > 0.0) & jnp.where(is1, ok1, ok2)
    so = _offset_origin(ex_pos, ex_gn, cdir, eps)
    occ = anyhit(so, cdir, jnp.float32(0.0), cd * (1.0 - 1e-3), need_vis)
    n_rays = n_rays + jnp.sum(need_vis.astype(jnp.float32))
    lit = need_vis & ~occ

    Fc = _where3(is1, F1, F2)
    Fc = _where3(lit, Fc, Vec3.zeros(Fc.x.shape))
    F = _where3(is0, F0, Fc)

    # ---- s = -1: env-terminated eye path (escape on segment t) ----
    # weight 1: no other strategy reaches the infinite light (the chains
    # do no env NEE). BEYOND the reference (env stubbed everywhere).
    is_env = s < 0
    from fermat_tpu.scene.envmap import scene_env_radiance as _env_rad

    i_esc = jnp.clip(t - 1, 0, len(rec.e_esc) - 1)
    esc_ok = _sel_a(i_esc, [v.astype(jnp.int32) for v in rec.e_esc]) > 0
    d_esc = _sel_v(i_esc, rec.e_d)
    thr_esc = _sel_v(i_esc, rec.e_thr)
    e_l = _env_rad(view, d_esc)
    menv = is_env & esc_ok
    F = _where3(
        menv,
        Vec3(thr_esc.x * e_l.x, thr_esc.y * e_l.y, thr_esc.z * e_l.z),
        _where3(is_env, Vec3.zeros(F.x.shape), F),
    )
    # sanitize: dead lanes / inf paths carry exact zero
    good = jnp.isfinite(F.x + F.y + F.z)
    F = Vec3(jnp.where(good, F.x, 0.0), jnp.where(good, F.y, 0.0),
             jnp.where(good, F.z, 0.0))
    return F, n_rays


def _eval_chart(view, opts, closest, anyhit, cam, res_x, res_y, u_l, u_e, s, t):
    """Full charted evaluation -> (contrib (N,3), pixel, rec, n_rays)."""
    rec, nr1 = _walk(view, opts, closest, cam, u_l, u_e)
    n = u_e.shape[0]
    F, nr2 = _connect(view, opts, anyhit, rec, s, t, n)
    px = jnp.clip((u_e[:, 0] * res_x).astype(jnp.int32), 0, res_x - 1)
    py = jnp.clip((u_e[:, 1] * res_y).astype(jnp.int32), 0, res_y - 1)
    pixel = (py * res_x + px).astype(jnp.uint32)
    contrib = jnp.stack([F.x, F.y, F.z], axis=-1)
    return contrib, pixel, rec, nr1 + nr2


# ---------------------------------------------------------------------------
# Seeding (sample_seeds + st counters, cmlt.cu:687-714)
# ---------------------------------------------------------------------------

def init_state(view: SceneView, opts: CMLTOptions, res_x: int, res_y: int,
               n: int, seed: int = 0) -> CMLTState:
    K = opts.max_path_length
    assert K >= 3, "CMLT needs max_path_length >= 3"
    DL, DE = _dims_l(K), _dims_e(K)
    closest, anyhit = _pick_tracers(view, PTOptions(tracer=opts.tracer))
    cam = CameraSampler.create(view.camera, res_x / res_y)
    key0 = _U32((seed * 2654435761 + 777) & 0xFFFFFFFF)
    lane = jnp.arange(n, dtype=_U32)

    best = dict(
        u_l=jnp.zeros((n, DL)), u_e=jnp.zeros((n, DE)),
        s=jnp.zeros(n, jnp.int32), t=jnp.full(n, 2, jnp.int32),
        lum=jnp.full(n, -1.0), contrib=jnp.zeros((n, 3)),
        pixel=jnp.zeros(n, jnp.uint32),
    )
    total = jnp.zeros(())
    charts = [(s_, t_) for t_ in range(2, K + 2) for s_ in range(0, K + 2 - t_)]
    # env-terminated charts: escape on segment t (t surface verts incl.
    # camera... x_1..x_{t-1}; m = t <= K); t = 1 (directly-visible env)
    # stays the additive QMC term of the fb adapter
    charts += [(-1, t_) for t_ in range(2, K + 1)]

    # GLOBAL luminance-proportional seeding (cmlt.cu seeding follows
    # pssmlt.cu:326-345: one CDF over ALL candidate (path, chart) pairs,
    # inverted n times). A per-lane reservoir — the earlier scheme — gives
    # every lane one chain regardless of how bright its candidates are;
    # since mutation-phase chains are FROZEN in their chart, the chart
    # populations never converge to their brightness shares b_k/b and the
    # estimator skews by path class (measured on glossy cornell: charts
    # carrying multi-bounce white light under-populated -> blue channel
    # -33%). Candidate coordinates are re-derived from their counter
    # hashes at pick time so only the (R*C*n,) luminances are stored.
    lum_parts = []
    for r in range(opts.n_seed_rounds):
        def mat(d, tag, r=r):
            ctr = (jax.lax.broadcasted_iota(_U32, (n, d), 0) * _U32(d)
                   + jax.lax.broadcasted_iota(_U32, (n, d), 1))
            return uniform_from_bits(
                hash_combine(hash_combine(key0, _U32(r * 7 + tag)), ctr))

        u_l = mat(DL, 1)
        u_e = mat(DE, 2)
        rec, _nr = _walk(view, opts, closest, cam, u_l, u_e)
        for ci, (s_, t_) in enumerate(charts):
            F, _nr2 = _connect(view, opts, anyhit, rec, s_, t_, n)
            lum = _lum(F.x, F.y, F.z)
            total = total + jnp.mean(lum)
            lum_parts.append(lum)

    lums = jnp.concatenate(lum_parts)  # (R * C * n,)
    c = len(charts)
    cdf = jnp.cumsum(lums)
    tot = jnp.maximum(cdf[-1], 1e-20)
    u_pick = ((jnp.arange(n, dtype=jnp.float32)
               + uniform_from_bits(hash_combine(key0 ^ _U32(0x515CA), lane)))
              / n) * tot
    idx = jnp.clip(jnp.searchsorted(cdf, u_pick, side="left"),
                   0, lums.shape[0] - 1)
    r_idx = (idx // (c * n)).astype(jnp.uint32)
    ci_idx = ((idx // n) % c).astype(jnp.int32)
    lane_idx = (idx % n).astype(jnp.uint32)

    def remat(d, tag):
        ctr = (lane_idx[:, None] * _U32(d)
               + jax.lax.broadcasted_iota(_U32, (n, d), 1))
        seed_r = hash_combine(key0, r_idx * _U32(7) + _U32(tag))
        return uniform_from_bits(hash_combine(seed_r[:, None], ctr))

    u_l_pick = remat(DL, 1)
    u_e_pick = remat(DE, 2)
    s_pick = jnp.asarray([s_ for s_, _ in charts], jnp.int32)[ci_idx]
    t_pick = jnp.asarray([t_ for _, t_ in charts], jnp.int32)[ci_idx]
    contrib, pixel, _rec, _nr = _eval_chart(
        view, opts, closest, anyhit, cam, res_x, res_y,
        u_l_pick, u_e_pick, s_pick, t_pick)
    best = dict(
        u_l=u_l_pick, u_e=u_e_pick, s=s_pick, t=t_pick,
        lum=_lum(contrib[:, 0], contrib[:, 1], contrib[:, 2]),
        contrib=contrib, pixel=pixel,
    )

    brightness = total / opts.n_seed_rounds
    return CMLTState(
        u_l=best["u_l"], u_e=best["u_e"], s=best["s"], t=best["t"],
        lum=jnp.maximum(best["lum"], 0.0), contrib=best["contrib"],
        pixel=best["pixel"], brightness=brightness,
        key=key0 ^ _U32(0x5BD1E995), step_idx=_U32(0),
    )


# ---------------------------------------------------------------------------
# Chain steps
# ---------------------------------------------------------------------------

def _mutate(u: Array, key: Array, opts: CMLTOptions) -> Array:
    """Kelemen mutation (same scheme as pssmlt._mutate)."""
    n, d = u.shape
    ctr = (jax.lax.broadcasted_iota(_U32, (n, d), 0) * _U32(d)
           + jax.lax.broadcasted_iota(_U32, (n, d), 1))
    r1 = uniform_from_bits(hash_combine(key, ctr))
    r2 = uniform_from_bits(hash_combine(key ^ _U32(0x9E3779B9), ctr))
    large = uniform_from_bits(
        hash_combine(key ^ _U32(0x85EBCA6B), jnp.arange(n, dtype=_U32)))
    is_large = (large < opts.large_step_prob)[:, None]
    s1 = 1.0 / 1024.0
    s2 = opts.small_step_size
    mag = s2 * jnp.exp(-jnp.log(s2 / s1) * r1)
    delta = jnp.where(r2 < 0.5, mag, -mag)
    return jnp.where(is_large, r1, jnp.mod(u + delta, 1.0))


def _splat(splat, state, contrib_p, pixel_p, lum_p, a, n):
    """Expected-value accumulation (accept_reject_accumulate analog)."""
    b = state.brightness
    lum_c = jnp.maximum(state.lum, 0.0)
    w_old = jnp.where(lum_c > 0.0, (1.0 - a) * b / jnp.maximum(lum_c, 1e-12), 0.0)
    w_new = jnp.where(lum_p > 0.0, a * b / jnp.maximum(lum_p, 1e-12), 0.0)
    splat = splat.at[state.pixel].add(state.contrib * w_old[:, None], mode="drop")
    splat = splat.at[pixel_p].add(contrib_p * w_new[:, None], mode="drop")
    return splat


def _swap_proposal(view, opts, rec, state, key, n):
    """Build the +-1 chart-swap proposal from the replayed path records.

    Returns (u_l', u_e', s', t', valid, log of density ratio terms):
    pdf_removed / pdf_added (area measure) and P_rev / P_fwd.
    """
    K = opts.max_path_length
    LS = K - 2
    s, t = state.s, state.t
    lane = jnp.arange(n, dtype=_U32)
    u_dir = uniform_from_bits(hash_combine(key ^ _U32(0x51A9C3), lane))
    u_aux1 = uniform_from_bits(hash_combine(key ^ _U32(0x7E1D22), lane))
    u_aux2 = uniform_from_bits(hash_combine(key ^ _U32(0x3C6EF3), lane))

    k_seg = s + t - 1
    can_up = (s >= 0) & (t >= 3) & (s + 1 <= k_seg - 1)  # t' >= 2
    can_dn = s >= 1  # env charts (s == -1) sit swaps out
    go_up = jnp.where(can_up & can_dn, u_dir < 0.5, can_up)
    valid = can_up | can_dn
    p_fwd = jnp.where(can_up & can_dn, 0.5, 1.0)
    s_new = jnp.where(go_up, s + 1, s - 1)
    t_new = jnp.where(go_up, t - 1, t + 1)
    # reverse-proposal probability from (s', t')
    k2 = k_seg
    can_up_r = (t_new >= 3) & (s_new + 1 <= k2 - 1)
    can_dn_r = s_new >= 1
    p_rev = jnp.where(can_up_r & can_dn_r, 0.5, 1.0)
    # the reverse move must be possible at all
    valid = valid & jnp.where(go_up, can_dn_r, can_up_r)

    # --- selected end vertices ---
    i_end = t - 2  # eye slot of x_{t-1}
    ex_pos = _sel_v(i_end, rec.e_pos)
    ex_sn = _sel_v(i_end, rec.e_sn)
    ex_tri = _sel_a(i_end, rec.e_tri)
    ex_u = _sel_a(i_end, rec.e_u)
    ex_v = _sel_a(i_end, rec.e_v)
    ex_wi = _sel_v(i_end, rec.e_wi)
    ex_mat = _sel_a(i_end, rec.e_mat)
    ex_pdf_in = _sel_a(i_end, rec.e_pdf_in)
    ex_cos_in = _sel_a(i_end, rec.e_cos_in)
    ex_d2 = _sel_a(i_end, rec.e_d2)
    ex_valid = _sel_a(i_end, [v.astype(jnp.int32) for v in rec.e_valid]) > 0

    j_end = s - 2  # light slot of y_{s-1} (s >= 2)
    is2 = s >= 2
    ly_pos = _where3(is2, _sel_v(j_end, rec.l_pos), rec.l0_pos)
    ly_sn = _where3(is2, _sel_v(j_end, rec.l_sn), rec.l0_n)
    ly_wi = _sel_v(j_end, rec.l_wi)
    ly_mat = _sel_a(j_end, rec.l_mat)
    ly_pdf_in = _sel_a(j_end, rec.l_pdf_in)
    ly_cos_in = _sel_a(j_end, rec.l_cos_in)
    ly_d2 = _sel_a(j_end, rec.l_d2)
    ly_valid = jnp.where(
        is2, _sel_a(j_end, [v.astype(jnp.int32) for v in rec.l_valid]) > 0,
        rec.l0_valid)

    # old connection segment (the segment that changes generator)
    conn = ly_pos - ex_pos
    cd2 = jnp.maximum(dot(conn, conn), 1e-12)
    cd = jnp.sqrt(cd2)
    cdir = conn * (1.0 / cd)  # x_{t-1} -> y_{s-1}

    u_l_new = state.u_l
    u_e_new = state.u_e

    # ================= +1: x_{t-1} moves to the light side ================
    # removed decision: eye scatter at x_{t-2} -> x_{t-1}
    pdf_rm_up = ex_pdf_in * ex_cos_in / ex_d2
    # added decision: light-side generation of y_{s'} = old x_{t-1}
    #  s == 0 -> light-point pick of its triangle
    pdf_pick = view.lights.pdf_area_of(ex_tri)
    su0 = jnp.clip(1.0 - ex_u, 1e-6, 1.0)
    inv_u0 = su0 * su0
    inv_u1 = jnp.clip(ex_v / su0, 0.0, 1.0)
    cdf = view.lights.cdf
    cdf_hi = cdf[jnp.maximum(ex_tri, 0)]
    cdf_lo = jnp.where(ex_tri > 0, cdf[jnp.maximum(ex_tri - 1, 0)], 0.0)
    inv_u2 = cdf_lo + u_aux1 * jnp.maximum(cdf_hi - cdf_lo, 1e-12)
    ok_pick = pdf_pick > 0.0
    #  s == 1 -> emission direction at y_0 toward x_{t-1}
    lt0, lb0 = orthonormal_basis(rec.l0_n)
    demit_loc = to_local(-cdir, lt0, lb0, rec.l0_n)  # y_0 -> x_{t-1}
    em_u0, em_u1, ok_em = binv.invert_cosine_hemisphere(demit_loc)
    pdf_em_sa = jnp.maximum(demit_loc.z, 0.0) * INV_PI
    #  s >= 2 -> BSDF scatter at y_{s-1} toward x_{t-1}
    lyt, lyb = orthonormal_basis(ly_sn)
    lwi_loc = to_local(ly_wi, lyt, lyb, ly_sn)
    lwo_loc = to_local(-cdir, lyt, lyb, ly_sn)
    inv_l = binv.invert(_params_of(view, ly_mat), lwi_loc, lwo_loc,
                        u_aux1, u_aux2, opts.lobes)
    cos_at_v = jnp.abs(dot(ex_sn, cdir))
    pdf_add_up = jnp.where(
        s == 0, pdf_pick,
        jnp.where(s == 1, pdf_em_sa, inv_l.pdf) * cos_at_v / cd2)
    ok_up = ex_valid & ly_valid & (t >= 3) & jnp.where(
        s == 0, ok_pick, jnp.where(s == 1, ok_em, inv_l.ok))
    # write the new u_L coordinates (masked per s value)
    up = go_up & valid
    w0 = (up & (s == 0))[:, None]
    u_l_new = jnp.where(
        w0 & (jnp.arange(u_l_new.shape[1]) == 0), inv_u0[:, None], u_l_new)
    u_l_new = jnp.where(
        w0 & (jnp.arange(u_l_new.shape[1]) == 1), inv_u1[:, None], u_l_new)
    u_l_new = jnp.where(
        w0 & (jnp.arange(u_l_new.shape[1]) == 2), inv_u2[:, None], u_l_new)
    w1 = (up & (s == 1))[:, None]
    u_l_new = jnp.where(
        w1 & (jnp.arange(u_l_new.shape[1]) == 3), em_u0[:, None], u_l_new)
    u_l_new = jnp.where(
        w1 & (jnp.arange(u_l_new.shape[1]) == 4), em_u1[:, None], u_l_new)
    for j in range(max(LS - 1, 0)):  # scatter at y_{j+1}: s-2 == j
        wj = (up & (s == j + 2))[:, None]
        base = 5 + 3 * j
        dimv = jnp.arange(u_l_new.shape[1])
        u_l_new = jnp.where(wj & (dimv == base), inv_l.u0[:, None], u_l_new)
        u_l_new = jnp.where(wj & (dimv == base + 1), inv_l.u1[:, None], u_l_new)
        u_l_new = jnp.where(wj & (dimv == base + 2), inv_l.u2[:, None], u_l_new)

    # ================= -1: y_{s-1} moves to the eye side ==================
    # removed decision: light-side generation of y_{s-1}
    #  s == 1 -> the light-point pick of y_0
    pdf_rm_dn = jnp.where(
        s == 1, rec.l0_pdf_a, ly_pdf_in * ly_cos_in / ly_d2)
    # added decision: eye scatter at x_{t-1} toward y_{s-1}
    ext, exb = orthonormal_basis(ex_sn)
    ewi_loc = to_local(ex_wi, ext, exb, ex_sn)
    ewo_loc = to_local(cdir, ext, exb, ex_sn)
    inv_e = binv.invert(_params_of(view, ex_mat), ewi_loc, ewo_loc,
                        u_aux1, u_aux2, opts.lobes)
    cos_at_y = jnp.abs(dot(ly_sn, cdir))
    pdf_add_dn = inv_e.pdf * cos_at_y / cd2
    ok_dn = ex_valid & ly_valid & inv_e.ok
    dn = (~go_up) & valid
    for i in range(K - 1):  # scatter at x_{i+1}: t-1 == i+1
        wi_m = (dn & (t == i + 2))[:, None]
        base = 2 + 3 * i
        dimv = jnp.arange(u_e_new.shape[1])
        u_e_new = jnp.where(wi_m & (dimv == base), inv_e.u0[:, None], u_e_new)
        u_e_new = jnp.where(wi_m & (dimv == base + 1), inv_e.u1[:, None], u_e_new)
        u_e_new = jnp.where(wi_m & (dimv == base + 2), inv_e.u2[:, None], u_e_new)

    pdf_removed = jnp.where(go_up, pdf_rm_up, pdf_rm_dn)
    pdf_added = jnp.where(go_up, pdf_add_up, pdf_add_dn)
    ok = valid & jnp.where(go_up, ok_up, ok_dn) & (pdf_added > 1e-30) \
        & jnp.isfinite(pdf_removed) & jnp.isfinite(pdf_added) \
        & (pdf_removed > 0.0)
    ratio = jnp.where(ok, pdf_removed / jnp.maximum(pdf_added, 1e-30)
                      * (p_rev / p_fwd), 0.0)
    return u_l_new, u_e_new, s_new, t_new, ok, ratio


def step(view: SceneView, opts: CMLTOptions, res_x: int, res_y: int,
         state: CMLTState) -> Tuple[CMLTState, Array, Array]:
    """One chain step for all lanes: a Kelemen mutation, or (every
    swap_frequency-th step) a +-1 chart swap. Returns (state, splat, rays)."""
    n = state.u_e.shape[0]
    closest, anyhit = _pick_tracers(view, PTOptions(tracer=opts.tracer))
    cam = CameraSampler.create(view.camera, res_x / res_y)
    key = hash_combine(state.key, _U32(0xA511E9))
    lane = jnp.arange(n, dtype=_U32)
    splat = jnp.zeros((res_x * res_y, 3), jnp.float32)
    if opts.swap_frequency > 0:
        do_swap = (state.step_idx % _U32(opts.swap_frequency)) == _U32(
            opts.swap_frequency - 1)
    else:
        do_swap = jnp.bool_(False)

    K = opts.max_path_length
    charts = [(s_, t_) for t_ in range(2, K + 2) for s_ in range(0, K + 2 - t_)]
    # env-terminated charts: escape on segment t (t surface verts incl.
    # camera... x_1..x_{t-1}; m = t <= K); t = 1 (directly-visible env)
    # stays the additive QMC term of the fb adapter
    charts += [(-1, t_) for t_ in range(2, K + 1)]
    chart_s = jnp.asarray([c_[0] for c_ in charts], jnp.int32)
    chart_t = jnp.asarray([c_[1] for c_ in charts], jnp.int32)

    def mutation_branch(carry):
        state, splat = carry
        u_l_p = _mutate(state.u_l, hash_combine(key, _U32(1)), opts)
        u_e_p = _mutate(state.u_e, hash_combine(key, _U32(2)), opts)
        # chart-resampling large steps: with prob large_step_prob a lane
        # also proposes a uniformly random chart (a symmetric independence
        # move), restoring ergodicity over the chart dimension — without
        # it chains are frozen in their seeded chart between (rare,
        # +-1-only) swaps and the per-chart populations cannot adapt
        big = uniform_from_bits(
            hash_combine(key ^ _U32(0x77AA11), lane)) < opts.large_step_prob
        ci = jnp.minimum(
            (uniform_from_bits(hash_combine(key ^ _U32(0x33CC55), lane))
             * len(charts)).astype(jnp.int32), len(charts) - 1)
        s_p = jnp.where(big, chart_s[ci], state.s)
        t_p = jnp.where(big, chart_t[ci], state.t)
        contrib_p, pixel_p, _rec, nr = _eval_chart(
            view, opts, closest, anyhit, cam, res_x, res_y,
            u_l_p, u_e_p, s_p, t_p)
        lum_p = _lum(contrib_p[:, 0], contrib_p[:, 1], contrib_p[:, 2])
        a = jnp.clip(lum_p / jnp.maximum(state.lum, 1e-12), 0.0, 1.0)
        a = jnp.where(state.lum <= 0.0, 1.0, a)
        splat = _splat(splat, state, contrib_p, pixel_p, lum_p, a, n)
        u_acc = uniform_from_bits(hash_combine(key ^ _U32(0xC2B2AE), lane))
        acc = u_acc < a
        state = state._replace(
            u_l=jnp.where(acc[:, None], u_l_p, state.u_l),
            u_e=jnp.where(acc[:, None], u_e_p, state.u_e),
            s=jnp.where(acc, s_p, state.s),
            t=jnp.where(acc, t_p, state.t),
            lum=jnp.where(acc, lum_p, state.lum),
            contrib=jnp.where(acc[:, None], contrib_p, state.contrib),
            pixel=jnp.where(acc, pixel_p, state.pixel),
        )
        return state, splat, nr

    def swap_branch(carry):
        state, splat = carry
        # replay the current path to recover its vertex records
        _c, _p, rec, nr1 = _eval_chart(
            view, opts, closest, anyhit, cam, res_x, res_y,
            state.u_l, state.u_e, state.s, state.t)
        u_l_p, u_e_p, s_p, t_p, ok, ratio = _swap_proposal(
            view, opts, rec, state, key, n)
        contrib_p, pixel_p, _rec2, nr2 = _eval_chart(
            view, opts, closest, anyhit, cam, res_x, res_y,
            u_l_p, u_e_p, s_p, t_p)
        lum_p = _lum(contrib_p[:, 0], contrib_p[:, 1], contrib_p[:, 2])
        a = jnp.clip(
            lum_p / jnp.maximum(state.lum, 1e-12) * ratio, 0.0, 1.0)
        a = jnp.where(ok & (state.lum > 0.0), a, jnp.where(ok & (lum_p > 0.0), 1.0, 0.0))
        splat = _splat(splat, state, contrib_p, pixel_p, lum_p, a, n)
        u_acc = uniform_from_bits(hash_combine(key ^ _U32(0xC2B2AF), lane))
        acc = u_acc < a
        state = state._replace(
            u_l=jnp.where(acc[:, None], u_l_p, state.u_l),
            u_e=jnp.where(acc[:, None], u_e_p, state.u_e),
            s=jnp.where(acc, s_p, state.s),
            t=jnp.where(acc, t_p, state.t),
            lum=jnp.where(acc, lum_p, state.lum),
            contrib=jnp.where(acc[:, None], contrib_p, state.contrib),
            pixel=jnp.where(acc, pixel_p, state.pixel),
        )
        return state, splat, nr1 + nr2

    state, splat, nr = jax.lax.cond(
        do_swap, swap_branch, mutation_branch, (state, splat))
    state = state._replace(
        key=hash_combine(key, _U32(0xDEADBEEF)),
        step_idx=state.step_idx + _U32(1),
    )
    splat = splat * (res_x * res_y / jnp.float32(n))
    return state, splat, nr
