"""Veach-style path-space Metropolis light transport (MLT).

Reference analogs:
  * src/renderers/mlt_core.h:98 (MLTContext; perturb_secondary_light_vertex
    / perturb_primary_eye_vertex / perturb_secondary_eye_vertex kernels;
    accept_reject_accumulate :261-330 — the Q_old/Q_new factor scheme),
  * src/renderers/mlt_perturbations.h:42-260 — exponential spherical
    perturbation, screen perturbation, H (half-vector) perturbation with its
    geometric densities,
  * src/renderers/mlt.cu:178-360 — BPT presampling, luminance-proportional
    seeding, pdf_norm bookkeeping, chain reseeding,
  * src/path.h Path/BidirPath — explicit vertex-chain storage.

Shape: chains are lanes, one jitted computation per pass:

  1. PRESAMPLE: every chain independently traces one eye subpath and one
     light subpath (BPT-style with the SmallVCM dVCM/dVC MIS recursion;
     light tracing excluded exactly like MLTOptions does — mlt.h:77
     "temporarily kill light tracing" — by zero-initializing the eye dVCM so
     weights renormalize over the available strategies), enumerating every
     (s, t>=2) strategy with at most max_path_length segments.
  2. SEED by per-chain resampled importance sampling (RIS): pick one
     strategy proportional to its MIS-weighted luminance; the chain carries
     weight W = sum of its candidate luminances. This replaces the
     reference's global connections-CDF resampling (mlt.cu:263 sample_seeds)
     with a comm-free per-lane draw — the same start-up-bias-elimination
     argument applies (the weighted seed density is exactly the luminance
     target), and no cross-lane traffic is needed.
  3. CHAIN STEPS (fori_loop): step 0 re-traces the seed with mutations
     disabled (the reference's enable_mutations = chain_step > 0,
     mlt.cu:351) to establish the path value; later steps perturb the
     screen uv + every interior direction (exp spherical or H-perturbation
     per vertex), re-trace the full path, and accept/reject with
     ar = [lum(V_new) * J_new] / [lum(V_old) * J_old], where
     V = prod(f * cos_out) over traced segments x end terms — the exact
     f/T leftover of symmetric direction kernels (the reference's Q_old /
     Q_new accumulation, mlt_core.h:582-603) — and J carries the
     H-perturbation dw/dh geometric densities. Old and new paths both splat
     expected-value contributions (accept_reject_accumulate) via
     deterministic scatter-add.

Normalization: the splat accumulator estimates the whole-image uv integral;
multiplying by n_pixels / (n_chains * steps) puts the output in the same
per-pixel-mean units as the PT/BPT passes (the reference's
pdf_norm = brightness * n_pix / (chain_length * n_chains), mlt.cu:338).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fermat_tpu.bsdf.composite import (
    BsdfParams,
    f as bsdf_f,
    f_and_pdf,
    sample as bsdf_sample,
)
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
    TWO_PI,
    square_to_cosine_hemisphere,
    square_to_uniform_triangle,
)
from fermat_tpu.integrators.pt import _offset_origin, _pick_tracers, PTOptions
from fermat_tpu.scene.lights import _emissive_of
from fermat_tpu.scene.view import SceneView

Array = jax.Array
_sg = jax.lax.stop_gradient
_BIG = 3.0e38


class MLTOptions(NamedTuple):
    """mlt.h:51-130 subset (chains, perturbation mix, radius)."""

    max_path_length: int = 6  # max segments per path (PT-bounce parity)
    n_chains: int = 0  # 0 -> one chain per pixel
    steps_per_pass: int = 12  # chain steps per pass incl. the identity step
    screen_perturbations: float = 1.0  # prob of perturbing the screen point
    exp_perturbations: float = 0.45  # per-vertex spherical perturbation prob
    h_perturbations: float = 0.45  # per-vertex half-vector perturbation prob
    perturbation_radius: float = 0.1
    # every Nth chain step proposes an ST-SWAP instead of a perturbation:
    # re-balance the SAME geometric path between eye and light sides by
    # moving one end vertex across the connection (the reference's swap
    # mutations, mlt_kernels.h / cmlt.cu:559-680). 0 disables.
    st_swap_frequency: int = 4
    lobes: tuple = (True, True, True, True)
    ray_eps: float = 1.0e-4
    tracer: str = "auto"


# ---------------------------------------------------------------------------
# Perturbation kernels (mlt_perturbations.h)
# ---------------------------------------------------------------------------

def bounded_exp_map(u: Array, b1: float, b2: float) -> Array:
    """cugar::Bounded_exponential.map — signed log-uniform magnitude in
    [b1, b2] (distributions.h:234-260)."""
    ln = -jnp.log(b2 / b1)
    return jnp.where(
        u < 0.5,
        b2 * jnp.exp(ln * (0.5 - u) * 2.0),
        -b2 * jnp.exp(ln * (u - 0.5) * 2.0),
    )


def exp_spherical_perturbation(d: Vec3, z0: Array, z1: Array, radius: float) -> Vec3:
    """exponential_spherical_perturbation (mlt_perturbations.h:42-64):
    rotate d by a log-uniform-magnitude angle about a uniform azimuth."""
    nrm = normalize(d)
    t, b = orthonormal_basis(nrm)
    phi = z0 * TWO_PI
    theta = bounded_exp_map(z1, 1.0e-4, radius)
    st = jnp.sin(theta)
    ct = jnp.cos(theta)
    lx = jnp.cos(phi) * st
    ly = jnp.sin(phi) * st
    return normalize(t * lx + b * ly + nrm * ct)


def _microfacet_h(win: Vec3, wout: Vec3, nrm: Vec3, eta: Array) -> Vec3:
    """Recover the microfacet normal mapping `win` to `wout` (cugar
    vndf_microfacet analog). Reflection: H ~ win + wout; transmission:
    Walter's H ~ win + eta * wout, oriented along nrm."""
    refl = (dot(nrm, win) * dot(nrm, wout)) >= 0.0
    h_r = normalize(win + wout)
    h_t = normalize(Vec3(win.x + wout.x * eta, win.y + wout.y * eta,
                         win.z + wout.z * eta))
    h = Vec3(
        jnp.where(refl, h_r.x, h_t.x),
        jnp.where(refl, h_r.y, h_t.y),
        jnp.where(refl, h_r.z, h_t.z),
    )
    flip = jnp.where(dot(h, nrm) < 0.0, -1.0, 1.0)
    return h * flip


def h_perturbation(
    old_in: Vec3, old_out: Vec3, old_n: Vec3, old_eta: Array,
    new_in: Vec3, new_n: Vec3, new_eta: Array,
    z0: Array, z1: Array, radius: float,
) -> Vec3:
    """H_perturbation (mlt_perturbations.h:168-222): perturb the microfacet
    in the old local frame, re-express it in the new frame, regenerate the
    outgoing direction with the OLD scattering mode."""
    o_n = old_n * jnp.where(dot(old_n, old_in) < 0.0, -1.0, 1.0)
    n_n = new_n * jnp.where(dot(new_n, new_in) < 0.0, -1.0, 1.0)
    h = _microfacet_h(old_in, old_out, o_n, old_eta)
    ot, ob = orthonormal_basis(o_n)
    h_loc = to_local(h, ot, ob, o_n)
    h_loc = exp_spherical_perturbation(h_loc, z0, z1, radius)
    nt, nb = orthonormal_basis(n_n)
    h_new = to_world(h_loc, nt, nb, n_n)
    refl = dot(o_n, old_out) >= 0.0
    vh = dot(new_in, h_new)
    refl_dir = h_new * (2.0 * vh) - new_in
    eta = new_eta
    cos_t2 = 1.0 - eta * eta * (1.0 - vh * vh)
    tir = cos_t2 < 0.0
    cos_t = -jnp.where(vh >= 0.0, 1.0, -1.0) * jnp.sqrt(jnp.maximum(cos_t2, 0.0))
    refr_dir = Vec3(
        (eta * vh + cos_t) * h_new.x - eta * new_in.x,
        (eta * vh + cos_t) * h_new.y - eta * new_in.y,
        (eta * vh + cos_t) * h_new.z - eta * new_in.z,
    )
    use_refl = refl | tir
    return normalize(Vec3(
        jnp.where(use_refl, refl_dir.x, refr_dir.x),
        jnp.where(use_refl, refl_dir.y, refr_dir.y),
        jnp.where(use_refl, refl_dir.z, refr_dir.z),
    ))


def h_perturbation_density(win: Vec3, wout: Vec3, nrm: Vec3, eta: Array) -> Array:
    """|dw_o / dH| of the H -> out map (mlt_perturbations.h:226-252)."""
    nn = nrm * jnp.where(dot(nrm, win) < 0.0, -1.0, 1.0)
    refl = (dot(nn, win) * dot(nn, wout)) >= 0.0
    h = _microfacet_h(win, wout, nn, eta)
    voh = dot(win, h)
    loh = dot(wout, h)
    d_refl = 4.0 * jnp.abs(loh)
    inv_eta = 1.0 / jnp.maximum(eta, 1e-8)
    denom = voh + inv_eta * loh
    d_refr = (denom * denom) / jnp.maximum(inv_eta * inv_eta * jnp.abs(loh), 1e-12)
    d = jnp.where(refl, d_refl, d_refr)
    return jnp.where(jnp.isfinite(d) & (d > 0.0), d, 1.0e8)


def _eta_of(p: BsdfParams, nrm: Vec3, win: Vec3) -> Array:
    """Relative IoR eta_o/eta_i for the H map given the incoming side."""
    above = dot(nrm, win) >= 0.0
    ior = jnp.maximum(p.ior, 1e-3)
    return jnp.where(above, 1.0 / ior, ior)


# ---------------------------------------------------------------------------
# Chain state + helpers
# ---------------------------------------------------------------------------

class ChainState(NamedTuple):
    """Explicit vertex-chain storage, chains = lanes (mlt_core.h vertices /
    mut_vertices; path.h Path/BidirPath analog). Slot j of e_* holds eye
    surface vertex x_{j+1}; slot j of l_* holds light surface vertex
    y_{j+1}; y_0 lives in l0_*; the screen uv is the v_E(0) analog."""

    uv_x: Array
    uv_y: Array
    e_tri: Array  # (n, K)
    e_u: Array
    e_v: Array
    l0_tri: Array  # (n,)
    l0_u: Array
    l0_v: Array
    l_tri: Array  # (n, LS)
    l_u: Array
    l_v: Array
    s: Array  # (n,) light-side vertex count (incl. y_0; 0 = pure eye path)
    m: Array  # (n,) total segments (the path has m+1 vertices)
    val_x: Array  # (n,) current path value V
    val_y: Array
    val_z: Array
    weight: Array  # (n,) RIS seed weight W
    # env-terminated eye paths (s == 0, segment m escapes to the infinite
    # light): the escape direction is chain state. BEYOND the reference,
    # which stubs env lighting everywhere (pathtracer_core.h:1251).
    env: Array = None  # (n,) bool
    env_dx: Array = None
    env_dy: Array = None
    env_dz: Array = None


def _lum(x: Array, y: Array, z: Array) -> Array:
    return 0.2126 * x + 0.7152 * y + 0.0722 * z


def _where3(m: Array, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.where(m, a.x, b.x), jnp.where(m, a.y, b.y), jnp.where(m, a.z, b.z))


def _sel_v(idx: Array, items) -> Vec3:
    """Masked select over a python list of per-slot Vec3s."""
    out = Vec3.zeros(idx.shape)
    for j, v in enumerate(items):
        out = _where3(idx == j, v, out)
    return out


def _sel_a(idx: Array, items) -> Array:
    out = jnp.zeros(idx.shape, items[0].dtype)
    for j, v in enumerate(items):
        out = jnp.where(idx == j, v, out)
    return out


class _Rand(NamedTuple):
    """Per-(chain, step, dim) decorrelated uniforms (the DecorrelatedRandoms
    analog, mlt_core.h:243-258)."""

    base: Array  # (n,) u32

    @staticmethod
    def create(seed, instance, n) -> "_Rand":
        cid = jnp.arange(n, dtype=jnp.uint32)
        base = hash_combine(hash_combine(_u32(seed), _u32(instance)), cid)
        return _Rand(base)

    def u(self, step, dim: int) -> Array:
        return uniform_from_bits(
            hash_combine(self.base, _u32(step) * _u32(4096) + _u32(dim))
        )


class _EvalCtx(NamedTuple):
    """Static per-pass context threaded through the step helpers."""

    view: SceneView
    opts: MLTOptions
    cam: CameraSampler
    closest: object
    anyhit: object
    res_x: int
    res_y: int
    n: int


def _params_of(view, mat_id):
    return BsdfParams.from_materials(view.mesh.materials.gather(mat_id))


def _interp(view, tri, u, v):
    return view.mesh.interpolate(jnp.maximum(tri, 0), u, v)


def _retrace_side(
    ctx: _EvalCtx,
    rng: _Rand,
    step_idx,
    enable: Array,
    n_seg: Array,  # (n,) traced segments on this side
    first_dir_old: Vec3,
    first_dir_new: Vec3,
    start_pos: Vec3,  # shared start (camera eye or light point y_0)
    start_gn: Vec3,  # geometric normal at start (for ray offset); zeros at camera
    tri_old: Array,  # (n, S) stored vertex ids
    u_old: Array,
    v_old: Array,
    dim0: int,  # random-dim base for this side
    Vx, Vy, Vz, j_old, j_new, ok_new, n_rays,
    offset_first: bool,
):
    """Re-trace one subpath side with per-vertex perturbations.

    Walks segments 1..S: traces the new chain, multiplies the Q factors
    (f * cos_out per scatter vertex, mlt_core.h:582-603) into (Vx,Vy,Vz)
    and the H densities into j_old/j_new. Returns per-slot new vertex data
    plus the end-vertex records needed by the connection terms.
    """
    opts = ctx.opts
    view = ctx.view
    n = ctx.n
    S = tri_old.shape[1]
    eps = opts.ray_eps
    lobes = opts.lobes

    d_old = first_dir_old
    d_new = first_dir_new
    prev_pos_old = start_pos
    prev_pos_new = start_pos
    prev_gn_new = start_gn

    new_tri = []
    new_u = []
    new_v = []
    # per-slot records of the NEW chain (for end-vertex selection)
    rec_pos, rec_gn, rec_sn, rec_mat, rec_in = [], [], [], [], []
    rec_pos_o, rec_gn_o, rec_sn_o, rec_mat_o, rec_in_o = [], [], [], [], []

    for j in range(S):
        seg_active = (j + 1) <= n_seg
        # old vertex at slot j
        o_pos, o_gn, o_sn, _ou, o_mat = _interp(
            view, tri_old[:, j], u_old[:, j], v_old[:, j]
        )
        # trace the new segment
        if j == 0 and not offset_first:
            origin = prev_pos_new
        else:
            origin = _offset_origin(prev_pos_new, prev_gn_new, d_new, eps)
        act = seg_active & ok_new
        hit = ctx.closest(origin, d_new, jnp.float32(eps), jnp.float32(_BIG), act)
        n_rays = n_rays + jnp.sum(act.astype(jnp.float32))
        got = hit.hit_mask
        ok_new = ok_new & (~seg_active | got)
        n_tri = jnp.maximum(hit.tri, 0)
        n_pos, n_gn, n_sn, _nu, n_mat = _interp(view, n_tri, hit.u, hit.v)
        new_tri.append(jnp.where(seg_active & got, hit.tri, tri_old[:, j]))
        new_u.append(jnp.where(seg_active & got, hit.u, u_old[:, j]))
        new_v.append(jnp.where(seg_active & got, hit.v, v_old[:, j]))

        rec_pos.append(n_pos)
        rec_gn.append(n_gn)
        rec_sn.append(n_sn)
        rec_mat.append(n_mat)
        rec_in.append(-d_new)
        rec_pos_o.append(o_pos)
        rec_gn_o.append(o_gn)
        rec_sn_o.append(o_sn)
        rec_mat_o.append(o_mat)
        rec_in_o.append(-d_old)

        if j + 1 < S:
            # direction of the NEXT segment, leaving vertex slot j
            nseg_active = (j + 2) <= n_seg
            o_next_pos, _g, _s, _u2, _m2 = _interp(
                view, tri_old[:, j + 1], u_old[:, j + 1], v_old[:, j + 1]
            )
            out_old = normalize(o_next_pos - o_pos)
            u_pv = rng.u(step_idx, dim0 + 7 * j)
            zz0 = rng.u(step_idx, dim0 + 7 * j + 1)
            zz1 = rng.u(step_idx, dim0 + 7 * j + 2)
            pe = opts.exp_perturbations
            ph = opts.h_perturbations
            choose_exp = enable & (u_pv < pe)
            choose_h = enable & (u_pv >= pe) & (u_pv < pe + ph)
            out_exp = exp_spherical_perturbation(out_old, zz0, zz1, opts.perturbation_radius)
            o_eta = _eta_of(_params_of(view, o_mat), o_sn, -d_old)
            n_eta = _eta_of(_params_of(view, n_mat), n_sn, -d_new)
            out_h = h_perturbation(
                -d_old, out_old, o_sn, o_eta,
                -d_new, n_sn, n_eta, zz0, zz1, opts.perturbation_radius,
            )
            out_new = _where3(choose_exp, out_exp, _where3(choose_h, out_h, out_old))

            # Q factors for this scatter (vertex slot j scatters into the
            # next segment): f * cos_out on both paths; H densities when the
            # H kernel was chosen (mlt_core.h:582-603)
            po = _params_of(view, o_mat)
            pn = _params_of(view, n_mat)
            o_t, o_b = orthonormal_basis(o_sn)
            n_t, n_b = orthonormal_basis(n_sn)
            f_o = bsdf_f(po, to_local(-d_old, o_t, o_b, o_sn),
                         to_local(out_old, o_t, o_b, o_sn), lobes)
            f_n = bsdf_f(pn, to_local(-d_new, n_t, n_b, n_sn),
                         to_local(out_new, n_t, n_b, n_sn), lobes)
            cos_o = jnp.abs(dot(o_sn, out_old))
            cos_n = jnp.abs(dot(n_sn, out_new))
            # fold the OLD path's f*cos into j_old (V_old is stored, but the
            # acceptance needs f_old recomputed only through the stored
            # value; the ratio uses V products directly so multiply the NEW
            # side into V and the OLD side into j_old as a denominator)
            Vx = jnp.where(nseg_active, Vx * f_n.x * cos_n, Vx)
            Vy = jnp.where(nseg_active, Vy * f_n.y * cos_n, Vy)
            Vz = jnp.where(nseg_active, Vz * f_n.z * cos_n, Vz)
            hd_o = h_perturbation_density(-d_old, out_old, o_sn, o_eta)
            hd_n = h_perturbation_density(-d_new, out_new, n_sn, n_eta)
            use_h = choose_h & nseg_active
            j_old = j_old * jnp.where(use_h, hd_o, 1.0)
            j_new = j_new * jnp.where(use_h, hd_n, 1.0)

            d_old = out_old
            d_new = out_new
            prev_pos_old = o_pos
            prev_pos_new = n_pos
            prev_gn_new = n_gn

    end = {
        "pos": rec_pos, "gn": rec_gn, "sn": rec_sn, "mat": rec_mat, "in": rec_in,
        "pos_o": rec_pos_o, "gn_o": rec_gn_o, "sn_o": rec_sn_o,
        "mat_o": rec_mat_o, "in_o": rec_in_o,
    }
    return (
        new_tri, new_u, new_v, end, Vx, Vy, Vz, j_old, j_new, ok_new, n_rays
    )


def _st_swap_step(ctx: _EvalCtx, rng: _Rand, step_idx, state: ChainState,
                  splat: Array):
    """ST-swap mutation: relabel the path split (s,t) -> (s±1, t∓1) on the
    SAME geometric path (the reference's swap mutation family —
    mlt_kernels.h ST swaps; cmlt.cu:559-680 is the charted-space version).

    Every factor of the path value except the moved vertex's BSDF cancels
    against the measure conversion between the two representations (each
    traced edge carries a solid-angle->area jacobian cos/d^2; the edge that
    changes role swaps exactly that factor against the connection's G), so

        a = lum(val * f_swapped / f_orig) / lum(val)

    — identically 1 for a reciprocal BSDF, with MH correcting any
    implementation asymmetry (e.g. microfacet refraction's eta^2) — and
    the stored value rescales analytically by the geometric ratio. No rays
    are traced. Fixed-chart chains mix slowly on paths whose best strategy
    varies across the image (VERDICT r2 missing #1); this move lets a
    chain migrate between strategies without re-tracing.
    """
    view = ctx.view
    n = ctx.n
    res_x, res_y = ctx.res_x, ctx.res_y
    S_e = state.e_tri.shape[1]
    LS = state.l_tri.shape[1]
    lobes = ctx.opts.lobes

    t_count = state.m + 1 - state.s
    s = state.s
    live = state.weight > 0.0  # splat-liveness: EVERY live chain deposits
    movable = live & (~state.env)  # env chains sit swaps out (null move)

    e_cols = lambda a: [a[:, j] for j in range(S_e)]
    l_cols = lambda a: [a[:, j] for j in range(LS)]

    # --- gather the three pivot vertices --------------------------------
    ie = jnp.clip(t_count - 2, 0, S_e - 1)  # eye end slot
    ie2 = jnp.clip(t_count - 3, 0, S_e - 1)  # eye prev slot (t >= 3)
    e1_tri = _sel_a(ie, e_cols(state.e_tri))
    e1_u = _sel_a(ie, e_cols(state.e_u))
    e1_v = _sel_a(ie, e_cols(state.e_v))
    e1_pos, e1_gn, e1_sn, _e1uv, e1_mat = _interp(view, e1_tri, e1_u, e1_v)
    e2_tri = _sel_a(ie2, e_cols(state.e_tri))
    e2_u = _sel_a(ie2, e_cols(state.e_u))
    e2_v = _sel_a(ie2, e_cols(state.e_v))
    e2_pos, _g2, _s2, _u2, _m2 = _interp(view, e2_tri, e2_u, e2_v)

    il = jnp.clip(s - 2, 0, LS - 1)  # light end slot (s >= 2)
    il2 = jnp.clip(s - 3, 0, LS - 1)  # light prev slot (s >= 3)
    y1_tri = jnp.where(s >= 2, _sel_a(il, l_cols(state.l_tri)), state.l0_tri)
    y1_u = jnp.where(s >= 2, _sel_a(il, l_cols(state.l_u)), state.l0_u)
    y1_v = jnp.where(s >= 2, _sel_a(il, l_cols(state.l_v)), state.l0_v)
    y1_pos, _y1gn, y1_sn, _y1uv, y1_mat = _interp(view, y1_tri, y1_u, y1_v)
    y2_tri = jnp.where(s >= 3, _sel_a(il2, l_cols(state.l_tri)), state.l0_tri)
    y2_u = jnp.where(s >= 3, _sel_a(il2, l_cols(state.l_u)), state.l0_u)
    y2_v = jnp.where(s >= 3, _sel_a(il2, l_cols(state.l_v)), state.l0_v)
    y2_pos, _g3, _s3, _u3, _m3 = _interp(view, y2_tri, y2_u, y2_v)

    eps2 = 1e-12
    # connection edge e1 <-> y1 (exists for s >= 1)
    dC_v = y1_pos - e1_pos
    dC2 = jnp.maximum(dot(dC_v, dC_v), eps2)
    dC = jnp.sqrt(dC2)
    dirC = dC_v * (1.0 / dC)
    # eye traced edge e2 -> e1 (exists for t >= 3)
    dA_v = e1_pos - e2_pos
    dA2 = jnp.maximum(dot(dA_v, dA_v), eps2)
    dirA = dA_v * (1.0 / jnp.sqrt(dA2))
    # light traced edge y2 -> y1 (exists for s >= 2)
    dB_v = y1_pos - y2_pos
    dB2 = jnp.maximum(dot(dB_v, dB_v), eps2)
    dirB = dB_v * (1.0 / jnp.sqrt(dB2))

    # --- direction coin + feasibility -----------------------------------
    coin = rng.u(step_idx, 770) < 0.5
    can_down = movable & (s >= 1) & (t_count <= S_e)
    can_up = movable & (t_count >= 3) & (s <= LS)
    do_down = coin & can_down
    do_up = (~coin) & can_up

    def f_at(mat, sn, win, wout):
        t_b, b_b = orthonormal_basis(sn)
        return bsdf_f(_params_of(view, mat),
                      to_local(win, t_b, b_b, sn),
                      to_local(wout, t_b, b_b, sn), lobes)

    one3 = Vec3(jnp.ones(n), jnp.ones(n), jnp.ones(n))

    # DOWN (moved vertex = y1): f_A = f(y1; -dirB, -dirC), f_B swaps roles.
    # s == 1 moves y_0 itself (pure emission end): no BSDF factor.
    fA_d = _where3(s >= 2, f_at(y1_mat, y1_sn, Vec3(-dirB.x, -dirB.y, -dirB.z),
                                Vec3(-dirC.x, -dirC.y, -dirC.z)), one3)
    fB_d = _where3(s >= 2, f_at(y1_mat, y1_sn, Vec3(-dirC.x, -dirC.y, -dirC.z),
                                Vec3(-dirB.x, -dirB.y, -dirB.z)), one3)
    cos_y1_C = jnp.abs(dot(y1_sn, dirC))
    cos_y1_B = jnp.abs(dot(y1_sn, dirB))
    geom_d = jnp.where(
        s >= 2,
        cos_y1_B * dC2 / jnp.maximum(cos_y1_C * dB2, eps2),
        dC2 / jnp.maximum(cos_y1_C, 1e-8),
    )

    # UP (moved vertex = e1): f_A = f(e1; -dirA, dirC), f_B swaps roles.
    # s == 0 moves an emissive eye end: no BSDF factor.
    fA_u = _where3(s >= 1, f_at(e1_mat, e1_sn, Vec3(-dirA.x, -dirA.y, -dirA.z),
                                dirC), one3)
    fB_u = _where3(s >= 1, f_at(e1_mat, e1_sn, dirC,
                                Vec3(-dirA.x, -dirA.y, -dirA.z)), one3)
    cos_e1_A = jnp.abs(dot(e1_sn, dirA))
    cos_e1_C = jnp.abs(dot(e1_sn, dirC))
    geom_u = jnp.where(
        s >= 1,
        cos_e1_A * dC2 / jnp.maximum(cos_e1_C * dA2, eps2),
        cos_e1_A / jnp.maximum(dA2, eps2),
    )

    fA = _where3(do_down, fA_d, fA_u)
    fB = _where3(do_down, fB_d, fB_u)
    geom = jnp.where(do_down, geom_d, geom_u)

    # channel-sign consistency: a channel the old factorization zeroes but
    # the new one doesn't (or vice versa) cannot be rescaled — reject (the
    # reverse move rejects symmetrically)
    tiny = 1e-20
    cons = (
        ((fA.x > tiny) == (fB.x > tiny))
        & ((fA.y > tiny) == (fB.y > tiny))
        & ((fA.z > tiny) == (fB.z > tiny))
        & jnp.isfinite(geom) & (geom > 0.0)
    )
    do = (do_down | do_up) & cons

    fr = lambda b, a: jnp.where(a > tiny, b / jnp.maximum(a, tiny), 0.0)
    vx_f = state.val_x * fr(fB.x, fA.x)
    vy_f = state.val_y * fr(fB.y, fA.y)
    vz_f = state.val_z * fr(fB.z, fA.z)
    lum_old = _lum(state.val_x, state.val_y, state.val_z)
    lum_f = _lum(vx_f, vy_f, vz_f)
    a_ratio = jnp.where(lum_old > 0.0, lum_f / jnp.maximum(lum_old, 1e-30),
                        0.0)
    ar = jnp.where(do, jnp.minimum(1.0, a_ratio), 0.0)

    # expected-value splats (same pixel: the relabel keeps the screen point)
    px = jnp.clip((state.uv_x * res_x).astype(jnp.int32), 0, res_x - 1)
    py = jnp.clip((state.uv_y * res_y).astype(jnp.int32), 0, res_y - 1)
    pix = py * res_x + px
    w_chain = state.weight
    amp_old = jnp.where(live & (lum_old > 0.0),
                        w_chain * (1.0 - ar) / jnp.maximum(lum_old, 1e-30),
                        0.0)
    vx_n = vx_f * geom
    vy_n = vy_f * geom
    vz_n = vz_f * geom
    lum_new = _lum(vx_n, vy_n, vz_n)
    amp_new = jnp.where(live & (lum_new > 0.0),
                        w_chain * ar / jnp.maximum(lum_new, 1e-30), 0.0)
    splat = splat.at[pix].add(
        jnp.stack([state.val_x * amp_old, state.val_y * amp_old,
                   state.val_z * amp_old], axis=-1), mode="drop")
    splat = splat.at[pix].add(
        jnp.stack([vx_n * amp_new, vy_n * amp_new, vz_n * amp_new], axis=-1),
        mode="drop")

    u_acc = rng.u(step_idx, 771)
    accept = do & (u_acc < ar)
    acc_d = accept & do_down
    acc_u = accept & do_up

    # --- slot rewrites ----------------------------------------------------
    tgt_e = t_count - 1  # new eye end slot after DOWN
    tgt_l = s - 1  # new light end slot after UP (s >= 1)

    def put(arr2, tgt, val, acc, S):
        cols = []
        for j in range(S):
            cols.append(jnp.where(acc & (tgt == j), val, arr2[:, j]))
        return jnp.stack(cols, axis=1)

    new_e_tri = put(state.e_tri, tgt_e, y1_tri, acc_d, S_e)
    new_e_u = put(state.e_u, tgt_e, y1_u, acc_d, S_e)
    new_e_v = put(state.e_v, tgt_e, y1_v, acc_d, S_e)
    up_hi = acc_u & (s >= 1)
    new_l_tri = put(state.l_tri, tgt_l, e1_tri, up_hi, LS)
    new_l_u = put(state.l_u, tgt_l, e1_u, up_hi, LS)
    new_l_v = put(state.l_v, tgt_l, e1_v, up_hi, LS)
    up_l0 = acc_u & (s == 0)
    new_l0_tri = jnp.where(up_l0, e1_tri, state.l0_tri)
    new_l0_u = jnp.where(up_l0, e1_u, state.l0_u)
    new_l0_v = jnp.where(up_l0, e1_v, state.l0_v)

    new_s = jnp.where(acc_d, s - 1, jnp.where(acc_u, s + 1, s))
    return state._replace(
        e_tri=new_e_tri, e_u=new_e_u, e_v=new_e_v,
        l_tri=new_l_tri, l_u=new_l_u, l_v=new_l_v,
        l0_tri=new_l0_tri, l0_u=new_l0_u, l0_v=new_l0_v,
        s=new_s,
        val_x=jnp.where(accept, vx_n, state.val_x),
        val_y=jnp.where(accept, vy_n, state.val_y),
        val_z=jnp.where(accept, vz_n, state.val_z),
    ), splat


def render_pass(
    view: SceneView,
    opts: MLTOptions,
    res_x: int,
    res_y: int,
    instance: Array,
    seed: int = 0,
):
    """One MLT pass. Returns ((n_pix, 3) image in PT per-pixel-mean units,
    rays-traced counter)."""
    n_pix = res_x * res_y
    n = opts.n_chains if opts.n_chains > 0 else n_pix
    K = opts.max_path_length
    LS = max(K - 2, 1)  # stored light surface vertices y_1..y_{LS}
    eps = opts.ray_eps
    lobes = opts.lobes
    pt_opts = PTOptions(tracer=opts.tracer)
    closest, anyhit = _pick_tracers(view, pt_opts)
    cam_sampler = CameraSampler.create(view.camera, res_x / res_y)
    rng = _Rand.create(seed, instance, n)
    n_rays = jnp.zeros((), jnp.float32)
    mesh = view.mesh
    ctx = _EvalCtx(view, opts, cam_sampler, closest, anyhit, res_x, res_y, n)

    from fermat_tpu.integrators.bpt import _eval_both

    cam_eye = Vec3(
        jnp.broadcast_to(view.camera.eye.x, (n,)),
        jnp.broadcast_to(view.camera.eye.y, (n,)),
        jnp.broadcast_to(view.camera.eye.z, (n,)),
    )

    # -------------------------------------------------------------------
    # Phase 1: BPT presample (seeding pass, mlt.cu:178-263)
    # -------------------------------------------------------------------
    uv0_x = rng.u(jnp.uint32(0), 0)
    uv0_y = rng.u(jnp.uint32(0), 1)

    ul0 = rng.u(jnp.uint32(0), 2)
    ul1 = rng.u(jnp.uint32(0), 3)
    ul2 = rng.u(jnp.uint32(0), 4)
    lpos, ln, lle, lpdf_a, ltri = view.lights.sample(mesh, ul0, ul1, ul2)
    lb0, lb1 = square_to_uniform_triangle(ul0, ul1)
    has_light = view.lights.has_lights & (lpdf_a > 0.0)

    ue0 = rng.u(jnp.uint32(0), 5)
    ue1 = rng.u(jnp.uint32(0), 6)
    d_loc = square_to_cosine_hemisphere(ue0, ue1)
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
    o = _offset_origin(lpos, ln, d, eps)
    alive = has_light

    zf = lambda shape: jnp.zeros(shape, jnp.float32)
    l_rec = {
        "tri": jnp.zeros((n, LS), jnp.int32), "u": zf((n, LS)), "v": zf((n, LS)),
        "valid": jnp.zeros((n, LS), bool),
        "thr_x": zf((n, LS)), "thr_y": zf((n, LS)), "thr_z": zf((n, LS)),
        "dvcm": zf((n, LS)), "dvc": zf((n, LS)),
        "wix": zf((n, LS)), "wiy": zf((n, LS)), "wiz": zf((n, LS)),
    }
    for j in range(LS):
        hit = closest(o, d, jnp.float32(eps), jnp.float32(_BIG), alive)
        n_rays = n_rays + jnp.sum(alive.astype(jnp.float32))
        valid = alive & hit.hit_mask
        tri_c = jnp.maximum(hit.tri, 0)
        pos, gn, sn, _uv, mat_id = _interp(view, tri_c, hit.u, hit.v)
        wi = -d
        flip = jnp.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        gn_f, sn_f = gn * flip, sn * flip
        cos_in = jnp.maximum(jnp.abs(dot(sn_f, wi)), 1e-8)
        t_safe = jnp.where(valid, hit.t, 1.0)
        dvcm = l_dvcm * (t_safe * t_safe) / cos_in
        dvc = l_dvc / cos_in
        for k_, v_ in (
            ("tri", jnp.where(valid, hit.tri, 0)),
            ("u", jnp.where(valid, hit.u, 0.0)), ("v", jnp.where(valid, hit.v, 0.0)),
            ("valid", valid),
            ("thr_x", jnp.where(valid, l_thr.x, 0.0)),
            ("thr_y", jnp.where(valid, l_thr.y, 0.0)),
            ("thr_z", jnp.where(valid, l_thr.z, 0.0)),
            ("dvcm", jnp.where(valid, dvcm, 0.0)),
            ("dvc", jnp.where(valid, dvc, 0.0)),
            ("wix", wi.x), ("wiy", wi.y), ("wiz", wi.z),
        ):
            l_rec[k_] = l_rec[k_].at[:, j].set(v_)
        if j + 1 < LS:
            t_b, b_b = orthonormal_basis(sn_f)
            wi_loc = to_local(wi, t_b, b_b, sn_f)
            p = _params_of(view, mat_id)
            sm = bsdf_sample(
                p, wi_loc,
                rng.u(jnp.uint32(0), 10 + 3 * j), rng.u(jnp.uint32(0), 11 + 3 * j),
                rng.u(jnp.uint32(0), 12 + 3 * j), lobes,
            )
            _, pdf_rev = f_and_pdf(p, sm.wo, wi_loc, lobes)
            pdf_rev = _sg(pdf_rev)
            cos_out = jnp.maximum(jnp.abs(sm.wo.z), 1e-8)
            pdf_fwd = _sg(jnp.maximum(sm.pdf, 1e-20))
            l_dvc = (cos_out / pdf_fwd) * (dvc * pdf_rev + dvcm)
            l_dvcm = 1.0 / pdf_fwd
            wo_w = to_world(sm.wo, t_b, b_b, sn_f)
            l_thr = Vec3(l_thr.x * sm.g.x, l_thr.y * sm.g.y, l_thr.z * sm.g.z)
            alive = valid & sm.valid
            l_thr = Vec3(
                jnp.where(alive, l_thr.x, 0.0),
                jnp.where(alive, l_thr.y, 0.0),
                jnp.where(alive, l_thr.z, 0.0),
            )
            o = _offset_origin(pos, gn, wo_w, eps)
            d = wo_w

    # --- eye walk + strategy enumeration ---
    d = cam_sampler.sample_direction(uv0_x, uv0_y)
    o = cam_eye
    e_dvcm = jnp.zeros(n, jnp.float32)  # light tracing excluded
    e_dvc = jnp.zeros(n, jnp.float32)
    e_thr = Vec3.full((n,), 1.0, 1.0, 1.0)
    alive = jnp.ones(n, bool)
    e_rec = {
        "tri": jnp.zeros((n, K), jnp.int32), "u": zf((n, K)), "v": zf((n, K)),
        "valid": jnp.zeros((n, K), bool),
    }
    strategies = []  # (s, m, rgb contribution); s == -1 marks env paths
    d_rec = []  # per-step eye-walk directions (env escape candidates)

    from fermat_tpu.scene.envmap import scene_env_radiance

    for i in range(K):
        d_rec.append(d)
        hit = closest(o, d, jnp.float32(eps), jnp.float32(_BIG), alive)
        n_rays = n_rays + jnp.sum(alive.astype(jnp.float32))
        valid = alive & hit.hit_mask
        if i >= 1:
            # env-terminated path: segment i+1 escapes (i == 0, the
            # directly-visible env, stays the additive QMC term of
            # render_pass_fb — no double counting)
            env_rad = scene_env_radiance(view, d)
            env_msk = alive & ~hit.hit_mask
            strategies.append((-1, i + 1, Vec3(
                jnp.where(env_msk, e_thr.x * env_rad.x, 0.0),
                jnp.where(env_msk, e_thr.y * env_rad.y, 0.0),
                jnp.where(env_msk, e_thr.z * env_rad.z, 0.0),
            )))
        tri_c = jnp.maximum(hit.tri, 0)
        pos, gn, sn, _uv, mat_id = _interp(view, tri_c, hit.u, hit.v)
        wi = -d
        flip = jnp.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        gn_f, sn_f = gn * flip, sn * flip
        cos_in = jnp.maximum(jnp.abs(dot(sn_f, wi)), 1e-8)
        t_safe = jnp.where(valid, hit.t, 1.0)
        e_dvcm = e_dvcm * (t_safe * t_safe) / cos_in
        e_dvc = e_dvc / cos_in
        for k_, v_ in (
            ("tri", jnp.where(valid, hit.tri, 0)),
            ("u", jnp.where(valid, hit.u, 0.0)), ("v", jnp.where(valid, hit.v, 0.0)),
            ("valid", valid),
        ):
            e_rec[k_] = e_rec[k_].at[:, i].set(v_)

        t_b, b_b = orthonormal_basis(sn_f)
        wi_loc = to_local(wi, t_b, b_b, sn_f)
        p = _params_of(view, mat_id)

        # s=0: emissive hit (m = i+1)
        le = _emissive_of(mesh, mat_id)
        is_em = (le.x + le.y + le.z) > 0.0
        front = dot(gn, wi) > 0.0
        pdf_direct_a = _sg(view.lights.pdf_area_of(tri_c))
        cos_l = jnp.maximum(dot(gn, wi), 1e-8)
        pdf_emit_hit = _sg(pdf_direct_a * cos_l * INV_PI)
        if i == 0:
            w = jnp.ones(n, jnp.float32)
        else:
            w_cam = pdf_direct_a * e_dvcm + pdf_emit_hit * e_dvc
            w = 1.0 / (1.0 + w_cam)
        msk = valid & is_em & front
        strategies.append((0, i + 1, Vec3(
            jnp.where(msk, e_thr.x * le.x * w, 0.0),
            jnp.where(msk, e_thr.y * le.y * w, 0.0),
            jnp.where(msk, e_thr.z * le.z * w, 0.0),
        )))

        # s=1: connect to y_0 (m = i+2)
        if i + 2 <= K:
            to_l = lpos - pos
            ld2 = jnp.maximum(dot(to_l, to_l), 1e-12)
            ld = jnp.sqrt(ld2)
            wo = to_l * (1.0 / ld)
            cos_at_l = dot(ln, -wo)
            wo_loc = to_local(wo, t_b, b_b, sn_f)
            fe, pdf_fwd, pdf_rev = _eval_both(p, wi_loc, wo_loc, lobes)
            cos_here = jnp.abs(wo_loc.z)
            pdf_l_sa = _sg(lpdf_a * ld2 / jnp.maximum(jnp.abs(cos_at_l), 1e-8))
            w_light = pdf_fwd / jnp.maximum(pdf_l_sa, 1e-20)
            emis_full = _sg(lpdf_a * jnp.maximum(cos_at_l, 0.0) * INV_PI)
            w_cam = (
                emis_full * cos_here
                / (jnp.maximum(pdf_l_sa, 1e-20) * jnp.maximum(jnp.abs(cos_at_l), 1e-8))
            ) * (e_dvcm + e_dvc * pdf_rev)
            w = 1.0 / (w_light + 1.0 + w_cam)
            able = valid & has_light & (cos_at_l > 1e-6) & ((fe.x + fe.y + fe.z) > 0.0)
            so = _offset_origin(pos, gn, wo, eps)
            occ = anyhit(so, wo, jnp.float32(0.0), ld * (1.0 - 1e-3), able)
            n_rays = n_rays + jnp.sum(able.astype(jnp.float32))
            lit = able & ~occ
            scale = cos_here * w / jnp.maximum(pdf_l_sa, 1e-20)
            strategies.append((1, i + 2, Vec3(
                jnp.where(lit, e_thr.x * fe.x * lle.x * scale, 0.0),
                jnp.where(lit, e_thr.y * fe.y * lle.y * scale, 0.0),
                jnp.where(lit, e_thr.z * fe.z * lle.z * scale, 0.0),
            )))

        # s>=2: connect to stored light vertex y_{j+1} (m = i+j+3)
        for j in range(LS):
            m_total = i + j + 3
            if m_total > K:
                break
            vtri = l_rec["tri"][:, j]
            vpos, vgn, vsn, _vu, vmat = _interp(view, vtri, l_rec["u"][:, j], l_rec["v"][:, j])
            vwi = Vec3(l_rec["wix"][:, j], l_rec["wiy"][:, j], l_rec["wiz"][:, j])
            vflip = jnp.where(dot(vgn, vwi) < 0.0, -1.0, 1.0)
            vgn_f, vsn_f = vgn * vflip, vsn * vflip
            vthr = Vec3(l_rec["thr_x"][:, j], l_rec["thr_y"][:, j], l_rec["thr_z"][:, j])
            conn = vpos - pos
            cd2 = jnp.maximum(dot(conn, conn), 1e-12)
            cd = jnp.sqrt(cd2)
            cdir = conn * (1.0 / cd)
            co_loc = to_local(cdir, t_b, b_b, sn_f)
            fe, pdf_e_fwd, pdf_e_rev = _eval_both(p, wi_loc, co_loc, lobes)
            cos_e = jnp.abs(co_loc.z)
            lt_b, lb_b = orthonormal_basis(vsn_f)
            lwi_loc = to_local(vwi, lt_b, lb_b, vsn_f)
            lwo_loc = to_local(-cdir, lt_b, lb_b, vsn_f)
            lp = _params_of(view, vmat)
            fl, pdf_l_fwd, pdf_l_rev = _eval_both(lp, lwi_loc, lwo_loc, lobes)
            cos_lv = jnp.abs(lwo_loc.z)
            g = cos_e * cos_lv / cd2
            pdf_e_fwd_a = _sg(pdf_e_fwd * cos_lv / cd2)
            pdf_l_fwd_a = _sg(pdf_l_fwd * cos_e / cd2)
            w_light = pdf_e_fwd_a * (l_rec["dvcm"][:, j] + l_rec["dvc"][:, j] * pdf_l_rev)
            w_cam = pdf_l_fwd_a * (e_dvcm + e_dvc * pdf_e_rev)
            w = 1.0 / (w_light + 1.0 + w_cam)
            able = (
                valid & l_rec["valid"][:, j] & (g > 0.0)
                & ((fe.x + fe.y + fe.z) > 0.0) & ((fl.x + fl.y + fl.z) > 0.0)
            )
            so = _offset_origin(pos, gn_f, cdir, eps)
            occ = anyhit(so, cdir, jnp.float32(0.0), cd * (1.0 - 1e-3), able)
            n_rays = n_rays + jnp.sum(able.astype(jnp.float32))
            lit = able & ~occ
            amp = jnp.where(lit, g * w, 0.0)
            strategies.append((j + 2, m_total, Vec3(
                e_thr.x * fe.x * vthr.x * fl.x * amp,
                e_thr.y * fe.y * vthr.y * fl.y * amp,
                e_thr.z * fe.z * vthr.z * fl.z * amp,
            )))

        if i + 1 < K:
            sm = bsdf_sample(
                p, wi_loc,
                rng.u(jnp.uint32(0), 40 + 3 * i), rng.u(jnp.uint32(0), 41 + 3 * i),
                rng.u(jnp.uint32(0), 42 + 3 * i), lobes,
            )
            _, pdf_rev_w = f_and_pdf(p, sm.wo, wi_loc, lobes)
            pdf_rev_w = _sg(pdf_rev_w)
            cos_out = jnp.maximum(jnp.abs(sm.wo.z), 1e-8)
            pdf_fwd_w = _sg(jnp.maximum(sm.pdf, 1e-20))
            e_dvc = (cos_out / pdf_fwd_w) * (e_dvc * pdf_rev_w + e_dvcm)
            e_dvcm = 1.0 / pdf_fwd_w
            wo_w = to_world(sm.wo, t_b, b_b, sn_f)
            e_thr = Vec3(e_thr.x * sm.g.x, e_thr.y * sm.g.y, e_thr.z * sm.g.z)
            alive = valid & sm.valid
            e_thr = Vec3(
                jnp.where(alive, e_thr.x, 0.0),
                jnp.where(alive, e_thr.y, 0.0),
                jnp.where(alive, e_thr.z, 0.0),
            )
            o = _offset_origin(pos, gn, wo_w, eps)
            d = wo_w

    # -------------------------------------------------------------------
    # Phase 2: per-lane RIS seed pick (sample_seeds analog)
    # -------------------------------------------------------------------
    lums = jnp.stack([_lum(c.x, c.y, c.z) for (_s, _m, c) in strategies], axis=1)
    lums = jnp.where(jnp.isfinite(lums), jnp.maximum(lums, 0.0), 0.0)
    weight = jnp.sum(lums, axis=1)
    cdf = jnp.cumsum(lums, axis=1)
    u_pick = rng.u(jnp.uint32(0), 90) * jnp.maximum(weight, 1e-30)
    pick = jnp.sum((cdf <= u_pick[:, None]).astype(jnp.int32), axis=1)
    pick = jnp.minimum(pick, len(strategies) - 1)
    s_arr = jnp.asarray([st[0] for st in strategies], jnp.int32)
    m_arr = jnp.asarray([st[1] for st in strategies], jnp.int32)

    s_pick = s_arr[pick]
    m_pick = m_arr[pick]
    is_env = s_pick < 0
    # escape direction of the picked env path: the eye-walk direction at
    # walk step m-1 (segment m)
    esc_d = _sel_v(jnp.clip(m_pick - 1, 0, K - 1), d_rec)
    state = ChainState(
        uv_x=uv0_x, uv_y=uv0_y,
        e_tri=e_rec["tri"], e_u=e_rec["u"], e_v=e_rec["v"],
        l0_tri=ltri, l0_u=lb0, l0_v=lb1,
        l_tri=l_rec["tri"], l_u=l_rec["u"], l_v=l_rec["v"],
        s=jnp.where(is_env, 0, s_pick), m=m_pick,
        val_x=jnp.zeros(n), val_y=jnp.zeros(n), val_z=jnp.zeros(n),
        weight=weight,
        env=is_env, env_dx=esc_d.x, env_dy=esc_d.y, env_dz=esc_d.z,
    )

    # -------------------------------------------------------------------
    # Phase 3: chain steps
    # -------------------------------------------------------------------
    def step(step_idx, carry):
        state, splat, n_rays = carry
        enable = step_idx > 0
        is_env = state.env  # env-terminated eye paths (segment m escapes)
        t_count = state.m + 1 - state.s  # eye vertices incl. camera (>= 2)
        # env chains store surface vertices x_1..x_{m-1}: m-1 traced
        # segments; the m-th segment is the escape (handled at end terms)
        n_eye_seg = jnp.where(is_env, state.m - 1, t_count - 1)
        n_light_seg = jnp.maximum(state.s - 1, 0)  # traced light segments

        # --- screen perturbation ---
        u_p = rng.u(step_idx, 100)
        do_scr = enable & (u_p < opts.screen_perturbations)
        z0 = rng.u(step_idx, 101)
        z1 = rng.u(step_idx, 102)
        r_mag = bounded_exp_map(z1, 1.0e-4, opts.perturbation_radius)
        phi = z0 * TWO_PI
        nuv_x = state.uv_x + jnp.where(do_scr, jnp.cos(phi) * r_mag, 0.0)
        nuv_y = state.uv_y + jnp.where(do_scr, jnp.sin(phi) * r_mag, 0.0)
        nuv_x = nuv_x - jnp.floor(nuv_x)
        nuv_y = nuv_y - jnp.floor(nuv_y)

        Vx = jnp.ones(n, jnp.float32)
        Vy = jnp.ones(n, jnp.float32)
        Vz = jnp.ones(n, jnp.float32)
        j_old = jnp.ones(n, jnp.float32)
        j_new = jnp.ones(n, jnp.float32)
        ok_new = jnp.ones(n, bool)

        # --- eye side ---
        d_old_e = cam_sampler.sample_direction(state.uv_x, state.uv_y)
        d_new_e = cam_sampler.sample_direction(nuv_x, nuv_y)
        (e_ntri, e_nu, e_nv, e_end, Vx, Vy, Vz, j_old, j_new, ok_new, n_rays) = (
            _retrace_side(
                ctx, rng, step_idx, enable, n_eye_seg, d_old_e, d_new_e,
                cam_eye, Vec3.zeros((n,)), state.e_tri, state.e_u, state.e_v,
                110, Vx, Vy, Vz, j_old, j_new, ok_new, n_rays,
                offset_first=False,
            )
        )

        # --- light side (y_0 fixed; emission direction perturbed by exp) ---
        l0_pos, l0_gn, _l0_sn, _l0_uv, l0_mat = _interp(
            view, state.l0_tri, state.l0_u, state.l0_v
        )
        l0_le = _emissive_of(mesh, l0_mat)
        # old emission direction from stored y_1
        y1_pos, _g1, _s1, _u1, _m1 = _interp(
            view, state.l_tri[:, 0], state.l_u[:, 0], state.l_v[:, 0]
        )
        demit_old = normalize(y1_pos - l0_pos)
        uz0 = rng.u(step_idx, 300)
        uz1 = rng.u(step_idx, 301)
        u_pe = rng.u(step_idx, 302)
        pe_tot = opts.exp_perturbations + opts.h_perturbations
        do_emit = enable & (u_pe < pe_tot) & (state.s >= 2)
        demit_new = _where3(
            do_emit,
            exp_spherical_perturbation(demit_old, uz0, uz1, opts.perturbation_radius),
            demit_old,
        )
        # emission Q factors: Le * cos_out on both sides (EDF is Lambert so
        # Le is direction-free; the cos comes from the traced segment's G)
        has_l_side = state.s >= 2
        cos_e_old = jnp.abs(dot(l0_gn, demit_old))
        cos_e_new = jnp.abs(dot(l0_gn, demit_new))
        front_new = dot(l0_gn, demit_new) > 0.0
        Vx = jnp.where(has_l_side, Vx * l0_le.x * cos_e_new, Vx)
        Vy = jnp.where(has_l_side, Vy * l0_le.y * cos_e_new, Vy)
        Vz = jnp.where(has_l_side, Vz * l0_le.z * cos_e_new, Vz)
        ok_new = ok_new & (~has_l_side | front_new)

        (l_ntri, l_nu, l_nv, l_end, Vx, Vy, Vz, j_old, j_new, ok_new, n_rays) = (
            _retrace_side(
                ctx, rng, step_idx, enable, n_light_seg, demit_old, demit_new,
                l0_pos, l0_gn, state.l_tri, state.l_u, state.l_v,
                400, Vx, Vy, Vz, j_old, j_new, ok_new, n_rays,
                offset_first=True,
            )
        )

        # --- end terms ---
        # env chains: the end SURFACE vertex is x_{m-1} (slot m-2)
        e_end_idx = jnp.where(is_env, state.m - 2, t_count - 2)
        ex_pos = _sel_v(e_end_idx, e_end["pos"])
        ex_gn = _sel_v(e_end_idx, e_end["gn"])
        ex_sn = _sel_v(e_end_idx, e_end["sn"])
        ex_mat = _sel_a(e_end_idx, e_end["mat"])
        ex_in = _sel_v(e_end_idx, e_end["in"])

        is_s0 = (state.s == 0) & ~is_env
        is_s1 = state.s == 1
        is_s2 = state.s >= 2

        # s = 0: the eye end vertex must be emissive, facing the path
        le_end = _emissive_of(mesh, ex_mat)
        front0 = dot(ex_gn, ex_in) > 0.0
        v_s0 = Vec3(
            jnp.where(front0, le_end.x, 0.0),
            jnp.where(front0, le_end.y, 0.0),
            jnp.where(front0, le_end.z, 0.0),
        )

        # connection target: y_0 (s=1) or the light end vertex y_{s-1} (s>=2)
        l_end_idx = state.s - 2  # slot of y_{s-1} for s >= 2
        ly_pos = _where3(is_s2, _sel_v(l_end_idx, l_end["pos"]), l0_pos)
        ly_sn = _where3(is_s2, _sel_v(l_end_idx, l_end["sn"]), l0_gn)
        ly_gn = _where3(is_s2, _sel_v(l_end_idx, l_end["gn"]), l0_gn)
        ly_mat = jnp.where(is_s2, _sel_a(l_end_idx, l_end["mat"]), l0_mat)
        ly_in = _sel_v(l_end_idx, l_end["in"])

        conn = ly_pos - ex_pos
        cd2 = jnp.maximum(dot(conn, conn), 1e-12)
        cd = jnp.sqrt(cd2)
        cdir = conn * (1.0 / cd)
        # eye-end BSDF toward the connection
        et, eb = orthonormal_basis(ex_sn)
        f_eye = bsdf_f(
            _params_of(view, ex_mat),
            to_local(ex_in, et, eb, ex_sn), to_local(cdir, et, eb, ex_sn), lobes,
        )

        # --- env escape segment (env chains only): perturb the stored
        # escape direction, require it to still escape, multiply the end
        # scatter's f * cos and the env radiance ---
        esc_old = Vec3(state.env_dx, state.env_dy, state.env_dz)
        uz2 = rng.u(step_idx, 600)
        uz3 = rng.u(step_idx, 601)
        u_pesc = rng.u(step_idx, 602)
        do_esc = enable & is_env & (u_pesc < pe_tot)
        esc_new = _where3(
            do_esc,
            exp_spherical_perturbation(esc_old, uz2, uz3,
                                       opts.perturbation_radius),
            esc_old,
        )
        f_esc = bsdf_f(
            _params_of(view, ex_mat),
            to_local(ex_in, et, eb, ex_sn),
            to_local(esc_new, et, eb, ex_sn), lobes,
        )
        cos_esc = jnp.abs(dot(ex_sn, esc_new))
        so_esc = _offset_origin(ex_pos, ex_gn, esc_new, eps)
        esc_active = is_env & ok_new & (state.weight > 0.0)
        hit_esc = ctx.closest(so_esc, esc_new, jnp.float32(eps),
                              jnp.float32(_BIG), esc_active)
        n_rays = n_rays + jnp.sum(esc_active.astype(jnp.float32))
        ok_new = ok_new & (~is_env | ~hit_esc.hit_mask)
        from fermat_tpu.scene.envmap import scene_env_radiance as _env_rad

        e_l = _env_rad(view, esc_new)
        v_env = Vec3(
            f_esc.x * cos_esc * e_l.x,
            f_esc.y * cos_esc * e_l.y,
            f_esc.z * cos_esc * e_l.z,
        )
        cos_ex = jnp.abs(dot(ex_sn, cdir))
        cos_ly = jnp.abs(dot(ly_sn, cdir))
        g_conn = cos_ex * cos_ly / cd2
        # light-end factor: Le (s=1, front only) or BSDF f (s>=2)
        le_y0 = _emissive_of(mesh, l0_mat)
        front1 = dot(l0_gn, -cdir) > 0.0
        lt2, lb2 = orthonormal_basis(ly_sn)
        f_ly = bsdf_f(
            _params_of(view, ly_mat),
            to_local(ly_in, lt2, lb2, ly_sn), to_local(-cdir, lt2, lb2, ly_sn),
            lobes,
        )
        lfac = _where3(
            is_s1,
            Vec3(
                jnp.where(front1, le_y0.x, 0.0),
                jnp.where(front1, le_y0.y, 0.0),
                jnp.where(front1, le_y0.z, 0.0),
            ),
            f_ly,
        )
        v_conn = Vec3(f_eye.x * g_conn * lfac.x, f_eye.y * g_conn * lfac.y,
                      f_eye.z * g_conn * lfac.z)
        # connection visibility
        so = _offset_origin(ex_pos, ex_gn, cdir, eps)
        need_vis = (~is_s0) & (~is_env) & ok_new
        occ = anyhit(so, cdir, jnp.float32(0.0), cd * (1.0 - 1e-3), need_vis)
        n_rays = n_rays + jnp.sum(need_vis.astype(jnp.float32))
        v_conn = _where3(occ, Vec3.zeros((n,)), v_conn)

        v_end = _where3(is_env, v_env, _where3(is_s0, v_s0, v_conn))
        Vx = Vx * v_end.x
        Vy = Vy * v_end.y
        Vz = Vz * v_end.z
        Vx = jnp.where(ok_new, Vx, 0.0)
        Vy = jnp.where(ok_new, Vy, 0.0)
        Vz = jnp.where(ok_new, Vz, 0.0)
        bad = ~jnp.isfinite(Vx + Vy + Vz)
        Vx = jnp.where(bad, 0.0, Vx)
        Vy = jnp.where(bad, 0.0, Vy)
        Vz = jnp.where(bad, 0.0, Vz)

        # --- MH accept/reject + expected-value splats ---
        lum_new = _lum(Vx, Vy, Vz)
        lum_old = _lum(state.val_x, state.val_y, state.val_z)
        q_new = lum_new * j_new
        q_old = lum_old * j_old
        ar = jnp.where(
            q_old > 0.0, jnp.minimum(1.0, q_new / jnp.maximum(q_old, 1e-30)),
            jnp.where(q_new > 0.0, 1.0, 0.0),
        )
        live = state.weight > 0.0
        w_chain = state.weight

        def pix_of(ux, uy):
            px = jnp.clip((ux * res_x).astype(jnp.int32), 0, res_x - 1)
            py = jnp.clip((uy * res_y).astype(jnp.int32), 0, res_y - 1)
            return py * res_x + px

        amp_old = jnp.where(live & (lum_old > 0.0),
                            w_chain * (1.0 - ar) / jnp.maximum(lum_old, 1e-30), 0.0)
        amp_new = jnp.where(live & (lum_new > 0.0),
                            w_chain * ar / jnp.maximum(lum_new, 1e-30), 0.0)
        splat = splat.at[pix_of(state.uv_x, state.uv_y)].add(
            jnp.stack(
                [state.val_x * amp_old, state.val_y * amp_old, state.val_z * amp_old],
                axis=-1,
            ),
            mode="drop",
        )
        splat = splat.at[pix_of(nuv_x, nuv_y)].add(
            jnp.stack([Vx * amp_new, Vy * amp_new, Vz * amp_new], axis=-1),
            mode="drop",
        )

        u_acc = rng.u(step_idx, 999)
        accept = live & (u_acc < ar)

        def upd2(old, new_cols):
            new = jnp.stack(new_cols, axis=1)
            return jnp.where(accept[:, None], new, old)

        state = state._replace(
            uv_x=jnp.where(accept, nuv_x, state.uv_x),
            uv_y=jnp.where(accept, nuv_y, state.uv_y),
            e_tri=upd2(state.e_tri, e_ntri), e_u=upd2(state.e_u, e_nu),
            e_v=upd2(state.e_v, e_nv),
            l_tri=upd2(state.l_tri, l_ntri), l_u=upd2(state.l_u, l_nu),
            l_v=upd2(state.l_v, l_nv),
            val_x=jnp.where(accept, Vx, state.val_x),
            val_y=jnp.where(accept, Vy, state.val_y),
            val_z=jnp.where(accept, Vz, state.val_z),
            env_dx=jnp.where(accept & is_env, esc_new.x, state.env_dx),
            env_dy=jnp.where(accept & is_env, esc_new.y, state.env_dy),
            env_dz=jnp.where(accept & is_env, esc_new.z, state.env_dz),
        )
        return state, splat, n_rays

    splat = jnp.zeros((n_pix, 3), jnp.float32)
    if opts.st_swap_frequency > 0:
        freq = opts.st_swap_frequency

        def loop_body(i, carry):
            is_swap = (i > 0) & ((i % freq) == (freq - 1))

            def swap_branch(c):
                st, sp, nr = c
                st, sp = _st_swap_step(ctx, rng, i, st, sp)
                return st, sp, nr

            return jax.lax.cond(
                is_swap, swap_branch, lambda c: step(i, c), carry
            )

        state, splat, n_rays = jax.lax.fori_loop(
            0, opts.steps_per_pass, loop_body, (state, splat, n_rays)
        )
    else:
        state, splat, n_rays = jax.lax.fori_loop(
            0, opts.steps_per_pass, step, (state, splat, n_rays)
        )

    norm = float(n_pix) / (float(n) * float(opts.steps_per_pass))
    return splat * norm, n_rays


def render_pass_fb(
    view: SceneView,
    opts: MLTOptions,
    res_x: int,
    res_y: int,
    instance: Array,
    seed: int = 0,
    pix: Array = None,
):
    """Framebuffer-shaped adapter (registry entry)."""
    from fermat_tpu.integrators.pt import _PassOutput, direct_env_image

    img, n_rays = render_pass(view, opts, res_x, res_y, instance, seed)
    # directly-visible environment: outside the MCMC path space (vertex
    # chains never end on the env), added as an independent QMC term
    env_img, env_rays = direct_env_image(view, res_x, res_y, instance, seed)
    img = img + env_img
    n_rays = n_rays + env_rays
    npix = res_x * res_y
    comp = Vec3(img[:, 0], img[:, 1], img[:, 2])
    zero3 = Vec3.zeros((npix,))
    return _PassOutput(
        direct=zero3, diffuse=zero3, specular=zero3, composited=comp,
        diffuse_albedo=zero3, specular_albedo=zero3,
        depth=jnp.full(npix, jnp.inf, jnp.float32),
        tri=jnp.full(npix, -1, jnp.int32), normal=zero3, position=zero3,
        uv=jnp.zeros((npix, 2), jnp.float32),
        material=jnp.full(npix, -1, jnp.int32),
        rays=n_rays,
    )
