"""Path-space-filtering path tracer (PSFPT, Binder et al. 2018).

Reference: src/renderers/psfpt.{h,cu} + psfpt_impl.h:55-175 — a PT whose
indirect radiance at the vertex of depth `psf_depth` is replaced by the
average over all paths landing in the same jittered spatial-hash cell;
two-stage (fill hash, then splat refs), with temporal reuse and firefly
clamping options (psfpt.h:348-388).

Shape: one pass = a PT walk that factors each path's contribution as
  L = L_direct + thr_psf * L_at_psf
where L_at_psf is accumulated with throughput RELATIVE to the PSF vertex
(set to 1 there) — numerically stable (no division by the path throughput).
The hash fill is a scatter-add into a persistent HashAccumulator (the
SyncFreeHashMap analog), the gather is a cell average; colliding or empty
cells fall back to the lane's own unfiltered estimate. Temporal reuse is an
exponential decay of the cell sums across passes (stateful renderer).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from fermat_tpu.bsdf.composite import BsdfParams, f_split, sample as bsdf_sample
from fermat_tpu.core.camera import generate_camera_rays
from fermat_tpu.core.math import Vec3, dot, normalize, orthonormal_basis, to_local, to_world
from fermat_tpu.core.rng import TiledSequence
from fermat_tpu.core.sampling import power_heuristic
from fermat_tpu.integrators.pt import PTOptions, _offset_origin, _pick_tracers
from fermat_tpu.scene.lights import emitter_radiance
from fermat_tpu.scene.spatial_hash import HashAccumulator, hash_shading_point
from fermat_tpu.scene.view import SceneView

Array = jax.Array


class PsfptOptions(NamedTuple):
    """psfpt.h:348-388 subset."""

    max_path_length: int = 6
    psf_depth: int = 1  # vertex index whose outgoing indirect is filtered
    cell_size: float = 0.05  # base hash cell size (psf width)
    table_size: int = 1 << 18
    temporal_decay: float = 0.85  # 0 disables temporal reuse
    firefly_clamp: float = 0.0  # clamp L_psf luminance (0 = off)
    rr: bool = True
    rr_start_bounce: int = 2
    ray_eps: float = 1.0e-4
    tracer: str = "auto"
    dims_per_bounce: int = 8
    lobes: tuple = (True, True, True, True)


class PsfptState(NamedTuple):
    cells: HashAccumulator


def init_state(view: SceneView, opts: PsfptOptions) -> PsfptState:
    return PsfptState(cells=HashAccumulator.create(opts.table_size))


def render_pass(
    view: SceneView,
    opts: PsfptOptions,
    res_x: int,
    res_y: int,
    instance: Array,
    state: PsfptState,
    seed: int = 0,
) -> Tuple[Vec3, PsfptState, Array]:
    """Returns (per-pixel radiance Vec3, new state, ray count)."""
    n = res_x * res_y
    pix = jnp.arange(n, dtype=jnp.uint32)
    seq = TiledSequence.create(seed=seed).set_instance(instance)
    pt_opts = PTOptions(tracer=opts.tracer)
    closest, anyhit = _pick_tracers(view, pt_opts)
    eps = opts.ray_eps
    n_rays = jnp.zeros((), jnp.float32)

    jx, jy = seq.sample_2d(pix, jnp.uint32(0))
    o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy)

    zero3 = Vec3.zeros((n,))
    thr = Vec3.full((n,), 1.0, 1.0, 1.0)
    rel = zero3  # throughput relative to the PSF vertex (0 before it exists)
    thr_psf = zero3
    l_direct = zero3
    l_psf = zero3
    alive = jnp.ones(n, bool)
    prev_pdf = jnp.zeros(n, jnp.float32)
    psf_slot = jnp.zeros(n, jnp.int32)
    psf_key = jnp.zeros(n, jnp.uint32)
    has_psf = jnp.zeros(n, bool)

    for b in range(opts.max_path_length):
        hit = closest(o, d, jnp.float32(eps), jnp.float32(3.0e38), alive)
        n_rays = n_rays + jnp.sum(alive.astype(jnp.float32))
        valid = alive & hit.hit_mask
        tri_c = jnp.maximum(hit.tri, 0)
        pos, gn, sn, uv, mat_id = view.mesh.interpolate(tri_c, hit.u, hit.v)
        wi = -d
        flip = jnp.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        gn_f = gn * flip
        sn_f = sn * flip
        t_b, b_b = orthonormal_basis(sn_f)
        wi_loc = to_local(wi, t_b, b_b, sn_f)
        mats = view.mesh.materials.gather(mat_id)
        params = BsdfParams.from_materials(mats)

        def add(acc_d: Vec3, acc_p: Vec3, cx, cy, cz, mask):
            """Route a contribution: pre-PSF lanes -> direct (abs weight);
            post-PSF lanes -> the filtered estimate (relative weight)."""
            to_psf = mask & has_psf
            to_dir = mask & ~has_psf
            return (
                Vec3(
                    acc_d.x + jnp.where(to_dir, thr.x * cx, 0.0),
                    acc_d.y + jnp.where(to_dir, thr.y * cy, 0.0),
                    acc_d.z + jnp.where(to_dir, thr.z * cz, 0.0),
                ),
                Vec3(
                    acc_p.x + jnp.where(to_psf, rel.x * cx, 0.0),
                    acc_p.y + jnp.where(to_psf, rel.y * cy, 0.0),
                    acc_p.z + jnp.where(to_psf, rel.z * cz, 0.0),
                ),
            )

        # escaped rays pick up the environment (weight 1 — no NEE
        # strategy samples the env here; reference stub: hellopt_impl.h:313)
        from fermat_tpu.scene.envmap import scene_env_radiance

        missed = alive & ~hit.hit_mask
        env_l = scene_env_radiance(view, Vec3(d.x, d.y, d.z))
        l_direct, l_psf = add(
            l_direct, l_psf, env_l.x, env_l.y, env_l.z, missed
        )

        # emissive accumulation w/ MIS (as pt)
        front_e = dot(gn, wi) > 0.0
        le = Vec3(
            jnp.where(front_e, mats.emissive.x, 0.0),
            jnp.where(front_e, mats.emissive.y, 0.0),
            jnp.where(front_e, mats.emissive.z, 0.0),
        )
        if b == 0:
            w_mis = jnp.ones(n, jnp.float32)
        else:
            pdf_area = view.lights.pdf_area_of(tri_c)
            t_safe = jnp.where(valid, hit.t, 1.0)
            cos_l = jnp.abs(dot(gn, wi))
            pdf_sa = pdf_area * t_safe * t_safe / jnp.maximum(cos_l, 1e-8)
            w_mis = jax.lax.stop_gradient(power_heuristic(prev_pdf, pdf_sa))
        l_direct, l_psf = add(
            l_direct, l_psf, le.x * w_mis, le.y * w_mis, le.z * w_mis, valid
        )

        # promote this vertex to the PSF vertex
        base_dim = jnp.uint32(2 + b * opts.dims_per_bounce)
        if b == opts.psf_depth:
            uj = seq.sample_1d(pix, base_dim + jnp.uint32(7))
            slot, key = hash_shading_point(
                pos, sn_f, view.camera.eye, opts.cell_size, opts.table_size, uj
            )
            newly = valid & ~has_psf
            psf_slot = jnp.where(newly, slot, psf_slot)
            psf_key = jnp.where(newly, key, psf_key)
            thr_psf = Vec3(
                jnp.where(newly, thr.x, thr_psf.x),
                jnp.where(newly, thr.y, thr_psf.y),
                jnp.where(newly, thr.z, thr_psf.z),
            )
            rel = Vec3(
                jnp.where(newly, 1.0, rel.x),
                jnp.where(newly, 1.0, rel.y),
                jnp.where(newly, 1.0, rel.z),
            )
            has_psf = has_psf | newly

        # NEE (mesh lights, MIS — as pt)
        ul0, ul1, ul2 = seq.sample_3d(pix, base_dim)
        lpos, ln, lle, lpdf_a, _ = view.lights.sample(view.mesh, ul0, ul1, ul2)
        to_l = lpos - pos
        dist2 = jnp.maximum(dot(to_l, to_l), 1e-12)
        dist = jnp.sqrt(dist2)
        wo = to_l * (1.0 / dist)
        cos_l = dot(ln, -wo)
        wo_loc = to_local(wo, t_b, b_b, sn_f)
        fd, fg, bsdf_pdf = f_split(params, wi_loc, wo_loc, opts.lobes)
        pdf_sa = jax.lax.stop_gradient(
            lpdf_a * dist2 / jnp.maximum(jnp.abs(cos_l), 1e-8)
        )
        w_mis = jax.lax.stop_gradient(power_heuristic(pdf_sa, bsdf_pdf))
        cos_s = jnp.abs(wo_loc.z)
        able = (
            valid & view.lights.has_lights & (cos_l > 1e-6) & (pdf_sa > 1e-12)
            & ((fd.x + fd.y + fd.z + fg.x + fg.y + fg.z) > 0.0)
        )
        so = _offset_origin(pos, gn, wo, eps)
        occluded = anyhit(so, wo, jnp.float32(0.0), dist * (1.0 - 1e-3), able)
        n_rays = n_rays + jnp.sum(able.astype(jnp.float32))
        lit = able & ~occluded
        scale = cos_s * w_mis / jnp.maximum(pdf_sa, 1e-12)
        fx = (fd.x + fg.x) * lle.x * scale
        fy = (fd.y + fg.y) * lle.y * scale
        fz = (fd.z + fg.z) * lle.z * scale
        l_direct, l_psf = add(l_direct, l_psf, fx, fy, fz, lit)

        # scatter + RR
        ub0, ub1, ub2 = seq.sample_3d(pix, base_dim + jnp.uint32(3))
        s = bsdf_sample(params, wi_loc, ub0, ub1, ub2, opts.lobes)
        wo_world = to_world(s.wo, t_b, b_b, sn_f)
        thr = Vec3(thr.x * s.g.x, thr.y * s.g.y, thr.z * s.g.z)
        rel = Vec3(rel.x * s.g.x, rel.y * s.g.y, rel.z * s.g.z)
        alive = valid & s.valid
        if opts.rr and b >= opts.rr_start_bounce:
            u_rr = seq.sample_1d(pix, base_dim + jnp.uint32(6))
            q = jax.lax.stop_gradient(
                jnp.clip(jnp.maximum(jnp.maximum(thr.x, thr.y), thr.z), 0.05, 1.0)
            )
            keep = u_rr < q
            alive = alive & keep
            thr = thr * (1.0 / q)
            rel = rel * (1.0 / q)
        thr = Vec3(
            jnp.where(alive, thr.x, 0.0), jnp.where(alive, thr.y, 0.0),
            jnp.where(alive, thr.z, 0.0),
        )
        rel = Vec3(
            jnp.where(alive, rel.x, rel.x), jnp.where(alive, rel.y, rel.y),
            jnp.where(alive, rel.z, rel.z),
        )
        prev_pdf = s.pdf
        o = _offset_origin(pos, gn, wo_world, eps)
        d = wo_world

    # firefly clamp on the per-path PSF estimate (psfpt firefly_filter)
    if opts.firefly_clamp > 0.0:
        lum = 0.2126 * l_psf.x + 0.7152 * l_psf.y + 0.0722 * l_psf.z
        s = jnp.minimum(1.0, opts.firefly_clamp / jnp.maximum(lum, 1e-8))
        l_psf = l_psf * s

    # hash fill + gather (two-stage of psfpt_impl.h:108-175)
    cells = state.cells.decay(opts.temporal_decay)
    cells = cells.deposit(psf_slot, psf_key, l_psf.x, l_psf.y, l_psf.z, has_psf)
    avg, ok = cells.lookup(psf_slot, psf_key)
    use = has_psf & ok
    filt = Vec3(
        jnp.where(use, avg.x, l_psf.x),
        jnp.where(use, avg.y, l_psf.y),
        jnp.where(use, avg.z, l_psf.z),
    )
    out = Vec3(
        l_direct.x + thr_psf.x * filt.x,
        l_direct.y + thr_psf.y * filt.y,
        l_direct.z + thr_psf.z * filt.z,
    )
    return out, PsfptState(cells=cells), n_rays
