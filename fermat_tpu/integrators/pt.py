"""Wavefront path tracer with NEE + MIS.

Reference analogs:
  * PTLib device core: generate_primary_ray (pathtracer_core.h:635-686),
    shade_vertex = NEE (dir lights + mesh lights w/ MIS) + emissive
    accumulation + BSDF scatter + RR (pathtracer_core.h:773-1254),
    solve_occlusion (:707-738).
  * host loop path_trace_loop (pathtracer_kernels.h:310-391) alternating
    trace / shade / shadow with queue ping-pong.
  * channel routing of PTVertexProcessor
    (src/renderers/pathtracer_vertex_processor.h): diffuse vs specular
    framebuffer channels decided by the first-vertex component.

Shape: ONE jitted pass. The wavefront is the full pixel grid; the bounce
loop is a `lax.fori_loop` with masked lanes instead of compacted queues
(every per-bounce stage is a flat (N,)-lane vector op, the traversal nests
inside). There is NO host<->device sync anywhere in a pass — the reference
pays a 4-byte readback per bounce (pathtracer_kernels.h:329); here the whole
pass is one XLA computation. A queue-explicit variant (scan-based compaction
reordering live lanes to a dense prefix each bounce, the warp_append analog
built on fermat_tpu.ops.compact's cumsum scheme) is available via
PTOptions.queue_compaction; NarrowPass is the host-driven alternative.

Differentiability: traversal outputs (hit ids / barycentrics / visibility)
are detached; radiance is differentiable w.r.t. material/emitter parameters
(the BASELINE.json inverse-rendering path).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu import platform
from fermat_tpu.accel.traverse import (
    Hit,
    trace_any,
    trace_any_brute,
    trace_closest,
    trace_closest_brute,
)
from fermat_tpu.bsdf.composite import (
    BsdfParams,
    f_split,
    sample as bsdf_sample,
)
from fermat_tpu.core.camera import generate_camera_rays
from fermat_tpu.core.math import Vec3, dot, normalize, orthonormal_basis, to_local, to_world
from fermat_tpu.core.rng import TiledSequence
from fermat_tpu.core.sampling import power_heuristic
from fermat_tpu.scene.lights import emitter_radiance
from fermat_tpu.scene.view import SceneView

Array = jax.Array

# framebuffer routing channels (pathtracer_vertex_processor.h)
CH_DIRECT = 0
CH_DIFFUSE = 1
CH_SPECULAR = 2


class PTOptions(NamedTuple):
    """Subset-parity with PTOptions (src/renderers/pathtracer.h:161-250).

    All fields are static (Python) values — changing them retraces.
    """

    max_path_length: int = 6
    direct_lighting_nee: bool = True  # pathtracer.h `direct_lighting_nee`
    direct_lighting_bsdf: bool = True  # emissive hits weighted by MIS
    indirect_lighting_nee: bool = True
    indirect_lighting_bsdf: bool = True
    visible_lights: bool = True  # show emitters to primary rays
    nee: str = "mesh"  # "mesh" = emissive CDF | "vpl" = presampled VPL set
    rr: bool = True  # russian roulette (pathtracer.h `rr`)
    rr_start_bounce: int = 2
    # queue-explicit wavefront: compact live lanes to a dense prefix each
    # bounce (PTRayQueue::warp_append analog, pathtracer_queues.h:69-93);
    # masked lanes are the default
    queue_compaction: bool = False
    ray_eps: float = 1.0e-4  # self-intersection offset (scene units)
    tracer: str = "auto"  # auto|bvh|brute (platform.tracer_for)
    # sampler: "owen" = per-pixel Owen-scrambled Sobol (tiled_sequence.h
    # analog); "bluenoise" = shared Sobol + tiled blue-noise
    # Cranley-Patterson shifts (tiled_sampling.h:287-312 analog) — trades
    # per-pixel decorrelation for a perceptually-better (high-frequency)
    # error distribution at equal spp
    sampler: str = "owen"
    dims_per_bounce: int = 8
    # static lobe mask (dr, dt, gr, gt) — auto-set from the scene's materials
    # by RenderingContext (composite.scene_lobes); disabled lobes compile out
    lobes: tuple = (True, True, True, True)
    # clearcoat 5th layer (bsdf.h kClearcoatReflection) — auto-set from the
    # scene's materials (composite.scene_clearcoat); off compiles it out
    clearcoat: bool = False
    # glossy reflection model: "ggx" (default) | "ltc" (the reference's
    # USE_LTC alternative, bsdf.h:89 — table-driven LTC proxy, bsdf/ltc.py)
    glossy_model: str = "ggx"
    # texture filtering: "bilinear" = mip level 0, EXACT reference parity
    # (bilinear_texture_lookup, texture_view.h:143-179 — the reference's
    # shading never selects mip levels) and half the gather taps;
    # "trilinear" = ray-cone LOD over the mip chain (higher quality than
    # the reference; the round-2/3 default)
    texture_filter: str = "bilinear"
    # debug: detach whole contribution classes in the backward pass
    detach_nee: bool = False
    detach_emissive: bool = False
    # debug: NEE cost attribution switches
    debug_nee_no_shadow: bool = False  # skip the shadow anyhit (biased!)
    debug_nee_fixed_light: bool = False  # skip lights.sample (biased!)
    debug_nee_cheap_eval: bool = False  # diffuse-only f instead of f_split


def _any_emissive_maps(view) -> bool:
    """Static probe: does ANY emissive triangle carry an emissive map?

    When none do (e.g. the bathroom2 stand-in — textured surfaces but a
    plain emitter), the textured-NEE path's 4-tap atlas gather per lane
    per bounce is pure waste (`textures.sample` still gathers texels
    before selecting white for map id -1). Conservative: a TRACED view
    (gradient paths) returns True and keeps the general textured
    branch."""
    try:
        import numpy as _np

        rows = _np.asarray(jax.device_get(view.lights.rows))
        pdf = _np.asarray(jax.device_get(view.lights.pdf_area))
        return bool((rows[pdf > 0.0, 22] >= 0.0).any())
    except Exception:  # noqa: BLE001 — tracer or missing cols
        return True



def _light_compact_tables(view):
    """(rows (L, 23), cdf (L,)) over the EMISSIVE subset, or None.

    The full-length MeshLightsView tables span ALL T triangles; at 100k
    triangles the per-bounce searchsorted lowers to a ~17-step while loop
    of full-wavefront gathers. The cdf only steps at emissive rows, so
    sampling the compressed table picks the identical physical triangle;
    at L <= 2048 the pick is one fused compare+sum reduction.
    Requires a concrete view (host compaction) — traced views (gradient
    paths) return None and keep the general tables."""
    import jax.core as jcore

    lv = view.lights
    if any(isinstance(leaf, jcore.Tracer)
           for leaf in jax.tree_util.tree_leaves(lv)):
        return None
    pdf_area = np.asarray(jax.device_get(lv.pdf_area))
    if pdf_area.shape[0] <= 2048:
        return None  # small scene: the full table is already cheap
    ids = np.nonzero(pdf_area > 0.0)[0]
    if ids.size == 0:
        return None
    rows = np.asarray(jax.device_get(lv.rows))
    cdf = np.asarray(jax.device_get(lv.cdf))
    return (jnp.asarray(rows[ids].astype(np.float32)),
            jnp.asarray(cdf[ids].astype(np.float32)))


def _sample_lights_compact(compact, ul0, ul1, ul2):
    """lights.sample() over the compact table (bit-equal picks).

    Returns (pos, n, le, pdf_a, row) — `row` for the textured-emitter
    uv/emap columns."""
    from fermat_tpu.core.sampling import square_to_uniform_triangle
    from fermat_tpu.ops.gather import gather_rows

    rows, cdf = compact
    n_l = cdf.shape[0]
    if n_l <= 2048:
        tri = jnp.sum((cdf[None, :] <= ul2[:, None]).astype(jnp.int32),
                      axis=1)
    else:
        tri = jnp.searchsorted(cdf, ul2, side="right").astype(jnp.int32)
    tri = jnp.clip(tri, 0, n_l - 1)
    r = gather_rows(rows, tri)
    b0, b1 = square_to_uniform_triangle(ul0, ul1)
    vec = lambda ci: Vec3(r[:, ci], r[:, ci + 1], r[:, ci + 2])
    p0, e1, e2, nrm, le = vec(0), vec(3), vec(6), vec(9), vec(12)
    pos = p0 + e1 * b0 + e2 * b1
    return pos, nrm, le, r[:, 15], (r, b0, b1)


def _detach_rays(o, d):
    """Traversal is non-differentiable by design (module docstring): its
    while_loops reject reverse-mode AD outright, so ANY symbolic
    dependence of ray origins/directions on differentiated leaves — even
    zero-tangent ones introduced by fused tables joining geometry and
    material columns — must be severed at the tracer boundary."""
    sg = jax.lax.stop_gradient
    return (Vec3(sg(o.x), sg(o.y), sg(o.z)),
            Vec3(sg(d.x), sg(d.y), sg(d.z)))


def _detach_hit(h: Hit) -> Hit:
    """Detach tracer OUTPUTS too: a pallas_call has no JVP rule, and the
    linearization otherwise tries to differentiate through the kernel even
    when every tangent reaching it is zero. Hit quantities are geometric
    (never parameter-dependent), so this is semantics-preserving — and it
    makes gradients identical across tracer backends
    (tests/test_gradients.py::TestGradThroughTracers)."""
    sg = jax.lax.stop_gradient
    return Hit(t=sg(h.t), tri=h.tri, u=sg(h.u), v=sg(h.v))


def _walk_kernel(mesh, bvh, any_hit: bool):
    """The per-ray GPU walk over `bvh`. Its tables are packed here, where
    the pass builds its tracers, so a bounce loop reads them and never
    packs them again; its inputs and hits are detached like every
    tracer's."""
    from fermat_tpu.ops import gpu_bvh_walk

    tables = gpu_bvh_walk.pack(bvh, mesh)
    sg = jax.lax.stop_gradient

    def f(o, d, tmin, tmax, active):
        args = (o, d, sg(tmin), sg(tmax), sg(active))
        if any_hit:
            return gpu_bvh_walk.trace_any_walk(tables, *args)
        return _detach_hit(gpu_bvh_walk.trace_closest_walk(tables, *args))

    return f


def make_tracer(mesh, bvh, opts: PTOptions, any_hit: bool = False):
    """The closest-hit (or, with `any_hit`, occlusion) trace over `mesh`
    that PTOptions.tracer routes to (platform.tracer_for), with the rays
    detached at its boundary. Signature: (o, d, tmin, tmax, active)."""
    if any_hit:
        brute = lambda o, d, tmin, tmax, active: trace_any_brute(
            mesh, o, d, tmin, tmax, active)
        walk = lambda o, d, tmin, tmax, active: trace_any(
            bvh, mesh, o, d, tmin, tmax, active)
    else:
        brute = lambda o, d, tmin, tmax, active: trace_closest_brute(
            mesh, o, d, tmin, tmax, active)
        walk = lambda o, d, tmin, tmax, active: trace_closest(
            bvh, mesh, o, d, tmin, tmax, active)
    trace = platform.tracer_for(
        opts.tracer, mesh.n_triangles, brute=brute, walk=walk,
        kernel=lambda: _walk_kernel(mesh, bvh, any_hit))

    def f(o, d, tmin, tmax, active):
        o, d = _detach_rays(o, d)
        return trace(o, d, tmin, tmax, active)

    return f


def _pick_tracers(view: SceneView, opts: PTOptions):
    """(closest, anyhit) over the scene's geometry (make_tracer)."""
    return (make_tracer(view.mesh, view.bvh, opts),
            make_tracer(view.mesh, view.bvh, opts, any_hit=True))


def _pick_shadow_anyhits(view: SceneView, opts: PTOptions, anyhit):
    """(direct, indirect) NEE shadow tracers honoring the material
    FLAG_SHADOW_*_IGNORE bits (optix_base_shadow_shaders.h any-hit masks;
    direct NEE rays carry mask 0x1, indirect 0x2 — pathtracer_core.h:981,
    :1099). Falls back to the plain occlusion tracer when no material is
    flagged. Static per strategy: bounce 0 is peeled (direct), the loop
    bounces are indirect."""
    if view.shadow_sets is None:
        return anyhit, anyhit
    out = []
    for ss in view.shadow_sets:
        out.append(anyhit if ss is None
                   else make_tracer(ss.mesh, ss.bvh, opts, any_hit=True))
    return out[0], out[1]


class _PassOutput(NamedTuple):
    """Raw per-pixel sample images of one progressive pass ((N,) lanes)."""

    direct: Vec3
    diffuse: Vec3
    specular: Vec3
    composited: Vec3
    diffuse_albedo: Vec3
    specular_albedo: Vec3
    # first-hit gbuffer
    depth: Array
    tri: Array
    normal: Vec3
    position: Vec3
    uv: Array
    material: Array
    rays: Array  # scalar: rays traced this pass
    # (N,) per-lane rays traced (tile attribution / load balance without a
    # shard_map recompile). Default None: other integrators reusing this
    # output type don't track it.
    rays_lane: Optional[Array] = None


class Carry(NamedTuple):
    """Per-lane wavefront state threaded through the bounce loop.

    Module-level (not a render_pass local) so instances can cross jit
    boundaries with a stable pytree type: the narrowing driver
    (render_pass_narrow) passes carries between separately-jitted bounce
    segments, and a per-call class would bust every jit cache."""

    o: Vec3
    d: Vec3
    thr: Vec3  # path throughput (includes 1/pdf)
    alive: Array
    prev_pdf: Array  # solid-angle pdf of the ray's BSDF sample
    channel: Array  # routing decided at first scatter
    l_direct: Vec3
    l_diffuse: Vec3
    l_specular: Vec3
    # gbuffer capture (first hit)
    g_depth: Array
    g_tri: Array
    g_normal: Vec3
    g_pos: Vec3
    g_uv: Array
    g_mat: Array
    g_diff_albedo: Vec3
    g_spec_albedo: Vec3
    rays: Array  # scalar f32 — total traced rays (closest + shadow)
    rays_lane: Array  # (N,) f32 — per-lane traced-ray counter
    cone_width: Array  # ray-cone footprint radius (texture LOD)
    pix_u: Array  # pixel id per lane (moves with the lane when queued)
    lane0: Array  # original lane index (to unpermute queued output)


def _offset_origin(pos: Vec3, gn: Vec3, d: Vec3, eps: float) -> Vec3:
    """Offset along the geometric normal on the side the ray departs."""
    side = jnp.where(dot(gn, d) >= 0.0, 1.0, -1.0)
    return pos + gn * (side * eps)


def direct_env_image(view: SceneView, res_x: int, res_y: int,
                     instance: Array, seed: int = 0):
    """(N, 3) directly-visible environment radiance (camera-ray misses)
    plus the ray count spent.

    The MCMC renderers' path spaces cover only surface-interaction chains;
    the pixel integral decomposes as [direct env] + [surface paths], so
    this deterministic QMC term is added OUTSIDE the chains with no
    overlap (their vertex evals never produce env contributions).
    Statically returns zeros for env-free scenes."""
    n = res_x * res_y
    try:
        has_env = (view.env_map is not None) or bool(
            (np.asarray(jax.device_get(view.env)) != 0.0).any())
    except Exception:  # traced env: keep the term
        has_env = True
    if not has_env:
        return jnp.zeros((n, 3)), jnp.zeros(())
    from fermat_tpu.scene.envmap import scene_env_radiance

    closest, _ = _pick_tracers(view, PTOptions())
    seq = TiledSequence.create(seed).set_instance(instance)
    pix = jnp.arange(n, dtype=jnp.uint32)
    jx, jy = seq.sample_2d(pix, jnp.uint32(0))
    o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy, pix)
    hit = closest(o, d, jnp.float32(1e-4), jnp.float32(3.0e38),
                  jnp.ones(n, bool))
    missed = ~hit.hit_mask
    e = scene_env_radiance(view, Vec3(d.x, d.y, d.z))
    img = jnp.stack([
        jnp.where(missed, e.x, 0.0),
        jnp.where(missed, e.y, 0.0),
        jnp.where(missed, e.z, 0.0),
    ], axis=-1)
    return img, jnp.asarray(n, jnp.float32)


def render_pass(
    view: SceneView,
    opts: PTOptions,
    res_x: int,
    res_y: int,
    instance: Array,
    seed: int = 0,
    pix: Array = None,
    sequence=None,
    _carry_in: "Carry" = None,
    _b: Array = None,
    _raw: bool = False,
) -> _PassOutput:
    """Trace one progressive pass (PathTracer::render, pathtracer_impl.h:197).

    `pix` defaults to the full pixel grid; tile-sharded rendering
    (fermat_tpu.parallel) passes each shard's pixel-id slice. `sequence`
    overrides the sampler — the MCMC integrators drive the same path-tracing
    machinery from mutated primary-sample vectors (the reference's
    TPrimaryCoordinates policy, bpt_samplers.h:43-121).

    Private segment hooks (render_pass_narrow): `_carry_in` + `_b` run ONE
    loop bounce (first=False) on an existing carry of any width and return
    the raw Carry; `_raw` alone runs the peeled bounce 0 and returns its
    raw Carry instead of assembling a _PassOutput.
    """
    if pix is None:
        pix = jnp.arange(res_x * res_y, dtype=jnp.uint32)
    n = pix.shape[0]
    if sequence is not None:
        seq = sequence
    elif opts.sampler == "bluenoise":
        from fermat_tpu.core.rng import BlueNoiseSequence

        seq = BlueNoiseSequence.create(
            seed=seed, res_x=res_x).set_instance(instance)
    else:
        seq = TiledSequence.create(seed=seed).set_instance(instance)
    closest, anyhit = _pick_tracers(view, opts)
    anyhit_direct, anyhit_indirect = _pick_shadow_anyhits(view, opts, anyhit)

    light_compact = (None if opts.nee != "mesh"
                     else _light_compact_tables(view))

    if _carry_in is None:
        jx, jy = seq.sample_2d(pix, jnp.uint32(0))
        o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy, pix)

    zero3 = Vec3.zeros((n,))
    eps = opts.ray_eps
    # primary ray-cone spread angle ~ one pixel (pathtracer cone init)
    cone_spread = jnp.tan(view.camera.fov * 0.5) * 2.0 / res_x
    # hoist the 52-col geometry+material join out of the bounce loop
    # (XLA keeps it inside fori_loops otherwise; see MeshView.shade_fetch)
    shade_tab = view.mesh.shade_rows()

    carry = None if _carry_in is not None else Carry(
        o=o,
        d=d,
        thr=Vec3.full((n,), 1.0, 1.0, 1.0),
        alive=jnp.ones(n, bool),
        prev_pdf=jnp.zeros(n, jnp.float32),
        channel=jnp.full(n, CH_DIRECT, jnp.int32),
        l_direct=zero3,
        l_diffuse=zero3,
        l_specular=zero3,
        g_depth=jnp.full(n, jnp.inf, jnp.float32),
        g_tri=jnp.full(n, -1, jnp.int32),
        g_normal=zero3,
        g_pos=zero3,
        g_uv=jnp.zeros((n, 2), jnp.float32),
        g_mat=jnp.full(n, -1, jnp.int32),
        g_diff_albedo=zero3,
        g_spec_albedo=zero3,
        rays=jnp.zeros((), jnp.float32),
        rays_lane=jnp.zeros(n, jnp.float32),
        cone_width=jnp.zeros(n, jnp.float32),
        pix_u=pix,
        lane0=jnp.arange(n, dtype=jnp.int32),
    )

    def add_routed(c: Carry, contrib: Vec3, mask: Array, channel: Array) -> Carry:
        m = mask
        def acc(dst: Vec3, sel: Array) -> Vec3:
            w = m & (channel == sel)
            return Vec3(
                dst.x + jnp.where(w, contrib.x, 0.0),
                dst.y + jnp.where(w, contrib.y, 0.0),
                dst.z + jnp.where(w, contrib.z, 0.0),
            )
        return c._replace(
            l_direct=acc(c.l_direct, CH_DIRECT),
            l_diffuse=acc(c.l_diffuse, CH_DIFFUSE),
            l_specular=acc(c.l_specular, CH_SPECULAR),
        )

    def bounce(b, c: Carry, first: bool) -> Carry:
        # `first` is static (bounce 0 is peeled); `b` is traced inside the
        # fori_loop over bounces 1..max — keeps the compiled graph at ~2
        # bounce bodies instead of max_path_length.
        # NEE shadow rays pick the per-strategy masked-geometry tracer
        # (direct at the peeled bounce, indirect in the loop)
        # width from the carry, NOT the closure `n`: the narrowing driver
        # (render_pass_narrow) re-enters this body on live-compacted
        # buffers smaller than the pixel grid
        n = c.alive.shape[0]
        sh_anyhit = anyhit_direct if first else anyhit_indirect
        hit = closest(c.o, c.d, jnp.float32(eps), jnp.float32(3.0e38), c.alive)
        c = c._replace(rays=c.rays + jnp.sum(c.alive.astype(jnp.float32)),
                       rays_lane=c.rays_lane + c.alive.astype(jnp.float32))
        valid = c.alive & hit.hit_mask
        missed = c.alive & ~hit.hit_mask
        if view.env_map is None:
            # constant environment light: miss lanes pick up thr * env. No
            # NEE strategy samples the env, so the weight is 1 (no MIS
            # competition).
            c = add_routed(
                c,
                Vec3(c.thr.x * view.env[0], c.thr.y * view.env[1],
                     c.thr.z * view.env[2]),
                missed,
                c.channel,
            )
        else:
            # textured infinite light (scene.envmap): miss lanes pick up
            # the map radiance scaled by view.env, MIS-weighted against
            # the env-NEE strategy at the PREVIOUS vertex (camera rays at
            # the peeled bounce have no competing strategy -> weight 1)
            e_l = view.env_map.eval(c.d)
            e_l = Vec3(e_l.x * view.env[0], e_l.y * view.env[1],
                       e_l.z * view.env[2])
            if first:
                w_env = jnp.ones(n, jnp.float32)
            else:
                is_direct = jnp.asarray(b, jnp.int32) == 1
                pdf_e = jax.lax.stop_gradient(view.env_map.pdf(c.d))
                w_pow = jax.lax.stop_gradient(
                    power_heuristic(c.prev_pdf, pdf_e))
                nee_mask = jnp.where(
                    is_direct, opts.direct_lighting_nee,
                    opts.indirect_lighting_nee)
                w_env = jnp.where(nee_mask, w_pow, 1.0)
                show_mask = jnp.where(
                    is_direct, opts.direct_lighting_bsdf,
                    opts.indirect_lighting_bsdf)
                w_env = w_env * show_mask.astype(jnp.float32)
            c = add_routed(
                c,
                Vec3(c.thr.x * e_l.x * w_env, c.thr.y * e_l.y * w_env,
                     c.thr.z * e_l.z * w_env),
                missed,
                c.channel,
            )
        tri_c = jnp.maximum(hit.tri, 0)
        # fused one-row shade fetch: geometry + material + lod in a single
        # table lookup
        pos, gn, sn, uv, mat_id, lod_base, mats = view.mesh.shade_fetch(
            tri_c, hit.u, hit.v, table=shade_tab
        )
        wi = -c.d  # towards the previous vertex

        # flip shading frame to the ray side of the geometric surface
        flip = jnp.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        gn_f = gn * flip
        sn_f = sn * flip
        t_b, b_b = orthonormal_basis(sn_f)
        wi_loc = to_local(wi, t_b, b_b, sn_f)

        params = BsdfParams.from_materials(mats)

        # ---- texture modulation with ray-cone LOD (texture_view.h sampling
        # + pathtracer_core.h cone tracking) ----
        cone_w = c.cone_width + jnp.where(valid, hit.t, 0.0) * cone_spread
        c = c._replace(cone_width=cone_w)
        if view.has_textures:
            from fermat_tpu.scene.textures import modulate

            d_tex = mats.diffuse_map
            s_tex = mats.specular_map
            if opts.texture_filter == "trilinear":
                res0 = view.textures.width[jnp.maximum(d_tex, 0), 0].astype(jnp.float32)
                lod = (
                    lod_base
                    + jnp.log2(jnp.maximum(cone_w, 1e-8))
                    + jnp.log2(jnp.maximum(res0, 1.0))
                )
                rgba_d = view.textures.sample(d_tex, uv[:, 0], uv[:, 1], lod)
                rgba_s = view.textures.sample(s_tex, uv[:, 0], uv[:, 1], lod)
            else:
                rgba_d = view.textures.sample_bilinear0(d_tex, uv[:, 0], uv[:, 1])
                rgba_s = view.textures.sample_bilinear0(s_tex, uv[:, 0], uv[:, 1])
            params = params._replace(
                diffuse=modulate(params.diffuse, rgba_d),
                specular=modulate(params.specular, rgba_s),
            )

        # ---- gbuffer at the first hit (renderer_view GBuffer) ----
        if first:
            c = c._replace(
                g_depth=jnp.where(valid, hit.t, jnp.inf),
                g_tri=jnp.where(valid, hit.tri, -1),
                g_normal=Vec3(
                    jnp.where(valid, sn_f.x, 0.0),
                    jnp.where(valid, sn_f.y, 0.0),
                    jnp.where(valid, sn_f.z, 0.0),
                ),
                g_pos=Vec3(
                    jnp.where(valid, pos.x, 0.0),
                    jnp.where(valid, pos.y, 0.0),
                    jnp.where(valid, pos.z, 0.0),
                ),
                g_uv=jnp.where(valid[:, None], uv, 0.0),
                g_mat=jnp.where(valid, mat_id, -1),
                g_diff_albedo=Vec3(
                    jnp.where(valid, params.diffuse.x, 0.0),
                    jnp.where(valid, params.diffuse.y, 0.0),
                    jnp.where(valid, params.diffuse.z, 0.0),
                ),
                g_spec_albedo=Vec3(
                    jnp.where(valid, params.specular.x, 0.0),
                    jnp.where(valid, params.specular.y, 0.0),
                    jnp.where(valid, params.specular.z, 0.0),
                ),
            )

        # ---- emissive accumulation (pathtracer_core.h shade_vertex head) ----
        show = opts.visible_lights if first else (
            opts.direct_lighting_bsdf or opts.indirect_lighting_bsdf
        )
        if show:
            # emissive from the already-gathered material row (saves a
            # second one-hot fetch per bounce)
            front_e = dot(gn, wi) > 0.0
            le = Vec3(
                jnp.where(front_e, mats.emissive.x, 0.0),
                jnp.where(front_e, mats.emissive.y, 0.0),
                jnp.where(front_e, mats.emissive.z, 0.0),
            )
            if view.has_textures and _any_emissive_maps(view):
                # textured emitters: modulate by the emissive map at the
                # hit (mesh_lights.cu texture_lookup on material.emissive);
                # statically skipped when NO material carries one (the
                # sample still gathers texels before selecting white)
                from fermat_tpu.scene.textures import modulate

                rgba_e = view.textures.sample(
                    mats.emissive_map, uv[:, 0], uv[:, 1], None
                )
                le = modulate(le, rgba_e)
            if first:
                w_mis = jnp.ones(n, jnp.float32)
            else:
                # MIS vs the NEE strategy that could have sampled this
                # emitter: the NEE at vertex b-1 (direct when b == 1).
                is_direct = jnp.asarray(b, jnp.int32) == 1
                if opts.nee == "vpl":
                    # VPL density: lum(Le at the hit) / emission integral
                    pdf_area = (
                        0.2126 * le.x + 0.7152 * le.y + 0.0722 * le.z
                    ) / jnp.maximum(view.vpls.norm, 1e-20)
                else:
                    pdf_area = view.lights.pdf_area_of(tri_c)
                # miss lanes carry t = 3e38: t*t overflows to inf and
                # 0 * inf = NaN would poison masked-lane cotangents
                t_safe = jnp.where(valid, hit.t, 1.0)
                dist2 = t_safe * t_safe
                cos_l = jnp.abs(dot(gn, wi))
                pdf_sa = pdf_area * dist2 / jnp.maximum(cos_l, 1e-8)
                w_pow = jax.lax.stop_gradient(power_heuristic(c.prev_pdf, pdf_sa))
                nee_mask = jnp.where(
                    is_direct, opts.direct_lighting_nee, opts.indirect_lighting_nee
                )
                w_mis = jnp.where(nee_mask, w_pow, 1.0)
                # gate display of this strategy per depth
                show_mask = jnp.where(
                    is_direct, opts.direct_lighting_bsdf, opts.indirect_lighting_bsdf
                )
                w_mis = w_mis * show_mask.astype(jnp.float32)
            contrib = Vec3(
                c.thr.x * le.x * w_mis, c.thr.y * le.y * w_mis, c.thr.z * le.z * w_mis
            )
            if opts.detach_emissive:
                contrib = Vec3(*(jax.lax.stop_gradient(a) for a in contrib))
            c = add_routed(c, contrib, valid, c.channel)

        # ---- NEE: mesh lights (shade_vertex direct lighting) ----
        # env NEE consumes one extra aligned sample_2d pair per bounce
        # (sample_2d pairs dims by d >> 1, so the pair must start on an
        # even offset that no other strategy's pair shares)
        stride = (opts.dims_per_bounce if view.env_map is None
                  else max(opts.dims_per_bounce, 10))
        if view.area_lights is not None and view.area_lights.count > 0:
            # analytic area lights consume 2 aligned dims each after the
            # env pair (offsets 10, 12, ...)
            stride = max(stride, 10 + 2 * view.area_lights.count)
        base_dim = jnp.uint32(2) + jnp.asarray(b, jnp.uint32) * jnp.uint32(
            stride
        )
        nee_on = opts.direct_lighting_nee if first else opts.indirect_lighting_nee
        if nee_on:
            ul0, ul1, ul2 = seq.sample_3d(c.pix_u, base_dim)
            if opts.debug_nee_fixed_light:
                lpos = Vec3(jnp.zeros(n), jnp.full(n, 1.9), jnp.zeros(n))
                ln = Vec3(jnp.zeros(n), jnp.full(n, -1.0), jnp.zeros(n))
                lle = Vec3.full((n,), 10.0, 10.0, 10.0)
                lpdf_a = jnp.full(n, 1.0)
            elif opts.nee == "vpl" and view.vpls is not None:
                # uniform pick from the presampled emission-proportional
                # VPL set (mesh_lights.cu VPL mode; Le already textured)
                lpos, ln, lle, lpdf_a, _ltri = view.vpls.sample(ul2)
            elif light_compact is not None:
                lpos, ln, lle, lpdf_a, (_lr, _lb0, _lb1) = (
                    _sample_lights_compact(light_compact, ul0, ul1, ul2))
                if view.has_textures and _any_emissive_maps(view):
                    from fermat_tpu.scene.textures import modulate as _mod

                    luv_u = _lr[:, 16] + _lr[:, 18] * _lb0 + _lr[:, 20] * _lb1
                    luv_v = _lr[:, 17] + _lr[:, 19] * _lb0 + _lr[:, 21] * _lb1
                    lemap = _lr[:, 22].astype(jnp.int32)
                    rgba_l = view.textures.sample(lemap, luv_u, luv_v, None)
                    lle = _mod(lle, rgba_l)
            else:
                if view.has_textures and _any_emissive_maps(view):
                    (lpos, ln, lle, lpdf_a, _ltri, luv_u, luv_v,
                     lemap) = view.lights.sample_ex(view.mesh, ul0, ul1, ul2)
                    from fermat_tpu.scene.textures import modulate as _mod

                    rgba_l = view.textures.sample(lemap, luv_u, luv_v, None)
                    lle = _mod(lle, rgba_l)
                else:
                    lpos, ln, lle, lpdf_a, _ltri = view.lights.sample(
                        view.mesh, ul0, ul1, ul2
                    )
            to_l = lpos - pos
            dist2 = jnp.maximum(dot(to_l, to_l), 1e-12)
            dist = jnp.sqrt(dist2)
            wo = to_l * (1.0 / dist)
            cos_l = dot(ln, -wo)  # light must face the shading point
            wo_loc = to_local(wo, t_b, b_b, sn_f)
            if opts.debug_nee_cheap_eval:
                from fermat_tpu.core.sampling import INV_PI as _IP

                lam = jnp.where((wi_loc.z * wo_loc.z) > 0.0, _IP, 0.0)
                fd = Vec3(params.diffuse.x * lam, params.diffuse.y * lam, params.diffuse.z * lam)
                fg = Vec3.zeros((n,))
                bsdf_pdf = jnp.abs(wo_loc.z) * _IP
            else:
                fd, fg, bsdf_pdf = f_split(params, wi_loc, wo_loc, opts.lobes, opts.clearcoat, opts.glossy_model)
            pdf_sa = jax.lax.stop_gradient(
                lpdf_a * dist2 / jnp.maximum(jnp.abs(cos_l), 1e-8)
            )
            bsdf_on = opts.direct_lighting_bsdf if first else opts.indirect_lighting_bsdf
            w_mis = (
                jax.lax.stop_gradient(power_heuristic(pdf_sa, bsdf_pdf))
                if bsdf_on
                else jnp.ones(n, jnp.float32)
            )
            cos_s = jnp.abs(wo_loc.z)
            able = (
                valid
                & view.lights.has_lights
                & (cos_l > 1e-6)
                & (pdf_sa > 1e-12)
                & ((fd.x + fd.y + fd.z + fg.x + fg.y + fg.z) > 0.0)
            )
            so = _offset_origin(pos, gn, wo, eps)
            if opts.debug_nee_no_shadow:
                occluded = jnp.zeros(n, bool)
            else:
                occluded = sh_anyhit(so, wo, jnp.float32(0.0), dist * (1.0 - 1e-3), able)
            c = c._replace(rays=c.rays + jnp.sum(able.astype(jnp.float32)),
                       rays_lane=c.rays_lane + able.astype(jnp.float32))
            lit = able & ~occluded
            scale = cos_s * w_mis / jnp.maximum(pdf_sa, 1e-12)
            if opts.detach_nee:
                scale = jax.lax.stop_gradient(scale)
                fd = Vec3(*(jax.lax.stop_gradient(a) for a in fd))
                fg = Vec3(*(jax.lax.stop_gradient(a) for a in fg))
                lle = Vec3(*(jax.lax.stop_gradient(a) for a in lle))
            wX = c.thr.x * lle.x * scale
            wY = c.thr.y * lle.y * scale
            wZ = c.thr.z * lle.z * scale
            if first:
                # split routing: diffuse part -> DIFFUSE, glossy -> SPECULAR
                c = c._replace(
                    l_diffuse=Vec3(
                        c.l_diffuse.x + jnp.where(lit, fd.x * wX, 0.0),
                        c.l_diffuse.y + jnp.where(lit, fd.y * wY, 0.0),
                        c.l_diffuse.z + jnp.where(lit, fd.z * wZ, 0.0),
                    ),
                    l_specular=Vec3(
                        c.l_specular.x + jnp.where(lit, fg.x * wX, 0.0),
                        c.l_specular.y + jnp.where(lit, fg.y * wY, 0.0),
                        c.l_specular.z + jnp.where(lit, fg.z * wZ, 0.0),
                    ),
                )
            else:
                contrib = Vec3((fd.x + fg.x) * wX, (fd.y + fg.y) * wY, (fd.z + fg.z) * wZ)
                c = add_routed(c, contrib, lit, c.channel)

        # ---- NEE: environment map (infinite light, importance-sampled
        # from the luminance*sin(theta) CDF; MIS vs the BSDF strategy
        # which can also reach the env on a miss) ----
        if view.env_map is not None and nee_on:
            ue0, ue1 = seq.sample_2d(c.pix_u, base_dim + jnp.uint32(8))
            wo_e, pdf_e, le_e = view.env_map.sample(ue0, ue1)
            pdf_e = jax.lax.stop_gradient(pdf_e)
            le_e = Vec3(le_e.x * view.env[0], le_e.y * view.env[1],
                        le_e.z * view.env[2])
            wo_le = to_local(wo_e, t_b, b_b, sn_f)
            fde, fge, bpdf_e = f_split(
                params, wi_loc, wo_le, opts.lobes, opts.clearcoat,
                opts.glossy_model)
            bsdf_on = (opts.direct_lighting_bsdf if first
                       else opts.indirect_lighting_bsdf)
            w_mis_e = (
                jax.lax.stop_gradient(power_heuristic(pdf_e, bpdf_e))
                if bsdf_on else jnp.ones(n, jnp.float32)
            )
            cos_se = jnp.abs(wo_le.z)
            able_e = (
                valid
                & (pdf_e > 1e-12)
                & ((fde.x + fde.y + fde.z + fge.x + fge.y + fge.z) > 0.0)
            )
            so_e = _offset_origin(pos, gn, wo_e, eps)
            occ_e = sh_anyhit(so_e, wo_e, jnp.float32(0.0),
                              jnp.float32(3.0e38), able_e)
            c = c._replace(rays=c.rays + jnp.sum(able_e.astype(jnp.float32)),
                       rays_lane=c.rays_lane + able_e.astype(jnp.float32))
            lit_e = able_e & ~occ_e
            scale_e = cos_se * w_mis_e / jnp.maximum(pdf_e, 1e-12)
            if opts.detach_nee:
                scale_e = jax.lax.stop_gradient(scale_e)
                fde = Vec3(*(jax.lax.stop_gradient(a) for a in fde))
                fge = Vec3(*(jax.lax.stop_gradient(a) for a in fge))
                le_e = Vec3(*(jax.lax.stop_gradient(a) for a in le_e))
            wXe = c.thr.x * le_e.x * scale_e
            wYe = c.thr.y * le_e.y * scale_e
            wZe = c.thr.z * le_e.z * scale_e
            if first:
                c = c._replace(
                    l_diffuse=Vec3(
                        c.l_diffuse.x + jnp.where(lit_e, fde.x * wXe, 0.0),
                        c.l_diffuse.y + jnp.where(lit_e, fde.y * wYe, 0.0),
                        c.l_diffuse.z + jnp.where(lit_e, fde.z * wZe, 0.0),
                    ),
                    l_specular=Vec3(
                        c.l_specular.x + jnp.where(lit_e, fge.x * wXe, 0.0),
                        c.l_specular.y + jnp.where(lit_e, fge.y * wYe, 0.0),
                        c.l_specular.z + jnp.where(lit_e, fge.z * wZe, 0.0),
                    ),
                )
            else:
                contrib = Vec3((fde.x + fge.x) * wXe, (fde.y + fge.y) * wYe,
                               (fde.z + fge.z) * wZe)
                c = add_routed(c, contrib, lit_e, c.channel)

        # ---- NEE: analytic area lights (lights.h:175-249 DiskLight form;
        # invisible to BSDF rays like the reference, whose intersect_impl
        # is a TODO returning t = -1 — so NEE weight is 1, no MIS) ----
        if view.area_lights is not None and view.area_lights.count > 0 and nee_on:
            for li in range(view.area_lights.count):
                ua0, ua1 = seq.sample_2d(
                    c.pix_u, base_dim + jnp.uint32(10 + 2 * li)
                )
                lpos, ln, lle, lpdf_a = view.area_lights.sample(li, ua0, ua1)
                to_l = lpos - pos
                dist2 = jnp.maximum(dot(to_l, to_l), 1e-12)
                dist = jnp.sqrt(dist2)
                wo = to_l * (1.0 / dist)
                cos_l = dot(ln, -wo)
                wo_loc = to_local(wo, t_b, b_b, sn_f)
                fd, fg, _ = f_split(params, wi_loc, wo_loc, opts.lobes,
                                    opts.clearcoat, opts.glossy_model)
                pdf_sa = jax.lax.stop_gradient(
                    lpdf_a * dist2 / jnp.maximum(jnp.abs(cos_l), 1e-8)
                )
                cos_s = jnp.abs(wo_loc.z)
                able = (
                    valid & (cos_l > 1e-6) & (pdf_sa > 1e-12)
                    & ((fd.x + fd.y + fd.z + fg.x + fg.y + fg.z) > 0.0)
                )
                so = _offset_origin(pos, gn, wo, eps)
                occluded = sh_anyhit(so, wo, jnp.float32(0.0),
                                     dist * (1.0 - 1e-3), able)
                c = c._replace(rays=c.rays + jnp.sum(able.astype(jnp.float32)),
                       rays_lane=c.rays_lane + able.astype(jnp.float32))
                lit = able & ~occluded
                scale = cos_s / jnp.maximum(pdf_sa, 1e-12)
                if opts.detach_nee:
                    scale = jax.lax.stop_gradient(scale)
                    fd = Vec3(*(jax.lax.stop_gradient(a) for a in fd))
                    fg = Vec3(*(jax.lax.stop_gradient(a) for a in fg))
                wX = c.thr.x * lle.x * scale
                wY = c.thr.y * lle.y * scale
                wZ = c.thr.z * lle.z * scale
                if first:
                    c = c._replace(
                        l_diffuse=Vec3(
                            c.l_diffuse.x + jnp.where(lit, fd.x * wX, 0.0),
                            c.l_diffuse.y + jnp.where(lit, fd.y * wY, 0.0),
                            c.l_diffuse.z + jnp.where(lit, fd.z * wZ, 0.0),
                        ),
                        l_specular=Vec3(
                            c.l_specular.x + jnp.where(lit, fg.x * wX, 0.0),
                            c.l_specular.y + jnp.where(lit, fg.y * wY, 0.0),
                            c.l_specular.z + jnp.where(lit, fg.z * wZ, 0.0),
                        ),
                    )
                else:
                    contrib = Vec3((fd.x + fg.x) * wX, (fd.y + fg.y) * wY,
                                   (fd.z + fg.z) * wZ)
                    c = add_routed(c, contrib, lit, c.channel)

        # ---- NEE: point lights (delta; lights.h Point) ----
        if view.point_lights.count > 0:
            for li in range(view.point_lights.count):
                lp = view.point_lights
                to_l = Vec3(lp.px[li] - pos.x, lp.py[li] - pos.y, lp.pz[li] - pos.z)
                dist2 = jnp.maximum(dot(to_l, to_l), 1e-12)
                dist = jnp.sqrt(dist2)
                wo = to_l * (1.0 / dist)
                wo_loc = to_local(wo, t_b, b_b, sn_f)
                fd, fg, _ = f_split(params, wi_loc, wo_loc, opts.lobes, opts.clearcoat, opts.glossy_model)
                cos_s = jnp.abs(wo_loc.z)
                able = valid & ((fd.x + fg.x + fd.y + fg.y + fd.z + fg.z) > 0.0)
                so = _offset_origin(pos, gn, wo, eps)
                occluded = sh_anyhit(so, wo, jnp.float32(0.0), dist * (1.0 - 1e-3), able)
                c = c._replace(rays=c.rays + jnp.sum(able.astype(jnp.float32)),
                       rays_lane=c.rays_lane + able.astype(jnp.float32))
                lit = able & ~occluded
                inv_d2 = 1.0 / dist2
                wX = c.thr.x * lp.ix[li] * cos_s * inv_d2
                wY = c.thr.y * lp.iy[li] * cos_s * inv_d2
                wZ = c.thr.z * lp.iz[li] * cos_s * inv_d2
                contrib = Vec3(
                    (fd.x + fg.x) * wX, (fd.y + fg.y) * wY, (fd.z + fg.z) * wZ
                )
                if first:
                    c = c._replace(
                        l_diffuse=Vec3(
                            c.l_diffuse.x + jnp.where(lit, fd.x * wX, 0.0),
                            c.l_diffuse.y + jnp.where(lit, fd.y * wY, 0.0),
                            c.l_diffuse.z + jnp.where(lit, fd.z * wZ, 0.0),
                        ),
                        l_specular=Vec3(
                            c.l_specular.x + jnp.where(lit, fg.x * wX, 0.0),
                            c.l_specular.y + jnp.where(lit, fg.y * wY, 0.0),
                            c.l_specular.z + jnp.where(lit, fg.z * wZ, 0.0),
                        ),
                    )
                else:
                    c = add_routed(c, contrib, lit, c.channel)

        # ---- NEE: directional lights (renderer dir-light pass) ----
        if view.dir_lights.count > 0:
            for li in range(view.dir_lights.count):
                ld = Vec3(
                    view.dir_lights.dir_x[li],
                    view.dir_lights.dir_y[li],
                    view.dir_lights.dir_z[li],
                )
                lc = (
                    view.dir_lights.col_x[li],
                    view.dir_lights.col_y[li],
                    view.dir_lights.col_z[li],
                )
                wo = Vec3(
                    -jnp.broadcast_to(ld.x, (n,)),
                    -jnp.broadcast_to(ld.y, (n,)),
                    -jnp.broadcast_to(ld.z, (n,)),
                )
                wo_loc = to_local(wo, t_b, b_b, sn_f)
                fd, fg, _ = f_split(params, wi_loc, wo_loc, opts.lobes, opts.clearcoat, opts.glossy_model)
                cos_s = jnp.abs(wo_loc.z)
                able = valid & ((fd.x + fg.x + fd.y + fg.y + fd.z + fg.z) > 0.0)
                so = _offset_origin(pos, gn, wo, eps)
                occluded = sh_anyhit(so, wo, jnp.float32(0.0), jnp.float32(3.0e38), able)
                c = c._replace(rays=c.rays + jnp.sum(able.astype(jnp.float32)),
                       rays_lane=c.rays_lane + able.astype(jnp.float32))
                lit = able & ~occluded
                wX = c.thr.x * lc[0] * cos_s
                wY = c.thr.y * lc[1] * cos_s
                wZ = c.thr.z * lc[2] * cos_s
                if first:
                    c = c._replace(
                        l_diffuse=Vec3(
                            c.l_diffuse.x + jnp.where(lit, fd.x * wX, 0.0),
                            c.l_diffuse.y + jnp.where(lit, fd.y * wY, 0.0),
                            c.l_diffuse.z + jnp.where(lit, fd.z * wZ, 0.0),
                        ),
                        l_specular=Vec3(
                            c.l_specular.x + jnp.where(lit, fg.x * wX, 0.0),
                            c.l_specular.y + jnp.where(lit, fg.y * wY, 0.0),
                            c.l_specular.z + jnp.where(lit, fg.z * wZ, 0.0),
                        ),
                    )
                else:
                    contrib = Vec3(
                        (fd.x + fg.x) * wX, (fd.y + fg.y) * wY, (fd.z + fg.z) * wZ
                    )
                    c = add_routed(c, contrib, lit, c.channel)

        # ---- BSDF scatter + RR (shade_vertex tail) ----
        ub0, ub1, ub2 = seq.sample_3d(c.pix_u, base_dim + jnp.uint32(3))
        s = bsdf_sample(params, wi_loc, ub0, ub1, ub2, opts.lobes, opts.clearcoat, opts.glossy_model)
        wo_world = to_world(s.wo, t_b, b_b, sn_f)
        new_thr = Vec3(c.thr.x * s.g.x, c.thr.y * s.g.y, c.thr.z * s.g.z)
        new_alive = valid & s.valid & ((s.g.x + s.g.y + s.g.z) > 0.0)

        if opts.rr and not first:
            u_rr = seq.sample_1d(c.pix_u, base_dim + jnp.uint32(6))
            rr_on = jnp.asarray(b, jnp.int32) >= opts.rr_start_bounce
            q = jnp.clip(jnp.maximum(jnp.maximum(new_thr.x, new_thr.y), new_thr.z), 0.05, 1.0)
            q = jax.lax.stop_gradient(jnp.where(rr_on, q, 1.0))
            keep = u_rr < q
            new_alive = new_alive & keep
            inv_q = 1.0 / q
            new_thr = Vec3(new_thr.x * inv_q, new_thr.y * inv_q, new_thr.z * inv_q)

        # route channel at the first scatter: glossy lobes -> SPECULAR
        if first:
            from fermat_tpu.bsdf.composite import GLOSSY_REFL  # 2; >=2 are glossy
            new_channel = jnp.where(
                valid,
                jnp.where(s.component >= GLOSSY_REFL, CH_SPECULAR, CH_DIFFUSE),
                c.channel,
            )
        else:
            new_channel = c.channel

        # hard-zero dead lanes: masked lanes must carry exact zeros, both so
        # their (garbage) forward values can never leak and so the backward
        # pass doesn't turn 0 * inf into NaN cotangents that poison the
        # gradient sum over lanes
        new_thr = Vec3(
            jnp.where(new_alive, new_thr.x, 0.0),
            jnp.where(new_alive, new_thr.y, 0.0),
            jnp.where(new_alive, new_thr.z, 0.0),
        )
        new_o = _offset_origin(pos, gn, wo_world, eps)
        return c._replace(
            o=new_o,
            d=wo_world,
            thr=new_thr,
            alive=new_alive,
            prev_pdf=s.pdf,
            channel=new_channel,
        )

    def compact_carry(c: Carry) -> Carry:
        """Permute lanes so live ones form a dense prefix (queue-append
        analog via ops/compact; sort-free cumsum permutation). A pure
        reorder — accumulators, pixel ids and lane origins travel with
        their lane, so the estimator is bit-identical."""
        m = c.alive.astype(jnp.int32)
        live_pos = jnp.cumsum(m) - m
        count = jnp.sum(m)
        dead_pos = count + jnp.cumsum(1 - m) - (1 - m)
        dest = jnp.where(c.alive, live_pos, dead_pos).astype(jnp.int32)

        def put(a):
            if not hasattr(a, "ndim") or a.ndim == 0 or a.shape[0] != n:
                return a  # scalar counters
            return jnp.zeros_like(a).at[dest].set(a)

        return jax.tree_util.tree_map(put, c)

    if _carry_in is not None:
        # narrowing-driver segment: ONE loop bounce on a (possibly
        # live-compacted, narrower) carry; `_b` is traced so one compiled
        # program per width serves every bounce index
        return bounce(_b, _carry_in, False)

    # bounce 0 peeled (static routing); bounces 1..max in a fori_loop
    carry = bounce(0, carry, True)
    if _raw:
        return carry
    if opts.max_path_length > 1:
        if opts.queue_compaction:
            body = lambda b, c: bounce(b, compact_carry(c), False)
        else:
            body = lambda b, c: bounce(b, c, False)
        carry = jax.lax.fori_loop(1, opts.max_path_length, body, carry)
    if opts.queue_compaction:
        # unpermute: lane i holds the path that started at lane carry.lane0[i]
        def unput(a):
            if not hasattr(a, "ndim") or a.ndim == 0 or a.shape[0] != n:
                return a
            return jnp.zeros_like(a).at[carry.lane0].set(a)

        carry = jax.tree_util.tree_map(unput, carry)

    comp = Vec3(
        carry.l_direct.x + carry.l_diffuse.x + carry.l_specular.x,
        carry.l_direct.y + carry.l_diffuse.y + carry.l_specular.y,
        carry.l_direct.z + carry.l_diffuse.z + carry.l_specular.z,
    )
    return _PassOutput(
        direct=carry.l_direct,
        diffuse=carry.l_diffuse,
        specular=carry.l_specular,
        composited=comp,
        diffuse_albedo=carry.g_diff_albedo,
        specular_albedo=carry.g_spec_albedo,
        depth=carry.g_depth,
        tri=carry.g_tri,
        normal=carry.g_normal,
        position=carry.g_pos,
        uv=carry.g_uv,
        material=carry.g_mat,
        rays=carry.rays,
        rays_lane=carry.rays_lane,
    )


class _Accum(NamedTuple):
    """Full-width per-pixel accumulators the narrowing driver folds
    finished lanes into (indexed by the carried lane0)."""

    direct: Vec3
    diffuse: Vec3
    specular: Vec3
    rays_lane: Array


class NarrowPass:
    """Host-driven narrowing-wavefront progressive pass.

    The reference's wavefront engine compacts surviving rays into dense
    queues each bounce and launches the next kernel over just the queue
    (path_trace_loop, pathtracer_kernels.h:310-391, with the 4-byte
    queue-size readback at :329). The monolithic `render_pass` instead
    runs every bounce at full pixel-grid width with masked lanes — ideal
    when occupancy stays high, wasteful when most paths die early (a
    bathroom2-class pass keeps <35% of lanes after bounce 0 yet pays
    full-width trace+shade for bounces 1..5).

    This driver is the JAX version of the reference's shrinking queues:

      * bounce 0 runs at full width (render_pass `_raw` hook),
      * between bounces the live count is read back (the same 4-byte
        host<->device boundary the reference pays) and live lanes are
        compacted into the smallest power-of-2 width bucket that holds
        them,
      * each later bounce runs as a separately-jitted one-bounce segment
        (render_pass `_carry_in`/`_b` hooks) at the narrow width — one
        compiled program per width bucket serves every bounce index,
      * finished lanes' radiance folds into full-width accumulators via
        the carried lane0, so the estimator is the same sum re-associated
        (allclose to render_pass; permutation-invariant QMC keys off the
        carried pixel id).

    Not jittable end-to-end (by design: the width choice is data
    dependent). Use for eager progressive loops — bench tools, the CLI
    driver. `render_pass` remains the jittable path.
    """

    def __init__(self, view: SceneView, opts: PTOptions, res_x: int,
                 res_y: int, seed: int = 0, min_width: int = 1 << 13):
        assert not opts.queue_compaction, (
            "narrowing replaces in-loop queue compaction")
        self.view = view
        self.opts = opts
        self.res_x = res_x
        self.res_y = res_y
        self.seed = seed
        self.n = res_x * res_y
        self.min_width = min(min_width, self.n)
        # No buffer donation yet: aliasing the carry and accumulators
        # would only save device-memory copies of pass-through fields, and
        # whether that pays on the GPU is unmeasured (ROADMAP 1.5).

        self._seg0 = jax.jit(lambda inst: render_pass(
            view, opts, res_x, res_y, inst, seed, _raw=True))
        self._seg = {}      # width -> jitted one-bounce segment
        self._shrink = {}   # (W, Wp) -> jitted fold+compact
        self._finish = {}   # width -> jitted final fold

    # -- program builders (cached per static width) --

    def _fold(self, c: Carry, acc: _Accum,
              identity: bool = False) -> Tuple[Carry, _Accum]:
        """Scatter-add every lane's radiance into the full-width
        accumulators and zero the lane copies (lane0 is unique among
        real lanes; compaction fill-lanes carry zeros).

        identity=True: no compaction has happened yet, so lane order IS
        pixel order (lane0 == arange) and the 10 full-width scatter-adds
        (~0.15 s at 1.43M lanes — the entire cost of the first shrink in
        the round-5 segment profile) collapse to plain elementwise adds."""
        if identity:
            addv = lambda dst, src: Vec3(
                dst.x + src.x, dst.y + src.y, dst.z + src.z)
            add1 = lambda dst, src: dst + src
        else:
            lane = c.lane0

            def addv(dst: Vec3, src: Vec3) -> Vec3:
                return Vec3(dst.x.at[lane].add(src.x),
                            dst.y.at[lane].add(src.y),
                            dst.z.at[lane].add(src.z))

            add1 = lambda dst, src: dst.at[lane].add(src)

        acc = _Accum(
            direct=addv(acc.direct, c.l_direct),
            diffuse=addv(acc.diffuse, c.l_diffuse),
            specular=addv(acc.specular, c.l_specular),
            rays_lane=add1(acc.rays_lane, c.rays_lane),
        )
        w = c.alive.shape[0]
        z3 = Vec3.zeros((w,))
        c = c._replace(l_direct=z3, l_diffuse=z3, l_specular=z3,
                       rays_lane=jnp.zeros(w, jnp.float32))
        return c, acc

    def _shrink_body(self, c: Carry, acc: _Accum, wp: int,
                     identity: bool = False):
        """Fold radiance out, then compact live lanes into a wp-wide
        carry. Returns (carry', acc', kept): kept is False iff live lanes
        were DROPPED (live > wp) — only possible under a speculative
        fused schedule, where the caller discards the pass and falls
        back to the exact dynamic loop."""
        w = c.alive.shape[0]
        c, acc = self._fold(c, acc, identity=identity)
        cnt = jnp.sum(c.alive.astype(jnp.int32))
        idx = jnp.nonzero(c.alive, size=wp, fill_value=0)[0]

        # ONE batched row gather instead of ~35 per-leaf 1-D gathers:
        # XLA lowers each separate 1-D gather as a ~7 ns/elem kLoop (the
        # bigroom 1.43M -> 524k shrink measured 0.46 s, round-5 profile).
        # All width-w leaves bit-pun to u32 columns of a single (w, K)
        # matrix; idx then drives one multi-lane row gather.
        leaves, treedef = jax.tree_util.tree_flatten(c)
        cols = []
        recipe = []  # (leaf_pos, dtype, n_trailing_cols) | None
        for li, a in enumerate(leaves):
            if (not hasattr(a, "ndim") or a.ndim == 0
                    or a.shape[0] != w):
                recipe.append(None)  # scalar counters pass through
                continue
            flat = a.reshape(w, -1)
            k = flat.shape[1]
            if a.dtype == jnp.float32:
                u = jax.lax.bitcast_convert_type(flat, jnp.uint32)
            elif a.dtype == jnp.bool_:
                u = flat.astype(jnp.uint32)
            else:  # int32/uint32: two's-complement bit-pun
                u = flat.astype(jnp.uint32)
            recipe.append((a.dtype, a.shape[1:], k))
            cols.append(u)
        mat = jnp.concatenate(cols, axis=1)  # (w, K) u32
        g = mat[idx]  # (wp, K) row gather
        out_leaves = []
        off = 0
        for li, a in enumerate(leaves):
            r = recipe[li]
            if r is None:
                out_leaves.append(a)
                continue
            dtype, trail, k = r
            u = g[:, off:off + k]
            off += k
            if dtype == jnp.float32:
                v = jax.lax.bitcast_convert_type(u, jnp.float32)
            elif dtype == jnp.bool_:
                v = u != 0
            else:
                v = u.astype(dtype)
            out_leaves.append(v.reshape((wp,) + trail))
        c2 = jax.tree_util.tree_unflatten(treedef, out_leaves)
        # fill lanes duplicate index 0: dead, zero accumulators
        valid = jnp.arange(wp, dtype=jnp.int32) < cnt
        return c2._replace(alive=c2.alive & valid), acc, cnt <= wp

    def _get_shrink(self, w: int, wp: int, identity: bool = False):
        key = (w, wp, identity)
        if key not in self._shrink:
            self._shrink[key] = jax.jit(
                lambda c, acc: self._shrink_body(
                    c, acc, wp, identity=identity)[:2])
        return self._shrink[key]

    def _get_seg(self, w: int):
        if w not in self._seg:
            v, o, rx, ry, s = (self.view, self.opts, self.res_x,
                               self.res_y, self.seed)
            fn = lambda c, b, inst: render_pass(
                v, o, rx, ry, inst, s, _carry_in=c, _b=b)
            self._seg[w] = jax.jit(fn)
        return self._seg[w]

    def _get_finish(self, w: int, identity: bool = False):
        key = (w, identity)
        if key not in self._finish:
            self._finish[key] = jax.jit(
                lambda c, acc: self._fold(c, acc, identity=identity)[1])
        return self._finish[key]

    def _bucket(self, live: int) -> int:
        # power-of-2 widths: always a kernel-block multiple once >= the
        # floor, and the program count stays logarithmic
        wp = self.min_width
        while wp < live:
            wp *= 2
        return min(wp, self.n)

    @staticmethod
    def _grab_g(carry: Carry):
        # gbuffer/albedos are final after bounce 0 (lane order == pixel
        # order there: no compaction has happened yet)
        return (carry.g_diff_albedo, carry.g_spec_albedo, carry.g_depth,
                carry.g_tri, carry.g_normal, carry.g_pos, carry.g_uv,
                carry.g_mat)

    @staticmethod
    def _assemble(acc: _Accum, g, rays) -> _PassOutput:
        comp = Vec3(
            acc.direct.x + acc.diffuse.x + acc.specular.x,
            acc.direct.y + acc.diffuse.y + acc.specular.y,
            acc.direct.z + acc.diffuse.z + acc.specular.z,
        )
        return _PassOutput(
            direct=acc.direct,
            diffuse=acc.diffuse,
            specular=acc.specular,
            composited=comp,
            diffuse_albedo=g[0],
            specular_albedo=g[1],
            depth=g[2],
            tri=g[3],
            normal=g[4],
            position=g[5],
            uv=g[6],
            material=g[7],
            rays=rays,
            rays_lane=acc.rays_lane,
        )

    def _zero_acc(self) -> _Accum:
        zero3 = Vec3.zeros((self.n,))
        return _Accum(direct=zero3, diffuse=zero3, specular=zero3,
                      rays_lane=jnp.zeros(self.n, jnp.float32))

    def _dynamic(self, instance) -> _PassOutput:
        """Exact per-bounce loop: read the live count back, pick the
        bucket, run the next jitted segment at that width."""
        carry = self._seg0(jnp.asarray(instance, jnp.uint32))
        g = self._grab_g(carry)
        acc = self._zero_acc()
        w = self.n
        identity = True  # lane order == pixel order until first compact
        self.last_profile = []  # (bounce, live, width) — attribution aid
        for b in range(1, self.opts.max_path_length):
            live = int(jax.device_get(jnp.sum(carry.alive, dtype=jnp.int32)))
            if live == 0:
                break
            wp = self._bucket(live)
            if wp < w:
                carry, acc = self._get_shrink(w, wp, identity)(carry, acc)
                w = wp
                identity = False
            self.last_profile.append((b, live, w))
            carry = self._get_seg(w)(
                carry, jnp.asarray(b, jnp.uint32),
                jnp.asarray(instance, jnp.uint32))
        rays = carry.rays
        acc = self._get_finish(w, identity)(carry, acc)
        return self._assemble(acc, g, rays)

    def __call__(self, instance) -> _PassOutput:
        """Run one pass via the dynamic narrowing loop. (A speculative
        whole-pass fused schedule existed in round 4 and was REMOVED in
        round 5: it lost on bathroom2 (5.01 s vs 4.26 s dynamic) and tied
        on bigroom — segment dispatches are async, so the dynamic loop's
        only real sync is the per-bounce live-count read, which overlaps
        the running segment, while the fused program additionally paid
        headroom-padded widths.)"""
        return self._dynamic(instance)


def render_pass_narrow(view, opts, res_x, res_y, instance, seed=0,
                       min_width: int = 1 << 13) -> _PassOutput:
    """One-shot convenience over NarrowPass (builds + caches the driver
    per (view identity, opts, resolution, seed))."""
    key = (id(view), opts, res_x, res_y, seed, min_width)
    drv = _NARROW_CACHE.get(key)
    if drv is None or drv.view is not view:
        drv = NarrowPass(view, opts, res_x, res_y, seed, min_width)
        # bounded FIFO: SceneViews are NamedTuples (not weakref-able), so
        # an unbounded id-keyed cache would pin every view ever rendered
        while len(_NARROW_CACHE) >= _NARROW_CACHE_MAX:
            _NARROW_CACHE.pop(next(iter(_NARROW_CACHE)))
        _NARROW_CACHE[key] = drv
    else:
        _NARROW_CACHE[key] = _NARROW_CACHE.pop(key)  # LRU refresh
    return drv(instance)


_NARROW_CACHE: dict = {}
_NARROW_CACHE_MAX = 8
