"""RenderingContext — owns the scene, framebuffer, and renderer registry.

Reference: src/renderer.{h,cu} RenderingContext/RenderingContextImpl
(init pipeline renderer.cu:467-991, render driver :1029-1056, registry
:1020-1025) and RendererInterface (src/renderer_interface.h:45-88).

The context jits one pass function per (renderer, options, resolution)
and reuses the executable across progressive passes — the analog of the
reference binding its POD view and launching kernels per frame, minus any
per-frame host<->device chatter.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.core.camera import Camera
from fermat_tpu.integrators import pt as pt_mod
from fermat_tpu.render.framebuffer import Framebuffer, GBuffer, rmse, to_rgba8, tonemap
from fermat_tpu.scene.mesh import MeshStorage
from fermat_tpu.scene.view import SceneView

# renderer registry (renderer.cu:1020-1025 register_renderer analog).
# Values are factories: options_dict -> (render_pass_fn, options)
_RENDERER_REGISTRY: Dict[str, Callable] = {}


def register_renderer(name: str, factory: Callable) -> None:
    """Plugin entry point (the reference's DLL register_plugin,
    hellopt_plugin.cpp:36-40, maps to a plain Python callable here)."""
    _RENDERER_REGISTRY[name] = factory


def _pt_factory(**kw):
    opts = pt_mod.PTOptions(**kw)
    return pt_mod.render_pass, opts


def _bpt_factory(**kw):
    from fermat_tpu.integrators import bpt as bpt_mod

    opts = bpt_mod.BPTOptions(**kw)
    return bpt_mod.render_pass_fb, opts


def _rpt_factory(**kw):
    from fermat_tpu.integrators import rpt as rpt_mod

    opts = rpt_mod.RPTOptions(**kw)
    return rpt_mod.render_pass_fb, opts


def _mlt_factory(**kw):
    from fermat_tpu.integrators import mlt as mlt_mod

    opts = mlt_mod.MLTOptions(**kw)
    return mlt_mod.render_pass_fb, opts


def _cmlt_factory(**kw):
    from fermat_tpu.integrators import cmlt as cm

    opts = cm.CMLTOptions(**kw)

    def init(view, res_x, res_y, seed):
        n = opts.n_chains if opts.n_chains > 0 else res_x * res_y
        return cm.init_state(view, opts, res_x, res_y, n, seed)

    def pass_fn(view, opts_, res_x, res_y, instance, seed, state):
        from fermat_tpu.core.math import Vec3
        from fermat_tpu.integrators.pt import _PassOutput, direct_env_image

        new_state, splat, rays = cm.step(view, opts_, res_x, res_y, state)
        # directly-visible environment: outside the charted path space,
        # added as an independent QMC term (see pt.direct_env_image)
        env_img, env_rays = direct_env_image(view, res_x, res_y, instance,
                                             seed)
        splat = splat + env_img
        rays = rays + env_rays
        n = res_x * res_y
        comp = Vec3(splat[:, 0], splat[:, 1], splat[:, 2])
        zero3 = Vec3.zeros((n,))
        out = _PassOutput(
            direct=zero3, diffuse=zero3, specular=zero3, composited=comp,
            diffuse_albedo=zero3, specular_albedo=zero3,
            depth=jnp.full(n, jnp.inf, jnp.float32),
            tri=jnp.full(n, -1, jnp.int32), normal=zero3, position=zero3,
            uv=jnp.zeros((n, 2), jnp.float32),
            material=jnp.full(n, -1, jnp.int32),
            rays=rays,
        )
        return out, new_state

    pass_fn.stateful = True
    pass_fn.init = init
    return pass_fn, opts


def _pssmlt_factory(**kw):
    from fermat_tpu.integrators import pssmlt as ps

    opts = ps.PssmltOptions(**kw)

    def init(view, res_x, res_y, seed):
        return ps.init_state(view, opts, res_x, res_y, res_x * res_y, seed)

    def pass_fn(view, opts_, res_x, res_y, instance, seed, state):
        from fermat_tpu.core.math import Vec3
        from fermat_tpu.integrators.pt import _PassOutput

        new_state, splat = ps.step(view, opts_, res_x, res_y, state)
        n = res_x * res_y
        comp = Vec3(splat[:, 0], splat[:, 1], splat[:, 2])
        zero3 = Vec3.zeros((n,))
        out = _PassOutput(
            direct=zero3, diffuse=zero3, specular=zero3, composited=comp,
            diffuse_albedo=zero3, specular_albedo=zero3,
            depth=jnp.full(n, jnp.inf, jnp.float32),
            tri=jnp.full(n, -1, jnp.int32), normal=zero3, position=zero3,
            uv=jnp.zeros((n, 2), jnp.float32),
            material=jnp.full(n, -1, jnp.int32),
            rays=jnp.zeros((), jnp.float32),
        )
        return out, new_state

    pass_fn.stateful = True
    pass_fn.init = init
    return pass_fn, opts


def _psfpt_factory(**kw):
    from fermat_tpu.integrators import psfpt as pp

    opts = pp.PsfptOptions(**kw)

    def init(view, res_x, res_y, seed):
        return pp.init_state(view, opts)

    def pass_fn(view, opts_, res_x, res_y, instance, seed, state):
        from fermat_tpu.core.math import Vec3
        from fermat_tpu.integrators.pt import _PassOutput

        out, new_state, rays = pp.render_pass(
            view, opts_, res_x, res_y, instance, state, seed
        )
        n = res_x * res_y
        zero3 = Vec3.zeros((n,))
        po = _PassOutput(
            direct=zero3, diffuse=zero3, specular=zero3, composited=out,
            diffuse_albedo=zero3, specular_albedo=zero3,
            depth=jnp.full(n, jnp.inf, jnp.float32),
            tri=jnp.full(n, -1, jnp.int32), normal=zero3, position=zero3,
            uv=jnp.zeros((n, 2), jnp.float32),
            material=jnp.full(n, -1, jnp.int32),
            rays=rays,
        )
        return po, new_state

    pass_fn.stateful = True
    pass_fn.init = init
    return pass_fn, opts


def _ptrl_factory(**kw):
    from fermat_tpu.integrators import ptrl as pr
    from fermat_tpu.integrators import rl as rl_mod

    opts = pr.PtrlOptions(**kw)
    clusters_box = {}

    def init(view, res_x, res_y, seed):
        if opts.sampler == "vtl":
            from fermat_tpu.scene.mesh_lights import build_vtls

            vtls, cut = build_vtls(
                view.mesh, target_clusters=opts.n_clusters,
                n_target_vtls=opts.n_vtls,
            )
            clusters_box["c"] = vtls
            clusters_box["cut"] = cut
        else:
            clusters_box["c"] = rl_mod.build_clusters(view.mesh, opts.n_clusters)
        clusters_box["passes"] = 0
        return pr.init_state(view, opts)

    def pass_fn(view, opts_, res_x, res_y, instance, seed, state):
        from fermat_tpu.core.math import Vec3
        from fermat_tpu.integrators.pt import _PassOutput

        # adaptive cluster-cut refinement between passes
        # (clustered_rl_inline.h analog: host cut step + device Q remap)
        clusters_box["passes"] += 1
        cut = clusters_box.get("cut")
        if (
            cut is not None and opts.adapt_every > 0
            and clusters_box["passes"] % opts.adapt_every == 0
        ):
            import numpy as _np

            from fermat_tpu.integrators.rl import RLState
            from fermat_tpu.scene.mesh_lights import reclustered

            value = _np.asarray(state.qstate.q.mean(axis=0))[: cut.n_clusters]
            m = cut.adapt(value)
            if m is not None:
                clusters_box["c"] = reclustered(clusters_box["c"], cut)
                q_new = jnp.matmul(state.qstate.q[:, : m.shape[1]],
                                   jnp.asarray(m).T,
                                   precision=jax.lax.Precision.HIGHEST)
                pad = state.qstate.q.shape[1] - q_new.shape[1]
                if pad > 0:
                    q_new = jnp.concatenate(
                        [q_new, state.qstate.q[:, q_new.shape[1]:]], axis=1
                    )
                state = state._replace(qstate=RLState(q=q_new))

        out, new_state, rays = pr.render_pass(
            view, opts_, clusters_box["c"], res_x, res_y, instance, state, seed
        )
        n = res_x * res_y
        zero3 = Vec3.zeros((n,))
        po = _PassOutput(
            direct=zero3, diffuse=zero3, specular=zero3, composited=out,
            diffuse_albedo=zero3, specular_albedo=zero3,
            depth=jnp.full(n, jnp.inf, jnp.float32),
            tri=jnp.full(n, -1, jnp.int32), normal=zero3, position=zero3,
            uv=jnp.zeros((n, 2), jnp.float32),
            material=jnp.full(n, -1, jnp.int32),
            rays=rays,
        )
        return po, new_state

    pass_fn.stateful = True
    pass_fn.init = init
    return pass_fn, opts


register_renderer("pt", _pt_factory)
register_renderer("bpt", _bpt_factory)
register_renderer("mlt", _mlt_factory)
register_renderer("cmlt", _cmlt_factory)
register_renderer("rpt", _rpt_factory)
register_renderer("pssmlt", _pssmlt_factory)
register_renderer("psfpt", _psfpt_factory)
register_renderer("ptrl", _ptrl_factory)


@dataclass
class RenderingContext:
    view: SceneView
    res_x: int
    res_y: int
    renderer: str = "pt"
    renderer_options: dict = field(default_factory=dict)
    seed: int = 0
    fb: Framebuffer = None
    gbuffer: Optional[dict] = None
    instance: int = 0
    _pass_fn: Optional[Callable] = None
    renderer_state: object = None  # MCMC chain state etc. (stateful renderers)
    stats: dict = field(default_factory=dict)

    @staticmethod
    def create(
        storage: MeshStorage,
        camera: Camera,
        res_x: int,
        res_y: int,
        renderer: str = "pt",
        dir_lights=(),
        seed: int = 0,
        texture_dir=None,
        env_radiance=(0.0, 0.0, 0.0),
        point_lights=(),
        env_map=None,
        **renderer_options,
    ) -> "RenderingContext":
        view = SceneView.build(
            storage, camera, dir_lights, texture_dir=texture_dir,
            env_radiance=env_radiance, point_light_defs=point_lights,
            env_map=env_map,
        )
        if "lobes" not in renderer_options and renderer in (
            "pt", "bpt", "psfpt", "ptrl", "mlt", "cmlt", "rpt"
        ):
            from fermat_tpu.bsdf.composite import scene_lobes

            renderer_options = dict(renderer_options)
            renderer_options["lobes"] = scene_lobes(storage.materials)
        # clearcoat auto-detect (5th layer; PT integrator support)
        if "clearcoat" not in renderer_options and renderer == "pt":
            from fermat_tpu.bsdf.composite import scene_clearcoat

            renderer_options = dict(renderer_options)
            renderer_options["clearcoat"] = scene_clearcoat(storage.materials)
        ctx = RenderingContext(
            view=view,
            res_x=res_x,
            res_y=res_y,
            renderer=renderer,
            renderer_options=renderer_options,
            seed=seed,
        )
        ctx.fb = Framebuffer.create(res_y, res_x)
        return ctx

    def _build_pass(self):
        if self.renderer not in _RENDERER_REGISTRY:
            raise KeyError(
                f"unknown renderer '{self.renderer}'; registered: {sorted(_RENDERER_REGISTRY)}"
            )
        options = dict(self.renderer_options)
        # narrowing-wavefront progressive driver (pt only): live lanes
        # compact into width buckets between jitted one-bounce segments
        # (CLI: -pt ... -opt narrow=1). render() only — render_batch keeps
        # the fully in-graph monolithic loop (narrowing needs a readback).
        narrow = bool(options.pop("narrow", False)) and self.renderer == "pt"
        pass_fn, opts = _RENDERER_REGISTRY[self.renderer](**options)
        res_x, res_y, seed = self.res_x, self.res_y, self.seed
        stateful = getattr(pass_fn, "stateful", False)

        def one_pass(view: SceneView, fb: Framebuffer, instance, state=None,
                     _precomputed=None):
            if _precomputed is not None:
                out = _precomputed  # narrowing driver already ran the pass
            elif stateful:
                out, state = pass_fn(view, opts, res_x, res_y, instance, seed, state)
            else:
                out = pass_fn(view, opts, res_x, res_y, instance, seed)
            shape = (res_y, res_x, 3)
            img = lambda v: jnp.reshape(v.stack(), shape)
            new_fb = fb.accumulate_pass(
                instance,
                img(out.diffuse),
                img(out.specular),
                img(out.direct),
                img(out.composited),
                img(out.diffuse_albedo),
                img(out.specular_albedo),
            )
            gbuf = {
                "normal": img(out.normal),
                "position": img(out.position),
                "miss": jnp.reshape(out.tri < 0, (res_y, res_x)),
                "depth": jnp.reshape(out.depth, (res_y, res_x)),
                # AOV inspection modes (renderer_view.h kUV/kCharts)
                "uv": jnp.reshape(out.uv, (res_y, res_x, 2)),
                "tri": jnp.reshape(out.tri, (res_y, res_x)),
                "material": jnp.reshape(out.material, (res_y, res_x)),
                # per-pass traced-ray counter (closest + shadow; masked
                # dead lanes excluded) — dump_speed_stats' true ray rate
                "rays": out.rays,
            }
            return (new_fb, gbuf, state) if stateful else (new_fb, gbuf)

        self._stateful = stateful
        if stateful and self.renderer_state is None:
            self.renderer_state = pass_fn.init(self.view, res_x, res_y, seed)
        if narrow:
            drv = pt_mod.NarrowPass(self.view, opts, res_x, res_y, seed)
            # the accumulate/gbuffer tail is its own jitted program; the
            # segments inside NarrowPass are jitted individually
            post = jax.jit(lambda fb, out, instance: one_pass(
                None, fb, instance, _precomputed=out))

            def narrow_pass(view, fb, instance):
                return post(fb, drv(instance), instance)

            self._pass_fn = narrow_pass
        else:
            self._pass_fn = jax.jit(one_pass)

    def render(self, n_passes: int = 1, progress: bool = False) -> Framebuffer:
        """Progressive render driver (main.cu:169 / renderer.cu:1029)."""
        if self._pass_fn is None:
            self._build_pass()
        for _ in range(n_passes):
            t0 = time.perf_counter()
            if getattr(self, "_stateful", False):
                self.fb, self.gbuffer, self.renderer_state = self._pass_fn(
                    self.view, self.fb, jnp.uint32(self.instance), self.renderer_state
                )
            else:
                self.fb, self.gbuffer = self._pass_fn(
                    self.view, self.fb, jnp.uint32(self.instance)
                )
            self.fb = jax.block_until_ready(self.fb)
            dt = time.perf_counter() - t0
            self.stats.setdefault("pass_times", []).append(dt)
            if progress:
                print(f"pass {self.instance}: {dt*1e3:.1f} ms")
            self.instance += 1
        return self.fb

    def render_batch(self, n_passes: int) -> Framebuffer:
        """Progressive render with ALL passes inside one jitted fori_loop.

        One dispatch and one host sync for the whole batch instead of one
        per pass. Accumulation math matches render().
        """
        if self._pass_fn is None:
            self._build_pass()
        if getattr(self, "_stateful", False):
            # chain state threading not yet batched in-graph for MCMC
            return self.render(n_passes)
        key = ("batch", n_passes)
        if key not in self.stats:
            # strip driver-level keys the factories don't accept ('narrow'
            # belongs to the render() narrowing driver, not the options
            # NamedTuple — render_batch always runs the monolithic loop)
            options = dict(self.renderer_options)
            options.pop("narrow", None)
            pass_fn, opts = _RENDERER_REGISTRY[self.renderer](**options)
            res_x, res_y, seed = self.res_x, self.res_y, self.seed

            def batch(view: SceneView, fb: Framebuffer, instance0):
                def body(i, fb):
                    out = pass_fn(view, opts, res_x, res_y, instance0 + i, seed)
                    shape = (res_y, res_x, 3)
                    img = lambda v: jnp.reshape(v.stack(), shape)
                    return fb.accumulate_pass(
                        instance0 + i,
                        img(out.diffuse), img(out.specular), img(out.direct),
                        img(out.composited), img(out.diffuse_albedo),
                        img(out.specular_albedo),
                    )

                return jax.lax.fori_loop(0, n_passes, body, fb)

            self.stats[key] = jax.jit(batch)
        t0 = time.perf_counter()
        self.fb = jax.block_until_ready(
            self.stats[key](self.view, self.fb, jnp.uint32(self.instance))
        )
        dt = time.perf_counter() - t0
        self.instance += n_passes
        self.stats.setdefault("batch_times", []).append((n_passes, dt))
        return self.fb

    def restart(self) -> None:
        """Invalidate accumulation (viewer camera-move semantics)."""
        self.fb = Framebuffer.create(self.res_y, self.res_x)
        self.instance = 0

    # -- output ----------------------------------------------------------
    def image(self, exposure: float = 1.0, gamma: float = 2.2) -> np.ndarray:
        return np.asarray(to_rgba8(self.fb.composited, exposure, gamma))

    def hdr_image(self) -> np.ndarray:
        return np.asarray(self.fb.composited)

    def filtered_image(
        self, exposure: float = 1.0, gamma: float = 2.2, method: str = "eaw"
    ) -> np.ndarray:
        """Denoised output (renderer.cu kFiltered path); method: eaw | xbl."""
        from fermat_tpu.render.denoise import denoise

        assert self.gbuffer is not None, "render at least one pass first"
        out = denoise(
            self.fb,
            self.gbuffer["normal"],
            self.gbuffer["position"],
            self.gbuffer["miss"],
            self.view.camera,
            instance=self.instance - 1,
            method=method,
        )
        return np.asarray(to_rgba8(out, exposure, gamma))

    def rmse_vs(self, ref_hdr: np.ndarray) -> float:
        return float(rmse(self.fb.composited, jnp.asarray(ref_hdr)))

    def dump_speed_stats(self, detailed: bool = False) -> dict:
        """Per-stage stats (PathTracer::dump_speed_stats,
        pathtracer_impl.h:342-350).

        The reference emits per-kernel host timers (primary/path/shadow RT,
        path/shadow shade); a whole pass here is ONE fused XLA computation,
        so the per-stage split comes from the device profiler instead:
        `detailed=True` captures one traced pass and buckets device op time
        into rt / shadow_rt / shade (everything else) — the same three
        stage families the reference reports.
        """
        times = self.stats.get("pass_times", [])
        if not times:
            return {}
        steady = times[1:] if len(times) > 1 else times
        out = {
            "passes": len(times),
            "mean_pass_ms": 1e3 * float(np.mean(steady)),
            "first_pass_ms": 1e3 * times[0],
        }
        rays = self.gbuffer.get("rays") if self.gbuffer else None
        if rays is not None:
            out["rays_per_pass"] = float(rays)
            out["rays_per_s"] = float(rays) / float(np.mean(steady))
        else:
            out["primary_rays_per_s"] = (
                self.res_x * self.res_y / float(np.mean(steady)))
        if detailed:
            import tempfile

            from fermat_tpu.utils.profiling import op_breakdown

            with tempfile.TemporaryDirectory() as td:
                with jax.profiler.trace(td):
                    self.render(1)
                stages = {"rt_ms": 0.0, "shadow_rt_ms": 0.0, "shade_ms": 0.0}
                for name, ms, _cnt in op_breakdown(td, top=10_000):
                    low = name.lower()
                    if "any" in low and ("impl" in low or "trace" in low):
                        stages["shadow_rt_ms"] += ms
                    elif "trace" in low or "closest" in low or "_impl" in low:
                        stages["rt_ms"] += ms
                    elif "fusion" in low or "reduce" in low or "copy" in low:
                        stages["shade_ms"] += ms
                out.update(stages)
        return out
