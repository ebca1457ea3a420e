"""HelloPT — the minimal educational path-tracer plugin.

Reference: src/renderers/hellopt* (649 LoC) + hellopt_plugin.cpp:36-40, the
DLL plugin shipped as the plugin-API example. This is the same thing for the
This build: a self-contained ~60-line unidirectional path tracer (BSDF
sampling only, no NEE) registered through the public plugin entry point.

Run:
  python -m fermat_tpu -plugin examples.hellopt_plugin -hellopt \
      -i /root/reference/models/CornellBox/CornellBox-JP.obj \
      -c /root/reference/models/CornellBox/camera-frontal.txt \
      -r 128 128 -passes 16 -o hello.tga
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _hellopt_factory(max_path_length: int = 6, **_):
    from fermat_tpu.bsdf.composite import BsdfParams, sample as bsdf_sample
    from fermat_tpu.core.camera import generate_camera_rays
    from fermat_tpu.core.math import Vec3, dot, orthonormal_basis, to_local, to_world
    from fermat_tpu.core.rng import TiledSequence
    from fermat_tpu.integrators.pt import (
        PTOptions,
        _PassOutput,
        _offset_origin,
        _pick_tracers,
    )
    from fermat_tpu.scene.lights import emitter_radiance

    def render_pass(view, opts, res_x, res_y, instance, seed=0):
        n = res_x * res_y
        pix = jnp.arange(n, dtype=jnp.uint32)
        seq = TiledSequence.create(seed=seed).set_instance(instance)
        closest, _ = _pick_tracers(view, PTOptions())
        jx, jy = seq.sample_2d(pix, jnp.uint32(0))
        o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy)
        thr = Vec3.full((n,), 1.0, 1.0, 1.0)
        L = Vec3.zeros((n,))
        alive = jnp.ones(n, bool)
        rays = jnp.zeros((), jnp.float32)
        for b in range(max_path_length):
            hit = closest(o, d, jnp.float32(1e-4), jnp.float32(3e38), alive)
            rays = rays + jnp.sum(alive.astype(jnp.float32))
            valid = alive & hit.hit_mask
            tri = jnp.maximum(hit.tri, 0)
            pos, gn, sn, uv, mat = view.mesh.interpolate(tri, hit.u, hit.v)
            wi = -d
            flip = jnp.where(dot(gn, wi) < 0.0, -1.0, 1.0)
            sn_f = sn * flip
            le = emitter_radiance(view.mesh, tri, wi, gn=gn, mid=mat)
            L = Vec3(
                L.x + jnp.where(valid, thr.x * le.x, 0.0),
                L.y + jnp.where(valid, thr.y * le.y, 0.0),
                L.z + jnp.where(valid, thr.z * le.z, 0.0),
            )
            t_b, b_b = orthonormal_basis(sn_f)
            params = BsdfParams.from_materials(view.mesh.materials.gather(mat))
            u0, u1, u2 = seq.sample_3d(pix, jnp.uint32(2 + 8 * b))
            s = bsdf_sample(params, to_local(wi, t_b, b_b, sn_f), u0, u1, u2)
            thr = Vec3(thr.x * s.g.x, thr.y * s.g.y, thr.z * s.g.z)
            alive = valid & s.valid
            thr = Vec3(
                jnp.where(alive, thr.x, 0.0),
                jnp.where(alive, thr.y, 0.0),
                jnp.where(alive, thr.z, 0.0),
            )
            o = _offset_origin(pos, gn, to_world(s.wo, t_b, b_b, sn_f), 1e-4)
            d = to_world(s.wo, t_b, b_b, sn_f)
        zero3 = Vec3.zeros((n,))
        return _PassOutput(
            direct=zero3, diffuse=zero3, specular=zero3, composited=L,
            diffuse_albedo=zero3, specular_albedo=zero3,
            depth=jnp.full(n, jnp.inf, jnp.float32),
            tri=jnp.full(n, -1, jnp.int32), normal=zero3, position=zero3,
            uv=jnp.zeros((n, 2), jnp.float32),
            material=jnp.full(n, -1, jnp.int32), rays=rays,
        )

    class _Opts:  # static options token (part of the jit closure)
        pass

    return render_pass, _Opts()


def register_plugin():
    """Plugin entry point (the DLL register_plugin analog)."""
    from fermat_tpu.render.context import register_renderer

    register_renderer("hellopt", _hellopt_factory)
