"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Validates the sharded path (SURVEY.md §2.3 equivalents):
sharded == single-device bit-for-bit, and gradients flow with the implicit
psum through shard_map.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fermat_tpu.integrators.pt import PTOptions, render_pass
from fermat_tpu.parallel.mesh import make_mesh, render_pass_sharded, train_step_sharded
from fermat_tpu.scene.procedural import cornell_box, cornell_camera
from fermat_tpu.scene.view import SceneView

# compile-heavy integrator tier — excluded from the default (fast) run
pytestmark = pytest.mark.heavy

RES = 16


def _view():
    return SceneView.build(cornell_box(), cornell_camera())


def _both_passes(view, opts, mesh):
    """The sharded and the single-device pass, each one jitted program
    (op-by-op dispatch of a whole pass takes minutes on the CPU)."""
    sharded = jax.jit(lambda v: render_pass_sharded(
        v, opts, RES, RES, jnp.uint32(0), mesh))
    single = jax.jit(lambda v: render_pass(v, opts, RES, RES, jnp.uint32(0)))
    return sharded(view), single(view)


class TestSharding:
    def test_sharded_matches_single(self):
        view = _view()
        opts = PTOptions(max_path_length=3, rr=False)
        mesh = make_mesh()
        assert mesh.devices.size == 8
        out_s, out_1 = _both_passes(view, opts, mesh)
        np.testing.assert_allclose(
            np.asarray(out_s.composited.x),
            np.asarray(out_1.composited.x),
            rtol=1e-5,
            atol=1e-6,
        )
        assert float(out_s.rays) == float(out_1.rays)

    def test_sharded_matches_single_envmap(self):
        """Env-map scenes shard identically: the map + CDF tables ride the
        replicated view pytree; env NEE runs per-lane inside shard_map."""
        emap = np.zeros((8, 16, 3), np.float32)
        emap[:, :, 2] = 1.0  # blue dome
        emap[2:4, 4:6] = [30.0, 10.0, 1.0]
        view = SceneView.build(cornell_box(light_size=2.0), cornell_camera(),
                               env_map=emap)
        opts = PTOptions(max_path_length=3, rr=False)
        mesh = make_mesh()
        out_s, out_1 = _both_passes(view, opts, mesh)
        np.testing.assert_allclose(
            np.asarray(out_s.composited.x),
            np.asarray(out_1.composited.x),
            rtol=1e-5,
            atol=1e-6,
        )
        assert float(out_s.rays) == float(out_1.rays)

    def test_grad_through_sharded_render(self):
        view = _view()
        opts = PTOptions(max_path_length=2, rr=False)
        mesh = make_mesh()
        target = jnp.zeros((RES * RES, 3), jnp.float32)
        new_view, loss = jax.jit(
            lambda v, t, i: train_step_sharded(v, t, opts, RES, RES, i, mesh)
        )(view, target, jnp.uint32(0))
        assert np.isfinite(float(loss))
        # a dark target must push diffuse albedo DOWN somewhere
        d0 = np.asarray(view.mesh.materials.diffuse.x)
        d1 = np.asarray(new_view.mesh.materials.diffuse.x)
        assert (d1 <= d0 + 1e-7).all()
        assert (d1 < d0 - 1e-5).any()

    @pytest.mark.slow
    def test_grad_matches_unsharded(self):
        view = _view()
        opts = PTOptions(max_path_length=2, rr=False)
        mesh = make_mesh()
        target = jnp.full((RES * RES, 3), 0.1, jnp.float32)

        def loss_unsharded(diffuse):
            mats = view.mesh.materials._replace(diffuse=diffuse)
            v = view._replace(mesh=view.mesh._replace(materials=mats))
            out = render_pass(v, opts, RES, RES, jnp.uint32(0))
            return jnp.mean((out.composited.stack() - target) ** 2)

        g_un = jax.grad(loss_unsharded)(view.mesh.materials.diffuse)

        def loss_sharded(diffuse):
            mats = view.mesh.materials._replace(diffuse=diffuse)
            v = view._replace(mesh=view.mesh._replace(materials=mats))
            out = render_pass_sharded(v, opts, RES, RES, jnp.uint32(0), mesh)
            return jnp.mean((out.composited.stack() - target) ** 2)

        g_sh = jax.grad(loss_sharded)(view.mesh.materials.diffuse)
        np.testing.assert_allclose(
            np.asarray(g_sh.x), np.asarray(g_un.x), rtol=1e-4, atol=1e-8
        )
