"""EAW denoiser + Pallas trace kernel tests."""
import jax
import jax.numpy as jnp
import numpy as np

from fermat_tpu.render.context import RenderingContext
from fermat_tpu.render.denoise import EAWParams, eaw, filter_variance
from fermat_tpu.scene.procedural import cornell_box, cornell_camera

RES = 32


class TestVarianceFilter:
    def test_box_filter_constant(self):
        v = jnp.full((16, 16), 3.0)
        out = filter_variance(v, 2)
        np.testing.assert_allclose(np.asarray(out), 3.0, rtol=1e-6)

    def test_box_filter_borders(self):
        v = jnp.zeros((8, 8)).at[0, 0].set(1.0)
        out = filter_variance(v, 1)
        # corner pixel averages over 4 valid taps
        assert abs(float(out[0, 0]) - 0.25) < 1e-6


class TestEAW:
    def _flat_inputs(self, h=24, w=24, seed=0):
        r = np.random.default_rng(seed)
        img = jnp.asarray(0.5 + 0.1 * r.standard_normal((h, w, 3)).astype(np.float32))
        normal = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (h, w, 3))
        pos = jnp.stack(
            jnp.meshgrid(jnp.arange(w, dtype=jnp.float32) * 0.01,
                         jnp.arange(h, dtype=jnp.float32) * 0.01, indexing="xy")
            + [jnp.zeros((h, w))], -1)
        miss = jnp.zeros((h, w), bool)
        var = jnp.full((h, w), 1.0)
        pr = jnp.full((h, w), 1.0)
        return img, normal, pos, miss, var, pr

    def test_smooths_noise_on_flat_region(self):
        img, normal, pos, miss, var, pr = self._flat_inputs()
        out = eaw(img, normal, pos, miss, var, pr, EAWParams(phi_color=1e-6, n_iterations=4))
        inner = (slice(4, -4), slice(4, -4))
        assert float(jnp.std(out[inner])) < 0.5 * float(jnp.std(img[inner]))
        # energy approximately preserved
        assert abs(float(jnp.mean(out[inner])) - float(jnp.mean(img[inner]))) < 0.01

    def test_respects_normal_edges(self):
        img, normal, pos, miss, var, pr = self._flat_inputs()
        h, w, _ = img.shape
        # two halves with opposing normals and different colors
        img = img.at[:, : w // 2].add(1.0)
        n2 = normal.at[:, : w // 2, 2].set(-1.0)
        out = eaw(img, n2, pos, miss, var, pr, EAWParams(phi_color=1e-6, n_iterations=4))
        # the edge survives: means differ by ~1 still
        left = float(jnp.mean(out[4:-4, 4 : w // 2 - 4]))
        right = float(jnp.mean(out[4:-4, w // 2 + 4 : -4]))
        assert left - right > 0.9

    def test_miss_pixels_untouched(self):
        img, normal, pos, miss, var, pr = self._flat_inputs()
        miss = miss.at[5, 5].set(True)
        out = eaw(img, normal, pos, miss, var, pr, EAWParams(n_iterations=3))
        np.testing.assert_allclose(np.asarray(out[5, 5]), np.asarray(img[5, 5]))

    def test_end_to_end_filtered_image(self):
        ctx = RenderingContext.create(
            cornell_box(), cornell_camera(), RES, RES, renderer="pt", max_path_length=3
        )
        ctx.render(2)
        noisy = np.asarray(ctx.image())
        filtered = ctx.filtered_image()
        assert filtered.shape == noisy.shape
        assert np.isfinite(filtered.astype(np.float32)).all()
        # denoised interior is smoother than raw
        g_n = np.abs(np.diff(noisy[4:-4, 4:-4, 1].astype(np.float32), axis=0)).mean()
        g_f = np.abs(np.diff(filtered[4:-4, 4:-4, 1].astype(np.float32), axis=0)).mean()
        assert g_f < g_n


class TestPallasTrace:
    def test_matches_brute(self):
        """The Pallas BVH-walk kernel (interpret mode) finds the brute-force
        hits on camera rays, and honours the active mask."""
        from fermat_tpu.accel.bvh import build_bvh_for_mesh
        from fermat_tpu.accel.traverse import trace_closest_brute
        from fermat_tpu.core.camera import generate_camera_rays
        from fermat_tpu.ops.gpu_bvh_walk import pack, trace_closest_walk

        mesh = cornell_box().device_view()
        tables = pack(mesh=mesh, bvh=build_bvh_for_mesh(mesh))
        half = jnp.full(32 * 32, 0.5)
        o, d, _ = generate_camera_rays(cornell_camera(), 32, 32, half, half)
        tmin, tmax = jnp.float32(1e-3), jnp.float32(1e9)
        hb = trace_closest_brute(mesh, o, d, tmin, tmax)
        hp = trace_closest_walk(tables, o, d, tmin, tmax, interpret=True)
        np.testing.assert_array_equal(np.asarray(hb.tri), np.asarray(hp.tri))
        np.testing.assert_allclose(np.asarray(hb.t), np.asarray(hp.t), rtol=1e-5)
        act = jnp.arange(32 * 32) % 2 == 0
        hp2 = trace_closest_walk(tables, o, d, tmin, tmax, act,
                                 interpret=True)
        np.testing.assert_array_equal(
            np.asarray(hp2.tri >= 0), np.asarray(act & (hb.tri >= 0))
        )


class TestXBL:
    def test_xbl_smooths_and_respects_edges(self):
        import jax.numpy as jnp
        from fermat_tpu.render.denoise import EAWParams, xbl

        r = np.random.default_rng(0)
        h = w = 24
        img = jnp.asarray(0.5 + 0.1 * r.standard_normal((h, w, 3)).astype(np.float32))
        normal = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (h, w, 3))
        pos = jnp.zeros((h, w, 3))
        miss = jnp.zeros((h, w), bool)
        var = jnp.full((h, w), 1.0)
        pr = jnp.full((h, w), 1.0)
        shift = jnp.zeros((h, w, 2))
        out = xbl(img, normal, pos, miss, var, pr, shift,
                  EAWParams(phi_color=1e-6), taps=12, filter_radius=4.0)
        inner = (slice(4, -4), slice(4, -4))
        assert float(jnp.std(out[inner])) < 0.7 * float(jnp.std(img[inner]))
        assert abs(float(jnp.mean(out[inner])) - float(jnp.mean(img[inner]))) < 0.02

    def test_filtered_image_xbl_path(self):
        ctx = RenderingContext.create(
            cornell_box(), cornell_camera(), RES, RES, renderer="pt", max_path_length=2
        )
        ctx.render(2)
        f = ctx.filtered_image(method="xbl")
        assert f.shape == (RES, RES, 3)
        assert np.isfinite(f.astype(np.float32)).all()


class TestAnalyticLights:
    def test_rect_and_disk_lights_illuminate(self):
        from fermat_tpu.scene.analytic_lights import add_disk_light, add_rect_light
        from fermat_tpu.scene.procedural import cornell_box as cb

        scene = cb(light_scale=0.0)  # kill the built-in light
        add_rect_light(scene, (0.5, 1.9, 0.0), (0, -1, 0), 0.2, 0.2, (15, 15, 15))
        add_disk_light(scene, (-0.5, 1.9, 0.0), (0, -1, 0), 0.2, (15, 15, 15))
        ctx = RenderingContext.create(
            scene, cornell_camera(), RES, RES, renderer="pt", max_path_length=3
        )
        img = np.asarray(ctx.render(4).composited)
        assert np.isfinite(img).all()
        assert img.max() > 0.05  # lit purely by the analytic lights

    def test_point_light(self):
        scene = cornell_box(light_scale=0.0)
        ctx = RenderingContext.create(
            scene, cornell_camera(), RES, RES, renderer="pt",
            max_path_length=2,
            point_lights=(((0.0, 1.5, 0.0), (3.0, 3.0, 3.0)),),
        )
        img = np.asarray(ctx.render(4).composited)
        assert np.isfinite(img).all()
        assert img.max() > 0.05
