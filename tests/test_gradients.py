"""Gradient validation to BASELINE's letter (config #5): finite-difference
checks of pixel gradients w.r.t. BSDF params (albedo, GGX roughness),
texture texels, and emitter radiance, plus the material-testball
inverse-rendering recovery demo.

Methodology: every loss is a deterministic function of a scalar parameter s
(fixed QMC instances, rr off), so a central finite difference of the SAME
estimator is an unbiased check of the autodiff value wherever sampling
decisions do not depend on s:
  * albedo / emitter scale / texels enter the throughput (multi)linearly and
    leave every sampling pdf invariant (uniform emitter scaling cancels in
    the normalized CDF), so FD == AD to O(eps^2).
  * roughness changes BSDF *sampling*; the detached estimator (pt.py) is
    unbiased in EXPECTATION but differs from a pathwise FD on any path that
    continues through a sampled direction, so the FD check runs with
    indirect lighting fully off: direct NEE light directions come from the
    emitter CDF alone and are roughness-independent, making FD == AD.
  * eps is chosen LARGE (0.05-0.2): the losses are low-degree polynomials or
    smooth in s, while f32 evaluation noise in a full renderer is ~1e-4
    absolute — FD error scales as noise/eps, so small eps drowns the signal
    (measured: the AD/FD gap grows as eps shrinks; see round-2 notes).
Reference: the reference has no gradient tests (no autodiff); BASELINE.md
demands pixel+gradient allclose — this file is that contract.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fermat_tpu.bsdf.composite import scene_lobes
from fermat_tpu.integrators.pt import PTOptions, render_pass
from fermat_tpu.scene.lights import MeshLightsView
from fermat_tpu.scene.procedural import cornell_box, cornell_camera
from fermat_tpu.scene.view import SceneView

# compile-heavy integrator tier — excluded from the default (fast) run
pytestmark = pytest.mark.heavy

RES = 16


def _loss_fn(view, opts, apply_s, n_passes=2, res=RES):
    """mean-image loss as a jitted scalar function of s (s0 = 1.0)."""

    def loss(s):
        v = apply_s(view, s)
        acc = 0.0
        for i in range(n_passes):
            out = render_pass(v, opts, res, res, jnp.uint32(i))
            acc = acc + jnp.mean(out.composited.stack())
        return acc / n_passes

    return jax.jit(loss)


def _fd_check(loss, eps, rtol, atol=0.0):
    s0 = jnp.float32(1.0)
    val, grad = jax.value_and_grad(loss)(s0)
    lp = loss(jnp.float32(1.0 + eps))
    lm = loss(jnp.float32(1.0 - eps))
    fd = (float(lp) - float(lm)) / (2.0 * eps)
    g = float(grad)
    assert np.isfinite(val) and np.isfinite(g), (val, g)
    assert abs(g - fd) <= rtol * max(abs(fd), abs(g)) + atol, (g, fd)
    return g, fd


class TestFiniteDifference:
    def test_fd_diffuse_albedo(self):
        scene = cornell_box(light_size=2.0)
        view = SceneView.build(scene, cornell_camera())
        opts = PTOptions(max_path_length=3, rr=False,
                         lobes=scene_lobes(scene.materials))

        def apply_s(v, s):
            d = v.mesh.materials.diffuse
            mats = v.mesh.materials._replace(
                diffuse=type(d)(d.x * s, d.y * s, d.z * s))
            return v._replace(mesh=v.mesh._replace(materials=mats))

        g, fd = _fd_check(_loss_fn(view, opts, apply_s), eps=0.2, rtol=2e-2)
        assert g > 0  # brighter albedo -> brighter image

    def test_fd_emitter_radiance(self):
        """d(image)/d(emitter scale): the light CDF + baked NEE rows are
        rebuilt inside the loss so the gradient flows through both the
        emissive-hit path and the NEE radiance."""
        scene = cornell_box(light_size=2.0)
        view = SceneView.build(scene, cornell_camera())
        opts = PTOptions(max_path_length=3, rr=False,
                         lobes=scene_lobes(scene.materials))

        def apply_s(v, s):
            e = v.mesh.materials.emissive
            mats = v.mesh.materials._replace(
                emissive=type(e)(e.x * s, e.y * s, e.z * s))
            mesh2 = v.mesh._replace(materials=mats)
            return v._replace(mesh=mesh2, lights=MeshLightsView.build(mesh2))

        g, fd = _fd_check(_loss_fn(view, opts, apply_s), eps=0.2, rtol=2e-2)
        # radiance is linear in the emitter scale: gradient == loss at s=1
        val = float(_loss_fn(view, opts, apply_s)(jnp.float32(1.0)))
        np.testing.assert_allclose(g, val, rtol=1e-3)

    def test_fd_ggx_roughness(self):
        """NEE-only DIRECT lighting, indirect off: light directions are
        independent of roughness, so detached-sampling AD must match FD
        exactly (the setting where detached-VNDF bias would otherwise show
        up). Only the glossy material's roughness is scaled — scaling the
        diffuse walls' roughness=1.0 through a clip creates a kink at s=1
        via the Kelemen coupling and breaks the central difference."""
        scene = cornell_box(light_size=2.0, glossy_boxes=True)
        for m in scene.materials:
            if m.name == "box":
                m.specular = (0.9, 0.9, 0.9)
                m.diffuse = (0.05, 0.05, 0.05)
                m.phong_exponent = 10.0  # roughness 0.1
        view = SceneView.build(scene, cornell_camera())
        opts = PTOptions(
            max_path_length=2, rr=False, visible_lights=False,
            direct_lighting_bsdf=False, indirect_lighting_nee=False,
            indirect_lighting_bsdf=False, lobes=scene_lobes(scene.materials),
        )
        glossy = view.mesh.materials.specular.x > 0.0

        def apply_s(v, s):
            r = v.mesh.materials.roughness
            mats = v.mesh.materials._replace(
                roughness=jnp.where(glossy, r * s, r))
            return v._replace(mesh=v.mesh._replace(materials=mats))

        g, fd = _fd_check(_loss_fn(view, opts, apply_s, n_passes=3),
                          eps=0.05, rtol=2e-2, atol=1e-7)

    @staticmethod
    def _textured_view(tmp_path, img):
        """Cornell with every non-emissive material diffuse-mapped to img.

        The texture must go through a real file: SceneView.build re-resolves
        material map indices from *_map_name (view.py:86-89), clobbering any
        manually-set diffuse_map."""
        import os

        from fermat_tpu.utils.image import write_tga

        scene = cornell_box(light_size=2.0)
        write_tga(os.path.join(str(tmp_path), "t.tga"), img)
        for m in scene.materials:
            if max(m.emissive) == 0:
                m.diffuse_map_name = "t.tga"
        view = SceneView.build(scene, cornell_camera(),
                               texture_dir=str(tmp_path))
        assert view.has_textures
        return scene, view

    def test_fd_texture_texels(self, tmp_path):
        """d(image)/d(texel scale) through the bilinear mip atlas: the
        diffuse map modulates albedo (multi)linearly in the texels."""
        r = np.random.default_rng(5)
        img = (0.25 + 0.75 * r.random((8, 8, 3))).astype(np.float32)
        scene, view = self._textured_view(tmp_path, img)
        opts = PTOptions(max_path_length=3, rr=False,
                         lobes=scene_lobes(scene.materials))

        def apply_s(v, s):
            t = v.textures.texels
            t2 = jnp.concatenate([t[:, :3] * s, t[:, 3:]], axis=1)
            return v._replace(textures=v.textures._replace(texels=t2))

        g, fd = _fd_check(_loss_fn(view, opts, apply_s), eps=0.2, rtol=2e-2)
        assert g > 0

    def test_grad_wrt_individual_texels(self, tmp_path):
        """Per-texel gradients exist and are nonzero on visible texels
        (BASELINE: gradients w.r.t. textures, not just a global scale)."""
        img = np.full((4, 4, 3), 0.6, np.float32)
        scene, view = self._textured_view(tmp_path, img)
        opts = PTOptions(max_path_length=2, rr=False,
                         lobes=scene_lobes(scene.materials))

        @jax.jit
        def loss(texels):
            v = view._replace(textures=view.textures._replace(texels=texels))
            out = render_pass(v, opts, RES, RES, jnp.uint32(0))
            return jnp.mean(out.composited.stack())

        g = jax.grad(loss)(view.textures.texels)
        g = np.asarray(g)
        assert np.isfinite(g).all()
        # some mip level of the wall texture receives gradient (ray-cone
        # LOD may route lookups to coarser levels at this resolution)
        assert (np.abs(g[:, :3]) > 0).any()


@pytest.mark.slow
class TestTestballRecovery:
    def test_recover_testball_albedo(self):
        """BASELINE config #5: inverse rendering on material-testball —
        recover the ball's diffuse albedo from a rendered target."""
        from fermat_tpu.scene.loaders.pbrt import load_pbrt

        pb = load_pbrt("/root/reference/models/material-testball/scene.pbrt")
        view = SceneView.build(pb.mesh, pb.camera,
                               env_radiance=pb.env_radiance)
        opts = PTOptions(max_path_length=2, rr=False,
                         lobes=scene_lobes(pb.mesh.materials))
        res_x, res_y = 48, 32

        def render_mean(v):
            acc = 0.0
            for i in range(2):
                out = render_pass(v, opts, res_x, res_y, jnp.uint32(i))
                acc = acc + out.composited.stack()
            return acc / 2

        target = jax.lax.stop_gradient(render_mean(view))
        true_d = view.mesh.materials.diffuse

        wrong = type(true_d)(
            jnp.clip(true_d.x * 0.3 + 0.4, 0, 1),
            jnp.clip(true_d.y * 0.3 + 0.2, 0, 1),
            jnp.clip(true_d.z * 0.3 + 0.1, 0, 1),
        )

        @jax.jit
        def step(diffuse):
            def loss_fn(diffuse):
                mats = view.mesh.materials._replace(diffuse=diffuse)
                v = view._replace(mesh=view.mesh._replace(materials=mats))
                return jnp.mean((render_mean(v) - target) ** 2)

            return jax.value_and_grad(loss_fn)(diffuse)

        diffuse = wrong
        l0 = None
        for _ in range(25):
            loss, g = step(diffuse)
            if l0 is None:
                l0 = float(loss)
            diffuse = jax.tree_util.tree_map(
                lambda p, gr: jnp.clip(p - 4.0 * gr, 0.0, 1.0), diffuse, g)
        l1 = float(step(diffuse)[0])
        assert l1 < 0.3 * l0, (l0, l1)
        err0 = float(jnp.mean(jnp.abs(wrong.x - true_d.x)))
        err1 = float(jnp.mean(jnp.abs(diffuse.x - true_d.x)))
        assert err1 < err0


class TestPixelLevelGradients:
    """BASELINE config #5 to the letter: PER-PIXEL gradient maps (not just
    mean-loss scalars) checked against per-pixel finite differences."""

    def _texture_grad_maps(self, tmp_path, lobes, eps):
        r = np.random.default_rng(11)
        img = (0.3 + 0.7 * r.random((8, 8, 3))).astype(np.float32)
        scene, view = TestFiniteDifference._textured_view(tmp_path, img)
        opts = PTOptions(max_path_length=3, rr=False, lobes=lobes)

        def image_of_s(s):
            t = view.textures.texels
            t2 = jnp.concatenate([t[:, :3] * s, t[:, 3:]], axis=1)
            v = view._replace(textures=view.textures._replace(texels=t2))
            out = render_pass(v, opts, RES, RES, jnp.uint32(0))
            return out.composited.stack()  # (N, 3)

        f = jax.jit(image_of_s)
        # forward-mode: the full per-pixel gradient image in one pass
        _, gmap = jax.jit(
            lambda s: jax.jvp(image_of_s, (s,), (jnp.float32(1.0),))
        )(jnp.float32(1.0))
        fd_map = (np.asarray(f(jnp.float32(1.0 + eps)))
                  - np.asarray(f(jnp.float32(1.0 - eps)))) / (2.0 * eps)
        return np.asarray(gmap), fd_map

    def test_pixel_gradient_map_vs_fd_textured(self, tmp_path):
        """Diffuse-only lobe set: lobe-selection probabilities are constant,
        so texels enter ONLY multilinearly and per-pixel FD == AD."""
        gmap, fd_map = self._texture_grad_maps(
            tmp_path, (True, False, False, False), eps=0.05)
        assert np.isfinite(gmap).all()
        assert (np.abs(gmap) > 0).mean() > 0.3  # most pixels see the texture
        np.testing.assert_allclose(gmap, fd_map, rtol=3e-2, atol=2e-4)

    def test_pixel_gradient_map_bias_with_glossy_lobe(self, tmp_path):
        """With the glossy lobe enabled, texels steer lobe-SELECTION
        probabilities, so the detached estimator drops a per-pixel term.
        Measured (GRADIENTS.md): ~4% of pixels carry up to ~11% relative
        bias at eps->0 on this scene. Pin that envelope."""
        gmap, fd_map = self._texture_grad_maps(
            tmp_path, (True, False, True, False), eps=0.05)
        d = np.abs(gmap - fd_map)
        bad = d > 0.03 * np.abs(fd_map) + 2e-4
        assert bad.mean() < 0.08, bad.mean()  # measured 3.7%
        rel = d / np.maximum(np.abs(fd_map), 1e-6)
        assert rel.max() < 0.3, rel.max()  # measured 0.11

    def test_pixel_gradient_map_vs_fd_albedo_reverse(self):
        """Same per-pixel check through REVERSE mode (vjp row extraction on
        a pixel subset), pinning that backward matches forward."""
        scene = cornell_box(light_size=2.0)
        view = SceneView.build(scene, cornell_camera())
        opts = PTOptions(max_path_length=2, rr=False,
                         lobes=scene_lobes(scene.materials))

        def image_of_s(s):
            d = view.mesh.materials.diffuse
            mats = view.mesh.materials._replace(
                diffuse=type(d)(d.x * s, d.y * s, d.z * s))
            v = view._replace(mesh=view.mesh._replace(materials=mats))
            out = render_pass(v, opts, RES, RES, jnp.uint32(0))
            return out.composited.stack()

        _, gmap_fwd = jax.jit(
            lambda s: jax.jvp(image_of_s, (s,), (jnp.float32(1.0),))
        )(jnp.float32(1.0))
        pix = [0, RES * RES // 2 + 3, RES * RES - 1]
        _, vjp = jax.vjp(image_of_s, jnp.float32(1.0))
        for p in pix:
            ct = jnp.zeros((RES * RES, 3)).at[p, 0].set(1.0)
            (g_rev,) = jax.jit(vjp)(ct)
            np.testing.assert_allclose(
                float(g_rev), float(gmap_fwd[p, 0]), rtol=1e-4, atol=1e-7)


class TestDetachedEstimatorBias:
    def test_indirect_roughness_bias_quantified(self):
        """The detached estimator's KNOWN bias on sampling-dependent
        (indirect roughness) gradients, measured against FD with indirect
        lighting ON (GRADIENTS.md documents the model; this pins the
        envelope so a regression can't silently blow it up)."""
        scene = cornell_box(light_size=2.0, glossy_boxes=True)
        for m in scene.materials:
            if m.name == "box":
                m.specular = (0.9, 0.9, 0.9)
                m.diffuse = (0.05, 0.05, 0.05)
                m.phong_exponent = 10.0
        view = SceneView.build(scene, cornell_camera())
        opts = PTOptions(max_path_length=3, rr=False, visible_lights=False,
                         lobes=scene_lobes(scene.materials))
        glossy = view.mesh.materials.specular.x > 0.0

        def apply_s(v, s):
            r = v.mesh.materials.roughness
            mats = v.mesh.materials._replace(
                roughness=jnp.where(glossy, r * s, r))
            return v._replace(mesh=v.mesh._replace(materials=mats))

        loss = _loss_fn(view, opts, apply_s, n_passes=3)
        s0 = jnp.float32(1.0)
        _val, grad = jax.value_and_grad(loss)(s0)
        eps = 0.1
        fd = (float(loss(jnp.float32(1 + eps)))
              - float(loss(jnp.float32(1 - eps)))) / (2 * eps)
        g = float(grad)
        assert np.isfinite(g) and np.isfinite(fd)
        # Measured on this instance (committed in GRADIENTS.md): the total
        # roughness gradient with indirect ON is SMALL (|fd| ~ 4e-3 on a
        # ~0.3 mean-image loss) and the detached estimator's dropped
        # sampling-dependence term (~1e-2) dominates it — the sign can
        # flip. What must stay pinned is the absolute envelope: the bias
        # is O(1e-2), not silently orders of magnitude larger.
        assert abs(g - fd) < 0.05, (g, fd)
        assert abs(g) < 0.1 and abs(fd) < 0.1, (g, fd)


class TestGradThroughTracers:
    def test_albedo_grad_identical_across_tracers(self, monkeypatch):
        """The trace is detached by design, so gradients must be IDENTICAL
        whichever tracer found the (same) hits: the brute-force test, the
        XLA BVH walk, and the per-ray walk kernel (in interpret mode)."""
        import functools

        from fermat_tpu import platform
        from fermat_tpu.ops import gpu_bvh_walk

        scene = cornell_box(light_size=2.0)
        view = SceneView.build(scene, cornell_camera())

        def grad_with(tracer):
            opts = PTOptions(max_path_length=2, rr=False, tracer=tracer,
                             lobes=scene_lobes(scene.materials))

            def loss(s):
                d = view.mesh.materials.diffuse
                mats = view.mesh.materials._replace(
                    diffuse=type(d)(d.x * s, d.y * s, d.z * s))
                v = view._replace(mesh=view.mesh._replace(materials=mats))
                out = render_pass(v, opts, RES, RES, jnp.uint32(0))
                return jnp.mean(out.composited.stack())

            return float(jax.jit(jax.grad(loss))(jnp.float32(1.0)))

        g_brute = grad_with("brute")
        g_bvh = grad_with("bvh")
        # route to the kernel, as on a GPU, and run it in the interpreter
        for name in ("trace_closest_walk", "trace_any_walk"):
            monkeypatch.setattr(gpu_bvh_walk, name, functools.partial(
                getattr(gpu_bvh_walk, name), interpret=True))
        monkeypatch.setattr(platform, "on_gpu", lambda: True)
        monkeypatch.setattr(platform, "per_platform",
                            lambda args, gpu, other: gpu(*args))
        g_kernel = grad_with("bvh")
        np.testing.assert_allclose(g_bvh, g_brute, rtol=1e-5)
        np.testing.assert_allclose(g_kernel, g_brute, rtol=1e-5)


@pytest.mark.slow
class TestJointRecovery:
    def test_recover_roughness_and_texture_jointly(self, tmp_path):
        """VERDICT r2 #6d: joint inverse rendering over a texture AND a
        glossy roughness from one rendered target."""
        img = np.full((4, 4, 3), 0.55, np.float32)
        scene = cornell_box(light_size=2.0, glossy_boxes=True)
        for m in scene.materials:
            if m.name == "box":
                m.specular = (0.8, 0.8, 0.8)
                m.diffuse = (0.05, 0.05, 0.05)
                m.phong_exponent = 10.0  # roughness ~0.1 (ground truth)
            elif max(m.emissive) == 0:
                m.diffuse_map_name = "t.tga"
        import os

        from fermat_tpu.utils.image import write_tga

        write_tga(os.path.join(str(tmp_path), "t.tga"), img)
        view = SceneView.build(scene, cornell_camera(),
                               texture_dir=str(tmp_path))
        opts = PTOptions(max_path_length=2, rr=False,
                         lobes=scene_lobes(scene.materials))
        glossy = np.asarray(view.mesh.materials.specular.x) > 0.0
        res = 24

        def render(v):
            out = render_pass(v, opts, res, res, jnp.uint32(0))
            return out.composited.stack()

        target = jax.lax.stop_gradient(render(view))
        true_tex = view.textures.texels

        @jax.jit
        def step(params):
            def loss_fn(params):
                tex, r_scale = params
                mats = view.mesh.materials._replace(
                    roughness=jnp.where(
                        glossy, view.mesh.materials.roughness * r_scale,
                        view.mesh.materials.roughness))
                v = view._replace(
                    mesh=view.mesh._replace(materials=mats),
                    textures=view.textures._replace(texels=tex))
                return jnp.mean((render(v) - target) ** 2)

            return jax.value_and_grad(loss_fn)(params)

        params = (true_tex * 0.5, jnp.float32(3.0))  # dark texture, too rough
        l0 = None
        for it in range(30):
            loss, (g_tex, g_r) = step(params)
            if l0 is None:
                l0 = float(loss)
            params = (
                jnp.clip(params[0] - 40.0 * g_tex, 0.0, 1.0),
                jnp.clip(params[1] - 400.0 * g_r, 0.2, 5.0),
            )
        l1 = float(step(params)[0])
        assert l1 < 0.25 * l0, (l0, l1)
        # roughness scale pulled back toward 1 from 3
        assert float(params[1]) < 2.0, float(params[1])
        # visible texels moved toward the target texture
        err0 = float(jnp.mean(jnp.abs(true_tex[:, :3] * 0.5 - true_tex[:, :3])))
        err1 = float(jnp.mean(jnp.abs(params[0][:, :3] - true_tex[:, :3])))
        assert err1 < err0
