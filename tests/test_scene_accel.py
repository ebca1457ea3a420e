"""Scene loading + BVH build/traversal tests.

Follows the reference's dual-path consistency pattern
(cugar/bvh/cuda/lbvh_test.cu: device build vs host build, brute-force vs BVH
range queries): here brute-force tracing is the ground truth the BVH must
match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fermat_tpu.accel.bvh import build_bvh_for_mesh
from fermat_tpu.accel.traverse import (
    trace_any,
    trace_any_brute,
    trace_closest,
    trace_closest_brute,
)
from fermat_tpu.core.camera import generate_camera_rays
from fermat_tpu.core.math import Vec3
from fermat_tpu.scene.loaders.obj import load_obj
from fermat_tpu.scene.loaders.fa import load_fa
from fermat_tpu.scene.procedural import (
    big_room,
    cornell_box,
    cornell_camera,
    random_soup,
)
from scene_files import FA_FOV, write_fa, write_obj, write_pbrt, write_ply



class TestLoaders:
    """Each loader reads a file written from a procedural mesh
    (tests/scene_files.py) and must give that mesh back."""

    def test_cornell_obj(self, tmp_path):
        src = cornell_box()
        m = load_obj(write_obj(str(tmp_path / "cornell.obj"), src,
                               negative=True))
        assert m.n_triangles == src.n_triangles
        names = [mm.name for mm in m.materials]
        assert "light" in names and "red" in names
        light = m.materials[names.index("light")]
        assert max(light.emissive) == pytest.approx(17.0)
        lo, hi = m.bbox()
        assert np.all(hi - lo > 1.5)  # ~2 unit box
        # negative indices resolved: all triangle indices valid
        assert m.triangles.min() >= 0 and m.triangles.max() < m.n_vertices
        np.testing.assert_allclose(m.vertices[m.triangles],
                                   src.vertices[src.triangles], atol=1e-6)

    def test_glossy_obj_with_normals(self, tmp_path):
        m = load_obj(write_obj(str(tmp_path / "glossy.obj"),
                               cornell_box(glossy_boxes=True), normals=True))
        assert m.n_triangles > 30
        v = m.device_view()
        # shading normals are unit
        n2 = np.asarray(v.n0.x) ** 2 + np.asarray(v.n0.y) ** 2 + np.asarray(v.n0.z) ** 2
        np.testing.assert_allclose(n2, 1.0, atol=1e-3)
        box = [mm for mm in m.materials if mm.name == "box"][0]
        assert box.specular == pytest.approx((0.5, 0.5, 0.5))

    def test_ply(self, tmp_path):
        from fermat_tpu.scene.loaders.ply import load_ply

        src = big_room(n_boxes=10)
        m = load_ply(write_ply(str(tmp_path / "Mesh000.ply"), src))
        assert m.n_triangles == src.n_triangles > 100
        assert np.isfinite(m.vertices).all()
        np.testing.assert_array_equal(m.triangles, src.triangles)
        np.testing.assert_allclose(m.vertices, src.vertices)

    def test_fa_composition(self, tmp_path):
        s = load_fa(write_fa(str(tmp_path)))
        # two CornellBox objs with transforms + camera + dir light
        assert s.mesh.n_triangles == 2 * cornell_box().n_triangles
        assert len(s.cameras) == 1
        assert abs(float(s.cameras[0].fov) - FA_FOV) < 1e-5
        assert len(s.dir_lights) == 1
        # the Glossy box is scaled x3 and translated: bbox must be displaced
        lo, hi = s.mesh.bbox()
        assert hi[1] > 3.0  # scaled box reaches above 3 units

    def test_procedural_cornell(self):
        m = cornell_box()
        assert m.n_triangles == 6 * 2 + 2 * 12  # 6 quads + 2 boxes
        v = m.device_view()
        assert bool(jnp.all(jnp.isfinite(v.p0.x)))


def _camera_rays(n=64):
    cam = cornell_camera()
    half = jnp.full(n * n, 0.5)
    o, d, pix = generate_camera_rays(cam, n, n, half, half)
    return o, d


class TestTraversal:
    def test_cornell_brute_hits(self):
        mesh = cornell_box().device_view()
        o, d = _camera_rays(32)
        hit = trace_closest_brute(mesh, o, d, jnp.float32(1e-3), jnp.float32(1e9))
        # every camera ray hits the box interior
        assert bool(jnp.all(hit.hit_mask))
        assert float(jnp.min(hit.t)) > 0.1
        assert float(jnp.max(hit.t)) < 10.0

    def test_bvh_matches_brute_cornell(self):
        mesh = cornell_box().device_view()
        bvh = build_bvh_for_mesh(mesh)
        o, d = _camera_rays(32)
        tmin, tmax = jnp.float32(1e-3), jnp.float32(1e9)
        hb = trace_closest_brute(mesh, o, d, tmin, tmax)
        hv = trace_closest(bvh, mesh, o, d, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(hv.tri), np.asarray(hb.tri))
        np.testing.assert_allclose(np.asarray(hv.t), np.asarray(hb.t), rtol=1e-5)

    def test_bvh_matches_brute_soup(self):
        mesh = random_soup(500, seed=1).device_view()
        bvh = build_bvh_for_mesh(mesh)
        r = np.random.default_rng(0)
        n = 512
        o = Vec3(*(jnp.asarray((r.random(n, dtype=np.float32) - 0.5) * 20) for _ in range(3)))
        dn = r.normal(size=(3, n)).astype(np.float32)
        dn /= np.linalg.norm(dn, axis=0, keepdims=True)
        d = Vec3(jnp.asarray(dn[0]), jnp.asarray(dn[1]), jnp.asarray(dn[2]))
        tmin, tmax = jnp.float32(1e-4), jnp.float32(1e9)
        hb = trace_closest_brute(mesh, o, d, tmin, tmax)
        hv = trace_closest(bvh, mesh, o, d, tmin, tmax)
        # same hit distance everywhere (tri ids may differ on exact ties)
        np.testing.assert_allclose(np.asarray(hv.t), np.asarray(hb.t), rtol=1e-4)
        np.testing.assert_array_equal(
            np.asarray(hv.hit_mask), np.asarray(hb.hit_mask)
        )

    def test_any_hit(self):
        mesh = cornell_box().device_view()
        bvh = build_bvh_for_mesh(mesh)
        n = 8
        # rays from center of box towards ceiling: occluded by the light quad
        # and ceiling; rays with tmax short of any surface: unoccluded
        o = Vec3(jnp.zeros(n), jnp.full(n, 1.0), jnp.zeros(n))
        d = Vec3(jnp.zeros(n), jnp.ones(n), jnp.zeros(n))
        occ_far = trace_any(bvh, mesh, o, d, jnp.float32(1e-3), jnp.full(n, 10.0))
        occ_near = trace_any(bvh, mesh, o, d, jnp.float32(1e-3), jnp.full(n, 0.5))
        assert bool(jnp.all(occ_far))
        assert not bool(jnp.any(occ_near))
        occ_brute = trace_any_brute(mesh, o, d, jnp.float32(1e-3), jnp.full(n, 10.0))
        np.testing.assert_array_equal(np.asarray(occ_far), np.asarray(occ_brute))

    def test_active_mask(self):
        mesh = cornell_box().device_view()
        bvh = build_bvh_for_mesh(mesh)
        o, d = _camera_rays(8)
        active = jnp.arange(64) % 2 == 0
        hit = trace_closest(bvh, mesh, o, d, jnp.float32(1e-3), jnp.float32(1e9), active)
        assert bool(jnp.all(hit.tri[::2] >= 0))
        assert bool(jnp.all(hit.tri[1::2] == -1))

    def test_interpolate_geometry(self):
        mesh = cornell_box().device_view()
        o, d = _camera_rays(16)
        hit = trace_closest_brute(mesh, o, d, jnp.float32(1e-3), jnp.float32(1e9))
        pos, gn, sn, uv, mat = mesh.interpolate(hit.tri, hit.u, hit.v)
        # hit point from barycentrics equals o + t*d
        px = np.asarray(o.x + d.x * hit.t)
        np.testing.assert_allclose(np.asarray(pos.x), px, atol=1e-4)
        # normals unit length
        n2 = np.asarray(sn.x) ** 2 + np.asarray(sn.y) ** 2 + np.asarray(sn.z) ** 2
        np.testing.assert_allclose(n2, 1.0, atol=1e-4)


class TestLBVH:
    """Device-build LBVH vs host SAH builder — the lbvh_test.cu:59-240
    host-vs-device consistency check, via traversal equivalence."""

    def _rays(self, n, seed=0, extent=20.0):
        r = np.random.default_rng(seed)
        o = Vec3(*(jnp.asarray((r.random(n, dtype=np.float32) - 0.5) * extent) for _ in range(3)))
        dn = r.normal(size=(3, n)).astype(np.float32)
        dn /= np.linalg.norm(dn, axis=0, keepdims=True)
        return o, Vec3(jnp.asarray(dn[0]), jnp.asarray(dn[1]), jnp.asarray(dn[2]))

    def test_lbvh_matches_sah_soup(self):
        from fermat_tpu.accel.lbvh import build_lbvh_for_mesh

        mesh = random_soup(800, seed=5).device_view()
        lbvh = build_lbvh_for_mesh(mesh)
        sah = build_bvh_for_mesh(mesh)
        o, d = self._rays(512, 1)
        tmin, tmax = jnp.float32(1e-4), jnp.float32(1e9)
        hl = trace_closest(lbvh, mesh, o, d, tmin, tmax)
        hs = trace_closest(sah, mesh, o, d, tmin, tmax)
        np.testing.assert_allclose(np.asarray(hl.t), np.asarray(hs.t), rtol=1e-4)
        np.testing.assert_array_equal(
            np.asarray(hl.hit_mask), np.asarray(hs.hit_mask)
        )

    def test_lbvh_cornell(self):
        from fermat_tpu.accel.lbvh import build_lbvh_for_mesh

        mesh = cornell_box().device_view()
        lbvh = build_lbvh_for_mesh(mesh)
        o, d = _camera_rays(16)
        tmin, tmax = jnp.float32(1e-3), jnp.float32(1e9)
        hl = trace_closest(lbvh, mesh, o, d, tmin, tmax)
        hb = trace_closest_brute(mesh, o, d, tmin, tmax)
        np.testing.assert_allclose(np.asarray(hl.t), np.asarray(hb.t), rtol=1e-5)

    def test_lbvh_jittable(self):
        from fermat_tpu.accel.lbvh import build_lbvh_for_mesh

        mesh = random_soup(100, seed=2).device_view()
        bvh = jax.jit(build_lbvh_for_mesh)(mesh)
        assert int(bvh.skip.shape[0]) == 199


class TestPbrt:
    def test_material_testball(self, tmp_path):
        """Load + render a pbrt scene shaped like the reference's
        material-testball (BASELINE config #5 scene)."""
        from fermat_tpu.scene.loaders.pbrt import load_pbrt
        from fermat_tpu.render.context import RenderingContext

        pb = load_pbrt(write_pbrt(str(tmp_path)))
        assert pb.mesh.n_triangles > 1000  # plymeshes + floor
        assert pb.camera is not None
        assert pb.resolution == (1280, 720)
        assert max(pb.env_radiance) > 0  # infinite light
        names = [m.name for m in pb.mesh.materials]
        assert any("Rough" in n or "Stand" in n or "Floor" in n for n in names)
        ctx = RenderingContext.create(
            pb.mesh, pb.camera, 48, 32, renderer="pt",
            env_radiance=pb.env_radiance, max_path_length=3,
        )
        img = np.asarray(ctx.render(2).composited)
        assert np.isfinite(img).all()
        assert img.max() > 0.05  # env-lit
