"""Native C++ runtime (OBJ parse + SAH build) vs the python reference."""
import time

import jax.numpy as jnp
import numpy as np
import pytest

from fermat_tpu.scene.procedural import cornell_box
from fermat_tpu.utils import native
from scene_files import write_obj


@pytest.fixture(autouse=True)
def _native_lib():
    if not native.available():
        pytest.skip("native library unavailable (no C++ compiler)")


class TestNativeObj:
    def test_matches_python_loader(self, tmp_path):
        from fermat_tpu.scene.loaders.obj import load_obj

        path = write_obj(str(tmp_path / "cornell.obj"), cornell_box(),
                         negative=True)
        py = load_obj(path)
        nt = native.load_obj_geometry(path)
        assert nt is not None
        np.testing.assert_allclose(nt["vertices"], py.vertices, rtol=1e-6)
        np.testing.assert_array_equal(nt["tri_v"], py.triangles)
        # native indexes materials by usemtl first-use order; compare via names
        py_names = [m.name for m in py.materials]
        nt_names = nt["material_names"]
        for k in range(py.n_triangles):
            assert nt_names[nt["tri_mat"][k]] == py_names[py.material_ids[k]]

    def test_glossy_with_normals_uvs(self, tmp_path):
        from fermat_tpu.scene.loaders.obj import load_obj

        p = write_obj(str(tmp_path / "glossy.obj"),
                      cornell_box(glossy_boxes=True), normals=True)
        py = load_obj(p)
        nt = native.load_obj_geometry(p)
        np.testing.assert_allclose(nt["normals"], py.normals, rtol=1e-6)
        np.testing.assert_array_equal(nt["tri_n"], py.normal_indices)
        np.testing.assert_allclose(nt["uvs"], py.uvs, rtol=1e-6)


class TestNativeBvh:
    def test_traversal_equivalence(self):
        from fermat_tpu.accel.bvh import build_bvh_for_mesh
        from fermat_tpu.accel.traverse import trace_closest, trace_closest_brute
        from fermat_tpu.core.math import Vec3
        from fermat_tpu.scene.procedural import random_soup

        mesh = random_soup(6000, seed=7).device_view()  # above native threshold
        bvh_n = build_bvh_for_mesh(mesh, use_native=True)
        r = np.random.default_rng(0)
        n = 512
        o = Vec3(*(jnp.asarray((r.random(n, dtype=np.float32) - 0.5) * 20) for _ in range(3)))
        dn = r.normal(size=(3, n)).astype(np.float32)
        dn /= np.linalg.norm(dn, axis=0, keepdims=True)
        d = Vec3(jnp.asarray(dn[0]), jnp.asarray(dn[1]), jnp.asarray(dn[2]))
        tmin, tmax = jnp.float32(1e-4), jnp.float32(1e9)
        hn = trace_closest(bvh_n, mesh, o, d, tmin, tmax)
        hb = trace_closest_brute(mesh, o, d, tmin, tmax)
        np.testing.assert_allclose(np.asarray(hn.t), np.asarray(hb.t), rtol=1e-4)
        np.testing.assert_array_equal(
            np.asarray(hn.hit_mask), np.asarray(hb.hit_mask)
        )

    def test_native_faster_than_python(self):
        from fermat_tpu.accel.bvh import build_bvh_for_mesh
        from fermat_tpu.scene.procedural import random_soup

        mesh = random_soup(30000, seed=8).device_view()
        t0 = time.perf_counter()
        build_bvh_for_mesh(mesh, use_native=True)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        build_bvh_for_mesh(mesh, use_native=False)
        t_python = time.perf_counter() - t0
        assert t_native < t_python, (t_native, t_python)
