"""The per-ray BVH walk (ops/gpu_bvh_walk.py) against the brute-force tracer.

The kernel runs here in Pallas interpret mode; the same cases run the XLA
walk (accel/traverse.py), which is the tracer off the GPU. Tolerances (all
fp32 elementwise arithmetic, no matmul; only FMA contraction can differ):
hit/miss agree exactly, `t` to rtol 1e-5, and `tri` is equal except where
another triangle's hit lies within a relative 1e-5 in t (a tie).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fermat_tpu.accel.bvh import build_bvh_for_mesh
from fermat_tpu.accel.lbvh import build_lbvh_for_mesh
from fermat_tpu.accel.traverse import (
    intersect_triangles,
    trace_any,
    trace_any_brute,
    trace_closest,
    trace_closest_brute,
)
from fermat_tpu.core.camera import Camera, generate_camera_rays
from fermat_tpu.core.math import Vec3, normalize
from fermat_tpu.ops.gpu_bvh_walk import pack, trace_any_walk, trace_closest_walk
from fermat_tpu.scene.procedural import (
    big_room,
    cornell_box,
    cornell_camera,
    random_soup,
)

N_RAYS = 256

def _kernel(trace):
    """The kernel in interpret mode, with the XLA walk's arguments."""
    return lambda bvh, mesh, *args: trace(pack(bvh, mesh), *args,
                                          interpret=True)


IMPLS = {
    "kernel": (_kernel(trace_closest_walk), _kernel(trace_any_walk)),
    "xla": (trace_closest, trace_any),
}


def _slivers(n=1500, seed=4):
    """Needle triangles: about 200 times longer than they are wide."""
    r = np.random.default_rng(seed)
    a = (r.random((n, 3), dtype=np.float32) - 0.5) * 8.0
    along = 2.0 * r.standard_normal((n, 3)).astype(np.float32)
    across = r.standard_normal((n, 3)).astype(np.float32)
    b = a + along
    c = a + 0.5 * along + 1e-2 * across
    soup = random_soup(n, seed=seed)
    soup.vertices = np.concatenate([a, b, c]).astype(np.float32)
    return soup


_SCENES = {
    "soup": lambda: random_soup(1500, seed=5),
    "bigroom": lambda: big_room(n_boxes=150),
    "cornell": cornell_box,
    "sliver": _slivers,
}


@functools.lru_cache(maxsize=None)
def _scene(name: str, tree: str):
    mesh = _SCENES[name]().device_view()
    bvh = (build_bvh_for_mesh(mesh) if tree == "sah"
           else build_lbvh_for_mesh(mesh))
    return mesh, bvh


def _random_rays(seed, n, spread=10.0):
    r = np.random.default_rng(seed)
    o = (r.random((n, 3)).astype(np.float32) - 0.5) * spread
    d = r.standard_normal((n, 3)).astype(np.float32)
    return (Vec3(*(jnp.asarray(o[:, i]) for i in range(3))),
            normalize(Vec3(*(jnp.asarray(d[:, i]) for i in range(3)))))


def _rays(scene: str, kind: str, n=N_RAYS):
    if kind == "incoherent":
        return _random_rays(7, n, 4.0 if scene == "cornell" else 10.0)
    res = int(np.sqrt(n))
    if scene == "cornell":
        cam = cornell_camera()
    elif scene == "bigroom":
        cam = Camera.create(eye=(0.0, 3.0, 10.0), aim=(0.0, 1.5, 0.0))
    else:
        cam = Camera.create(eye=(0.0, 0.0, 14.0), aim=(0.0, 0.0, 0.0))
    half = jnp.full(res * res, 0.5, jnp.float32)
    o, d, _ = generate_camera_rays(cam, res, res, half, half)
    return o, d


def _check_closest(mesh, o, d, tmin, tmax, hit, active=None):
    ref = trace_closest_brute(mesh, o, d, tmin, tmax, active)
    m = np.asarray(ref.hit_mask)
    np.testing.assert_array_equal(np.asarray(hit.hit_mask), m)
    assert m.any()
    np.testing.assert_allclose(np.asarray(hit.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5)
    tri, tri_ref = np.asarray(hit.tri), np.asarray(ref.tri)
    diff = m & (tri != tri_ref)
    if diff.any():
        # a differing triangle must be a tie: its own hit lies within a
        # relative 1e-5 of the brute-force closest t
        t_other, _, _, ok = intersect_triangles(
            mesh, jnp.asarray(np.maximum(tri, 0)), o, d, tmin, np.inf)
        t_other, t_ref = np.asarray(t_other)[diff], np.asarray(ref.t)[diff]
        assert np.asarray(ok)[diff].all()
        np.testing.assert_allclose(t_other, t_ref, rtol=1e-5)


def _check_any(mesh, o, d, tmin, tmax, occ, active=None):
    ref = np.asarray(trace_any_brute(mesh, o, d, tmin, tmax, active))
    np.testing.assert_array_equal(np.asarray(occ), ref)
    assert ref.any() and not ref.all()


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("tree", ["sah", "lbvh"])
@pytest.mark.parametrize("rays", ["camera", "incoherent"])
@pytest.mark.parametrize("scene", sorted(_SCENES))
def test_walk_matches_brute(scene, rays, tree, query, impl):
    mesh, bvh = _scene(scene, tree)
    o, d = _rays(scene, rays)
    closest, anyhit = IMPLS[impl]
    tmin = jnp.float32(1e-4)
    if query == "closest":
        tmax = jnp.float32(3e38)
        _check_closest(mesh, o, d, tmin, tmax,
                       closest(bvh, mesh, o, d, tmin, tmax))
    else:
        # about halfway to the surfaces, so that some rays are occluded
        # and some are not
        reach = {"cornell": 1.2, "bigroom": 6.0}.get(
            scene, 4.0 if rays == "incoherent" else 12.0)
        tmax = jnp.float32(reach)
        _check_any(mesh, o, d, tmin, tmax, anyhit(bvh, mesh, o, d, tmin, tmax))


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("tree", ["sah", "lbvh"])
def test_walk_active_mask_per_ray_tmax(tree, query, impl):
    """Inactive rays report a miss; each ray stops at its own tmax; the ray
    count is no multiple of the kernel block."""
    mesh, bvh = _scene("soup", tree)
    n = 300
    o, d = _random_rays(11, n)
    r = np.random.default_rng(12)
    active = jnp.asarray(r.random(n) < 0.7)
    tmax = jnp.asarray((r.random(n) * 8.0).astype(np.float32))
    tmin = jnp.float32(1e-4)
    closest, anyhit = IMPLS[impl]
    if query == "closest":
        hit = closest(bvh, mesh, o, d, tmin, tmax, active)
        assert not np.asarray(hit.hit_mask)[~np.asarray(active)].any()
        _check_closest(mesh, o, d, tmin, tmax, hit, active)
        assert (np.asarray(hit.t) <= np.asarray(tmax)).all()
    else:
        _check_any(mesh, o, d, tmin, tmax,
                   anyhit(bvh, mesh, o, d, tmin, tmax, active), active)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("tree", ["sah", "lbvh"])
def test_walk_many_nodes_few_rays(tree, query, impl):
    """A 2000-triangle tree and three rays: one block, mostly padding."""
    mesh, bvh = _scene("soup", tree)
    o = Vec3(jnp.asarray([0.0, -6.0, 0.5]), jnp.asarray([0.0, 0.0, 6.0]),
             jnp.asarray([-9.0, 0.0, 0.0]))
    d = normalize(Vec3(jnp.asarray([0.1, 1.0, 0.0]), jnp.asarray([0.0, 0.1, -1.0]),
                       jnp.asarray([1.0, 0.0, 0.05])))
    tmin, tmax = jnp.float32(1e-4), jnp.float32(3e38)
    closest, anyhit = IMPLS[impl]
    if query == "closest":
        _check_closest(mesh, o, d, tmin, tmax,
                       closest(bvh, mesh, o, d, tmin, tmax))
    else:
        occ = anyhit(bvh, mesh, o, d, tmin, tmax)
        ref = trace_any_brute(mesh, o, d, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))


def test_walk_under_jit_and_in_a_loop():
    """The kernel composes with jit and a fori_loop, as a bounce loop uses it."""
    mesh, bvh = _scene("cornell", "sah")
    o, d = _rays("cornell", "camera", 64)
    tables = pack(bvh, mesh)

    @jax.jit
    def f(o, d):
        def body(i, acc):
            h = trace_closest_walk(tables, o, d, jnp.float32(1e-4),
                                   jnp.float32(3e38), interpret=True)
            return acc + jnp.where(h.hit_mask, h.t, 0.0)
        return jax.lax.fori_loop(0, 2, body, jnp.zeros(64, jnp.float32))

    ref = trace_closest_brute(mesh, o, d, jnp.float32(1e-4), jnp.float32(3e38))
    np.testing.assert_allclose(np.asarray(f(o, d)),
                               2 * np.asarray(jnp.where(ref.hit_mask, ref.t, 0.0)),
                               rtol=1e-5)
