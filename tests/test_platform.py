"""The platform module: routing, interpret mode, the compile cache; and the
entry points that depend on it (chip_smoke's device check, gather_rows,
the native library build)."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fermat_tpu import platform
from fermat_tpu.core.math import Vec3
from fermat_tpu.ops import gather
from fermat_tpu.scene.procedural import cornell_box

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


class TestCompileCache:
    def test_env_var_is_honoured(self, monkeypatch, tmp_path,
                                 restore_cache_config):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert platform.setup_compile_cache() == str(tmp_path)
        # JAX reads the variable itself: no other directory is set
        assert jax.config.jax_compilation_cache_dir == before

    def test_fixed_default_inside_checkout(self, monkeypatch,
                                           restore_cache_config):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = platform.setup_compile_cache(min_compile_secs=3.0)
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 3.0
        # the same path on every call: no pid, time or temporary name
        assert platform.setup_compile_cache() == path
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def _route(tracer, n_tris):
    """Which of three marked tracers `platform.tracer_for` returns."""
    return platform.tracer_for(
        tracer, n_tris, brute=lambda: "brute", walk=lambda: "walk",
        kernel=lambda: (lambda: "kernel"))()


class TestRouting:
    @pytest.mark.parametrize("n_tris", [36, 4096, 4097, 600_000])
    def test_auto_never_picks_a_kernel_on_cpu(self, n_tris):
        assert jax.default_backend() == "cpu"
        assert _route("auto", n_tris) == (
            "brute" if n_tris <= platform.BRUTE_MAX_TRIANGLES else "walk")
        assert _route("bvh", n_tris) == "walk"
        assert _route("brute", n_tris) == "brute"

    def test_gpu_takes_the_kernel_unless_brute_is_asked(self, monkeypatch):
        monkeypatch.setattr(platform, "on_gpu", lambda: True)
        monkeypatch.setattr(platform, "per_platform",
                            lambda args, gpu, other: gpu(*args))
        for n_tris in (36, 600_000):
            assert _route("auto", n_tris) == "kernel"
            assert _route("bvh", n_tris) == "kernel"
            assert _route("brute", n_tris) == "brute"

    def test_gpu_routing_lowers_the_plain_branch_on_cpu(self, monkeypatch):
        """With GPU routing, a program compiled for the CPU runs the plain
        tracer: the same jitted pass serves both devices."""
        from fermat_tpu.integrators.pt import PTOptions, render_pass
        from fermat_tpu.scene.procedural import cornell_camera
        from fermat_tpu.scene.view import SceneView

        view = SceneView.build(cornell_box(), cornell_camera())
        opts = PTOptions(max_path_length=2, rr=False)
        run = lambda: np.asarray(jax.jit(
            lambda v: render_pass(v, opts, 8, 8, jnp.uint32(0))
            .composited.stack())(view))
        ref = run()
        monkeypatch.setattr(platform, "on_gpu", lambda: True)
        np.testing.assert_allclose(run(), ref, rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("tracer", ["frontier", "cluster", "mega",
                                        "pallas"])
    def test_only_auto_bvh_brute(self, tracer):
        from fermat_tpu.integrators.pt import PTOptions, _pick_tracers
        from fermat_tpu.scene.procedural import cornell_camera
        from fermat_tpu.scene.view import SceneView

        with pytest.raises(ValueError, match="auto"):
            _route(tracer, 100)
        view = SceneView.build(cornell_box(), cornell_camera())
        with pytest.raises(ValueError):
            _pick_tracers(view, PTOptions(tracer=tracer))

    @pytest.mark.parametrize("query", ["closest", "any"])
    def test_kernel_without_interpret_raises_on_cpu(self, query):
        from fermat_tpu.accel.bvh import build_bvh_for_mesh
        from fermat_tpu.ops import gpu_bvh_walk

        mesh = cornell_box().device_view()
        tables = gpu_bvh_walk.pack(build_bvh_for_mesh(mesh), mesh)
        o = Vec3(*(jnp.zeros(4),) * 3)
        d = Vec3(jnp.zeros(4), jnp.zeros(4), jnp.ones(4))
        fn = getattr(gpu_bvh_walk, f"trace_{query}_walk")
        with pytest.raises(RuntimeError, match="interpret=True"):
            fn(tables, o, d, jnp.float32(1e-4), jnp.float32(1e30))


class TestGatherRows:
    def test_gpu_branch_equals_one_hot(self):
        """gather_rows (`table[idx]`, the form the GPU measured fastest)
        equals the one-hot matmul bit for bit."""
        r = np.random.default_rng(0)
        table = jnp.asarray(r.random((36, 52), np.float32))
        idx = jnp.asarray(r.integers(0, 36, 1000), jnp.int32)
        ref = np.asarray(gather.one_hot_matmul_gather(table, idx))
        np.testing.assert_array_equal(np.asarray(gather.gather_rows(table, idx)),
                                      ref)


class TestBench:
    @pytest.mark.parametrize("gpu", [False, True])
    def test_bigscene_times_the_tracer_a_pass_takes(self, monkeypatch, gpu):
        """bench_bigscene sweeps with the trace tracer="auto" routes to: the
        walk kernel where a GPU would run it, the XLA walk elsewhere."""
        import bench
        from fermat_tpu.integrators import pt
        from fermat_tpu.ops import gpu_bvh_walk

        calls = []

        def spy(module, name, **kw):
            fn = getattr(module, name)

            def wrapped(*args, **kwargs):
                calls.append(name)
                return fn(*args, **kwargs, **kw)
            monkeypatch.setattr(module, name, wrapped)

        spy(gpu_bvh_walk, "trace_closest_walk", interpret=True)
        spy(pt, "trace_closest")
        spy(pt, "trace_closest_brute")
        if gpu:
            monkeypatch.setattr(platform, "on_gpu", lambda: True)
            monkeypatch.setattr(platform, "per_platform",
                                lambda args, gpu, other: gpu(*args))
        # 40 boxes: 516 triangles, above no threshold on the GPU and below
        # the CPU's brute-force threshold; tracer="auto" as in a pass
        out = bench.bench_bigscene(n_boxes=40, res=(8, 8))
        assert out["bigscene600k_camera_mrays"] > 0
        want = "trace_closest_walk" if gpu else "trace_closest_brute"
        assert calls and set(calls) == {want}


class TestChipSmoke:
    def test_device_check_refuses_cpu(self, capsys):
        import chip_smoke

        with pytest.raises(SystemExit) as e:
            chip_smoke.require_gpu()
        assert e.value.code not in (0, None)
        with pytest.raises(SystemExit):
            chip_smoke.main([])
        assert '"ok"' not in capsys.readouterr().out


class TestNativeBuild:
    def test_builds_from_source_and_rebuilds_when_newer(self, monkeypatch,
                                                        tmp_path):
        from fermat_tpu.utils import native

        if shutil.which("g++") is None:
            pytest.skip("no C++ compiler")
        src = tmp_path / "fermat_native.cpp"
        shutil.copy(native._SRC, src)
        so = tmp_path / "build" / "libfermat_native.so"
        monkeypatch.setattr(native, "_SRC", str(src))
        monkeypatch.setattr(native, "_SO", str(so))
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        assert native.available() and so.exists()
        built = so.stat().st_mtime
        os.utime(src, (built + 10, built + 10))
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        assert native.available()
        assert so.stat().st_mtime > built


@pytest.mark.gpu
def test_compiled_walk_kernel_matches_brute(gpu):
    """On a card: the compiled (not interpreted) kernel finds the
    brute-force hits."""
    from fermat_tpu.accel.bvh import build_bvh_for_mesh
    from fermat_tpu.accel.traverse import trace_closest_brute
    from fermat_tpu.core.camera import generate_camera_rays
    from fermat_tpu.ops.gpu_bvh_walk import pack, trace_closest_walk
    from fermat_tpu.scene.procedural import cornell_camera

    mesh = cornell_box().device_view()
    bvh = build_bvh_for_mesh(mesh)
    half = jnp.full(64 * 64, 0.5)
    o, d, _ = generate_camera_rays(cornell_camera(), 64, 64, half, half)
    tmin, tmax = jnp.float32(1e-3), jnp.float32(1e9)
    hb = trace_closest_brute(mesh, o, d, tmin, tmax)
    hk = trace_closest_walk(tables, o, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(hb.tri), np.asarray(hk.tri))
    np.testing.assert_allclose(np.asarray(hb.t), np.asarray(hk.t), rtol=1e-5)
