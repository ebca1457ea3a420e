"""Masked shadow rays: materials flagged FLAG_SHADOW_*_IGNORE are invisible
to that class of NEE shadow rays while remaining visible to closest-hit
rays.

Reference analog: optix_base_shadow_shaders.h:55-59 (any-hit ignores
triangles with (ray.mask & flags) != 0) with the masks set per NEE strategy
(pathtracer_core.h:981 direct = 0x1, :1099 indirect = 0x2). Shape: the
flags are static, so each used mask bit gets a pre-filtered occlusion-only
geometry set (scene/view.py shadow_sets) instead of a per-ray branch.
"""
import numpy as np

from fermat_tpu.render.context import RenderingContext
from fermat_tpu.scene.materials import (
    FLAG_SHADOW_DIRECT_IGNORE,
    FLAG_SHADOW_INDIRECT_IGNORE,
)
from fermat_tpu.scene.procedural import cornell_box, cornell_camera
from fermat_tpu.scene.view import SceneView

RES = 24


def _blocker_scene(flags=0):
    """Cornell plus an opaque panel directly under the light."""
    import numpy as np

    from fermat_tpu.scene.materials import HostMaterial
    from fermat_tpu.scene.mesh import MeshStorage
    from fermat_tpu.scene.procedural import _quad

    base = cornell_box(light_size=2.0)
    vs, tris, mats = [], [], []
    # full-ceiling panel just below the light: no direct light leaks around
    # the edges, so the direct-NEE signal is clean
    _quad(vs, tris, mats, [-0.99, 1.9, 0.99], [0.99, 1.9, 0.99],
          [0.99, 1.9, -0.99], [-0.99, 1.9, -0.99], 0)
    m = HostMaterial("blocker")
    m.diffuse = (0.2, 0.2, 0.2)
    m.flags = flags
    t = np.asarray(tris, np.int32)
    panel = MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1),
        material_ids=np.asarray(mats, np.int32),
        materials=[m],
        group_names=["blocker"],
        group_offsets=np.asarray([0, 2], np.int32),
    )
    return base.merge(panel)


def _render(scene, passes=6, **opts):
    ctx = RenderingContext.create(
        scene, cornell_camera(), RES, RES, renderer="pt",
        max_path_length=2, **opts,
    )
    return np.asarray(ctx.render(passes).composited)


class TestShadowSets:
    def test_no_flags_builds_no_sets(self):
        view = SceneView.build(cornell_box(), cornell_camera())
        assert view.shadow_sets is None

    def test_flagged_builds_filtered_sets(self):
        scene = _blocker_scene(flags=FLAG_SHADOW_DIRECT_IGNORE)
        view = SceneView.build(scene, cornell_camera())
        assert view.shadow_sets is not None
        sd, si = view.shadow_sets
        assert sd is not None and si is None
        assert sd.mesh.n_triangles == view.mesh.n_triangles - 2

    def test_direct_ignore_lets_light_through(self):
        """The flagged blocker stops occluding direct NEE: the floor under
        the light gets much brighter than with the opaque blocker, while
        camera rays still see the blocker itself."""
        img_opaque = _render(_blocker_scene(flags=0))
        img_masked = _render(
            _blocker_scene(flags=FLAG_SHADOW_DIRECT_IGNORE
                           | FLAG_SHADOW_INDIRECT_IGNORE))
        img_free = _render(cornell_box(light_size=2.0))
        assert np.isfinite(img_masked).all()
        # lower half of the image (floor region) brightness ordering:
        # masked-blocker ~ no-blocker >> opaque-blocker
        lower = lambda im: im[RES // 2:].mean()
        assert lower(img_masked) > 5.0 * max(lower(img_opaque), 1e-6), (
            lower(img_masked), lower(img_opaque))
        # only the NEE half of the MIS estimator passes the mask (BSDF-
        # sampled rays still hit the panel — same asymmetry as the
        # reference's shadow-only masking), so the masked image recovers a
        # fraction of the free scene's direct light, not all of it
        assert lower(img_masked) > 0.08 * lower(img_free), (
            lower(img_masked), lower(img_free))

    def test_unflagged_behavior_unchanged(self):
        """flags == 0 renders bit-identically with and without the
        shadow-set machinery in the code path."""
        scene = cornell_box(light_size=2.0)
        view = SceneView.build(scene, cornell_camera())
        assert view.shadow_sets is None
        img = _render(scene, passes=2)
        assert np.isfinite(img).all()
