"""PBRT importer directive coverage (pbrt_importer.cpp/pbrt_parser.cpp
analog — tests are synthetic scenes written to tmp_path)."""
import math
import os

import numpy as np
import pytest

from fermat_tpu.scene.loaders.pbrt import load_pbrt


def _load(tmp_path, text, name="s.pbrt"):
    (tmp_path / name).write_text(text)
    return load_pbrt(str(tmp_path / name))


TRI = ('Shape "trianglemesh" "point P" [0 0 0  1 0 0  0 1 0] '
       '"integer indices" [0 1 2]\n')


class TestTransforms:
    def test_lookat_camera(self, tmp_path):
        pb = _load(tmp_path,
                   "LookAt 1 2 3  1 2 7  0 1 0\n"
                   'Camera "perspective" "float fov" [40]\n'
                   "WorldBegin\n" + TRI)
        assert pb.camera is not None
        # eye recovered from the world-to-camera CTM
        o = np.asarray([pb.camera.eye.x, pb.camera.eye.y, pb.camera.eye.z])
        np.testing.assert_allclose(o, [1, 2, 3], atol=1e-5)
        a = np.asarray([pb.camera.aim.x, pb.camera.aim.y, pb.camera.aim.z])
        d = a - o
        np.testing.assert_allclose(d / np.linalg.norm(d), [0, 0, 1], atol=1e-5)

    def test_translate_rotate_scale(self, tmp_path):
        pb = _load(tmp_path,
                   "WorldBegin\n"
                   "Translate 10 0 0\n"
                   "Rotate 90 0 0 1\n"   # +x -> +y
                   "Scale 2 2 2\n" + TRI)
        v = pb.mesh.vertices
        # (1,0,0) -> scale (2,0,0) -> rotate (0,2,0) -> translate (10,2,0)
        np.testing.assert_allclose(v[1], [10, 2, 0], atol=1e-5)

    def test_attribute_stack_restores_material(self, tmp_path):
        pb = _load(tmp_path,
                   "WorldBegin\n"
                   'MakeNamedMaterial "red" "string type" ["matte"] '
                   '"rgb Kd" [1 0 0]\n'
                   'MakeNamedMaterial "blue" "string type" ["matte"] '
                   '"rgb Kd" [0 0 1]\n'
                   'NamedMaterial "red"\n'
                   "AttributeBegin\n"
                   'NamedMaterial "blue"\n'
                   "Translate 5 0 0\n" + TRI +
                   "AttributeEnd\n" + TRI)
        mats = pb.mesh.materials
        ids = pb.mesh.material_ids
        assert mats[ids[0]].diffuse == (0.0, 0.0, 1.0)  # inside: blue, moved
        assert mats[ids[1]].diffuse == (1.0, 0.0, 0.0)  # after: red, origin
        np.testing.assert_allclose(pb.mesh.vertices[1], [6, 0, 0], atol=1e-5)
        np.testing.assert_allclose(pb.mesh.vertices[4], [1, 0, 0], atol=1e-5)

    def test_film_exposure_gamma(self, tmp_path):
        """Film exposure/gamma copied out like renderer.cu:716-717."""
        pb = _load(tmp_path,
                   'Film "image" "integer xresolution" [64] '
                   '"integer yresolution" [32] "float exposure" [2.5] '
                   '"float gamma" [1.8]\n'
                   "WorldBegin\n" + TRI)
        assert pb.resolution == (64, 32)
        assert pb.exposure == pytest.approx(2.5)
        assert pb.gamma == pytest.approx(1.8)

    def test_include(self, tmp_path):
        (tmp_path / "geo.pbrt").write_text(TRI)
        pb = _load(tmp_path, 'WorldBegin\nInclude "geo.pbrt"\n')
        assert pb.mesh.n_triangles == 1


class TestShapes:
    def test_sphere_tessellation(self, tmp_path):
        pb = _load(tmp_path,
                   "WorldBegin\nTranslate 1 2 3\n"
                   'Shape "sphere" "float radius" [2]\n')
        v = pb.mesh.vertices - np.asarray([1, 2, 3], np.float32)
        r = np.linalg.norm(v, axis=1)
        np.testing.assert_allclose(r, 2.0, atol=1e-4)
        assert pb.mesh.n_triangles > 500

    def test_disk(self, tmp_path):
        pb = _load(tmp_path,
                   "WorldBegin\n"
                   'Shape "disk" "float radius" [3] "float height" [1]\n')
        v = pb.mesh.vertices
        np.testing.assert_allclose(v[:, 2], 1.0, atol=1e-6)
        assert np.linalg.norm(v[:, :2], axis=1).max() == pytest.approx(3.0)

    def test_object_instance(self, tmp_path):
        pb = _load(tmp_path,
                   "WorldBegin\n"
                   'ObjectBegin "gem"\n' + TRI + "ObjectEnd\n"
                   "Translate 5 0 0\n"
                   'ObjectInstance "gem"\n'
                   "Translate 0 5 0\n"
                   'ObjectInstance "gem"\n')
        assert pb.mesh.n_triangles == 2
        np.testing.assert_allclose(pb.mesh.vertices[0], [5, 0, 0], atol=1e-5)
        np.testing.assert_allclose(pb.mesh.vertices[3], [5, 5, 0], atol=1e-5)


class TestMaterialsAndLights:
    def test_anonymous_material(self, tmp_path):
        pb = _load(tmp_path,
                   "WorldBegin\n"
                   'Material "matte" "rgb Kd" [0.2 0.4 0.6]\n' + TRI)
        assert pb.mesh.materials[pb.mesh.material_ids[0]].diffuse == \
            (0.2, 0.4, 0.6)

    def test_area_light_attaches_emission(self, tmp_path):
        pb = _load(tmp_path,
                   "WorldBegin\n"
                   'Material "matte" "rgb Kd" [0.5 0.5 0.5]\n'
                   "AttributeBegin\n"
                   'AreaLightSource "diffuse" "rgb L" [5 6 7]\n' + TRI +
                   "AttributeEnd\n" + TRI)
        mats = pb.mesh.materials
        ids = pb.mesh.material_ids
        assert mats[ids[0]].emissive == (5.0, 6.0, 7.0)
        assert mats[ids[1]].emissive == (0.0, 0.0, 0.0)  # restored

    def test_distant_and_point_lights(self, tmp_path):
        pb = _load(tmp_path,
                   "WorldBegin\n"
                   'LightSource "distant" "point from" [0 10 0] '
                   '"point to" [0 0 0] "rgb L" [2 2 2]\n'
                   'LightSource "point" "point from" [1 2 3] '
                   '"rgb I" [9 9 9]\n' + TRI)
        assert len(pb.dir_lights) == 1
        d = np.asarray(pb.dir_lights[0].direction)
        np.testing.assert_allclose(d / np.linalg.norm(d), [0, -1, 0],
                                   atol=1e-6)
        assert pb.point_lights == (((1.0, 2.0, 3.0), (9.0, 9.0, 9.0)),)

    def test_checkerboard_bakes_texture(self, tmp_path):
        pb = _load(tmp_path,
                   "WorldBegin\n"
                   'Texture "ch" "spectrum" "checkerboard" '
                   '"rgb tex1" [0 0 0] "rgb tex2" [1 1 1] '
                   '"float uscale" [4] "float vscale" [4]\n'
                   'Material "matte" "texture Kd" ["ch"]\n' + TRI)
        m = pb.mesh.materials[pb.mesh.material_ids[0]]
        assert m.diffuse == (1.0, 1.0, 1.0)  # white, modulated by the map
        assert os.path.exists(m.diffuse_map_name)
        from fermat_tpu.utils.image import read_tga

        img = read_tga(m.diffuse_map_name)
        # 4x4 checker: opposite corners share a color, adjacent cells flip
        assert img[10, 10, 0] != img[10, 74, 0]
        assert img[10, 10, 0] == img[74, 74, 0]

    def test_imagemap_texture(self, tmp_path):
        from fermat_tpu.utils.image import write_tga

        tex = np.zeros((8, 8, 3), np.float32)
        tex[:, :4] = 0.25
        write_tga(str(tmp_path / "wood.tga"), tex)
        pb = _load(tmp_path,
                   "WorldBegin\n"
                   'Texture "wood" "spectrum" "imagemap" '
                   '"string filename" ["wood.tga"]\n'
                   'Material "matte" "texture Kd" ["wood"]\n' + TRI)
        m = pb.mesh.materials[pb.mesh.material_ids[0]]
        assert m.diffuse_map_name == str(tmp_path / "wood.tga")


class TestBundledScene:
    def test_material_testball_loads_checker_file(self, tmp_path):
        from scene_files import write_pbrt

        pb = load_pbrt(write_pbrt(str(tmp_path)))
        tex_mats = [m for m in pb.mesh.materials if m.diffuse_map_name]
        assert tex_mats, "checkerboard floor should carry a baked texture"
        assert all(os.path.exists(m.diffuse_map_name) for m in tex_mats)
