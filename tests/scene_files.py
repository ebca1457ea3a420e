"""Scene files written from the procedural meshes, for the loader tests.

Each writer emits one of the formats the loaders read (obj + mtl, ply,
fa, pbrt) into a directory the test owns, so the tests need no asset
checkout.
"""
import os

import numpy as np

from fermat_tpu.scene.procedural import big_room, cornell_box

FA_FOV = 1.768946  # radians; an arbitrary value the loader must carry


def write_obj(path, storage, normals=False, negative=False):
    """obj + mtl. normals=True adds per-vertex `vn` (face normals) and
    `vt` from the mesh uvs; negative=True writes relative (negative)
    indices."""
    base = os.path.splitext(path)[0]
    mtl = base + ".mtl"
    with open(mtl, "w") as f:
        for m in storage.materials:
            f.write(f"newmtl {m.name}\n")
            f.write("Kd %g %g %g\n" % tuple(m.diffuse))
            f.write("Ke %g %g %g\n" % tuple(m.emissive))
            f.write("Ks %g %g %g\n" % tuple(m.specular))
            f.write(f"Ns {m.phong_exponent:g}\n\n")
    v = storage.vertices
    t = storage.triangles
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl)}\n")
        current = None
        n_written = 0
        for k in range(t.shape[0]):
            mid = int(storage.material_ids[k])
            if mid != current:
                f.write(f"usemtl {storage.materials[mid].name}\n")
                current = mid
            tri = v[t[k]]
            for p in tri:
                f.write("v %.7g %.7g %.7g\n" % tuple(p))
            n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
            n = n / max(np.linalg.norm(n), 1e-20)
            if normals:
                for j in range(3):
                    f.write("vn %.7g %.7g %.7g\n" % tuple(n))
                    f.write("vt %.7g %.7g\n" % (j * 0.5, j % 2 * 0.5))
            n_written += 3
            ids = ([-3, -2, -1] if negative
                   else [n_written - 2, n_written - 1, n_written])
            if normals:
                f.write("f " + " ".join(f"{i}/{i}/{i}" for i in ids) + "\n")
            else:
                f.write("f " + " ".join(str(i) for i in ids) + "\n")
    return path


def write_ply(path, storage):
    """Binary little-endian ply of the mesh geometry."""
    v = np.ascontiguousarray(storage.vertices, "<f4")
    t = storage.triangles
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {v.shape[0]}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {t.shape[0]}\n"
              "property list uchar int vertex_indices\nend_header\n")
    faces = np.zeros(t.shape[0], dtype=[("n", "u1"), ("i", "<i4", 3)])
    faces["n"] = 3
    faces["i"] = t
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(v.tobytes())
        f.write(faces.tobytes())
    return path


def write_fa(directory):
    """A .fa composing two Cornell boxes (the second glossy, scaled x3 and
    lifted), a camera and a directional light."""
    write_obj(os.path.join(directory, "CornellBox.obj"), cornell_box())
    write_obj(os.path.join(directory, "CornellBox-Glossy.obj"),
              cornell_box(glossy_boxes=True), normals=True)
    fa = os.path.join(directory, "scene.fa")
    with open(fa, "w") as f:
        f.write("# two boxes\n"
                "LoadMesh CornellBox.obj\n"
                "Begin\n"
                "  Translate 0 1.5 -8\n"
                "  Scale 3 3 3\n"
                "  LoadMesh CornellBox-Glossy.obj\n"
                "End\n"
                f"Camera persp eye 0 1 6 aim 0 1 0 up 0 1 0 fov {FA_FOV}\n"
                "DirectionalLight direction 0 -1 -0.2 color 2 2 2\n")
    return fa


def write_pbrt(directory):
    """A material-testball-like pbrt scene: plymesh objects with named
    materials, a checkerboard floor, an infinite light and a 1280x720 film."""
    os.makedirs(os.path.join(directory, "models"), exist_ok=True)
    write_ply(os.path.join(directory, "models", "Mesh000.ply"),
              big_room(n_boxes=90))
    write_ply(os.path.join(directory, "models", "Mesh001.ply"),
              cornell_box())
    path = os.path.join(directory, "scene.pbrt")
    with open(path, "w") as f:
        f.write(
            'Film "image" "integer xresolution" [1280] '
            '"integer yresolution" [720]\n'
            "LookAt 0 4 14  0 1 0  0 1 0\n"
            'Camera "perspective" "float fov" [40]\n'
            "WorldBegin\n"
            'LightSource "infinite" "rgb L" [0.6 0.6 0.6]\n'
            'MakeNamedMaterial "RoughMetal" "string type" ["matte"] '
            '"rgb Kd" [0.5 0.4 0.3]\n'
            'MakeNamedMaterial "Stand" "string type" ["matte"] '
            '"rgb Kd" [0.2 0.2 0.2]\n'
            'Texture "checks" "spectrum" "checkerboard" '
            '"rgb tex1" [0.1 0.1 0.1] "rgb tex2" [0.8 0.8 0.8] '
            '"float uscale" [8] "float vscale" [8]\n'
            'MakeNamedMaterial "Floor" "string type" ["matte"] '
            '"texture Kd" ["checks"]\n'
            'NamedMaterial "RoughMetal"\n'
            'Shape "plymesh" "string filename" ["models/Mesh000.ply"]\n'
            'NamedMaterial "Stand"\n'
            'Shape "plymesh" "string filename" ["models/Mesh001.ply"]\n'
            'NamedMaterial "Floor"\n'
            'Shape "trianglemesh" "point P" [-20 0 -20  20 0 -20  20 0 20  '
            '-20 0 20] "float uv" [0 0 1 0 1 1 0 1] '
            '"integer indices" [0 1 2  0 2 3]\n'
            "WorldEnd\n")
    return path
