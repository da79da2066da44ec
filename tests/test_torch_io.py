"""The port's asset I/O (solr_tpu_torch.io) against solr_tpu.io.

* OBJ + MTL, PDB and SWC: the reference's test texts (tests/test_io.py)
  and an OBJ with n-gons, negative indices, three materials (one name
  unknown to the library, faces before any usemtl) and a diffuse
  texture, loaded by both packages into builders whose scenes must be
  equal, array by array.  The reference parses OBJ natively where it can
  build its parser and in Python otherwise; both are held here.
* IRT: round trips within the port, and files crossing the packages in
  both directions, load into equal scenes; each loaded scene's frame
  equals the original's at atol 1e-6 (the reference's own bound,
  tests/test_io.py), and the port's frame of the reference's file is
  held to the reference's frame of it at atol 1e-4 outside 0.2% of
  pixels (ROADMAP C1); a version-1 file loads with its texture slots
  unset.
* PNG: written by the port and read by Pillow and by the port, written
  by Pillow and read by the port, equal.  A TGA texture goes into a
  scene.
"""

import contextlib
import io
import json
import zipfile

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import solr_tpu as st
from solr_tpu import io as ref_io
from solr_tpu.ops.render import render_sample as ref_render_sample
from solr_tpu.scenes import make_scene as ref_make_scene

from data.torch_reference import GALLERY_OP_BY_OP
from test_io import MTL_TEXT, OBJ_TEXT, PDB_TEXT, SWC_TEXT
from torch_scene_helpers import (assert_image_close, assert_same_camera,
                                 assert_same_scene)
from solr_tpu_torch import io as port_io
from solr_tpu_torch.io.image import save_image
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.scenes import make_scene
from solr_tpu_torch.types import Camera, RenderConfig

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

# n-gons, negative indices, usemtl before and after faces, a material the
# library lacks, uvs on one group only, normals on another.
OBJ_MIXED = """\
mtllib mixed.mtl
v 0 0 0
v 2 0 0
v 2 2 0
v 0 2 0
v 1 3 0.5
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 -1
f 1 2 3
usemtl textured
f 1/1 2/2 3/3 4/4
usemtl missing
f -5//1 -4//1 -3//1 -2//1 -1//1
usemtl glass
f 3 4 5
usemtl textured
f 2/2 3/3 5/4
"""
MTL_MIXED = """\
newmtl textured
Kd 0.9 0.9 0.9
map_Kd checker.png
newmtl glass
Kd 0.8 0.9 1.0
Ks 0.5 0.7 0.2
Ns 80
d 0.2
Ni 1.5
illum 4
"""


def _load_both(tmp_path, loader, name, text, **kw):
    path = str(tmp_path / name)
    (tmp_path / name).write_text(text)
    rb, pb = st.SceneBuilder(), SceneBuilder()
    ref = getattr(ref_io, loader)(path, rb, **kw)
    port = getattr(port_io, loader)(path, pb, **kw)
    assert port == ref
    return rb, pb


# The reference's OBJ parsers: native (its default where it can build
# it) and the Python fallback.  The fallback groups faces by material id
# where the native parser groups them by usemtl slot, so the two order
# the triangles of OBJ_MIXED differently (faces before any usemtl and
# the unknown "missing" both take material 0; a material override makes
# one group); without those faces they agree.  The port follows the
# native parser.
OBJ_CASES = [("native", "test_io"), ("python", "test_io"),
             ("native", "mixed"), ("python", "mixed_named")]


@pytest.mark.parametrize("parser,case", OBJ_CASES,
                         ids=["-".join(c) for c in OBJ_CASES])
def test_obj_matches_reference(tmp_path, monkeypatch, parser, case):
    if parser == "python":
        monkeypatch.setenv("SOLR_NO_NATIVE_OBJ", "1")
    if case == "test_io":
        (tmp_path / "test.mtl").write_text(MTL_TEXT)
        rb, pb = _load_both(tmp_path, "load_obj", "test.obj", OBJ_TEXT)
    else:
        text = OBJ_MIXED
        if case == "mixed_named":
            text = text.replace("f 1 2 3\n", "", 1).replace("missing",
                                                             "glass", 1)
        (tmp_path / "mixed.mtl").write_text(MTL_MIXED)
        tex = np.zeros((4, 4, 3), np.uint8)
        tex[::2, ::2] = 255
        Image.fromarray(tex).save(tmp_path / "checker.png")
        rb, pb = _load_both(tmp_path, "load_obj", "mixed.obj", text,
                            scale=1.5)
    for kw in (dict(use_bvh=False), dict(bvh_threshold=1)):
        assert_same_scene(pb.build(device="cpu", **kw), rb.build(**kw))


def test_obj_material_override(tmp_path):
    (tmp_path / "mixed.mtl").write_text(MTL_MIXED)
    rb, pb = _load_both(tmp_path, "load_obj", "mixed.obj", OBJ_MIXED,
                        material=0, center=False)
    assert_same_scene(pb.build(device="cpu", use_bvh=False),
                      rb.build(use_bvh=False))


@pytest.mark.parametrize("loader,name,text,kw", [
    ("load_pdb", "m.pdb", PDB_TEXT, {}),
    ("load_pdb", "m.pdb", PDB_TEXT, dict(mode=3)),
    ("load_swc", "n.swc", SWC_TEXT, dict(scale=0.1)),
], ids=["pdb", "pdb_backbone", "swc"])
def test_pdb_swc_match_reference(tmp_path, loader, name, text, kw):
    rb, pb = _load_both(tmp_path, loader, name, text, **kw)
    assert_same_scene(pb.build(device="cpu", bvh_threshold=1),
                      rb.build(bvh_threshold=1))


# -- IRT ---------------------------------------------------------------

IRT_CFG = dict(width=24, height=24, max_bounces=2)


def _port_frame(scene, cam):
    with torch.no_grad():
        return render_sample(scene, cam, RenderConfig(**IRT_CFG))[0].numpy()


@pytest.mark.parametrize("name", ["terrain", "knot", "cornell"])
def test_irt_roundtrip_in_port(tmp_path, name):
    demo = make_scene(name, seed=1, device="cpu")
    path = str(tmp_path / "s.irt")
    port_io.save_scene(path, demo.scene, demo.camera)
    scene, cam = port_io.load_scene(path, device="cpu")
    assert scene.tri_accel is None and scene.sph_accel is None
    assert_same_camera(cam, demo.camera)
    np.testing.assert_allclose(_port_frame(scene, cam),
                               _port_frame(demo.scene, demo.camera),
                               atol=1e-6)


@pytest.mark.parametrize("name", ["terrain", "knot"])
def test_irt_crosses_packages(tmp_path, name):
    ref, port = ref_make_scene(name, seed=1), make_scene(name, seed=1,
                                                         device="cpu")
    from_ref, from_port = str(tmp_path / "r.irt"), str(tmp_path / "p.irt")
    ref_io.save_scene(from_ref, ref.scene, ref.camera)
    port_io.save_scene(from_port, port.scene, port.camera)
    # Each package loads both files into the same scene.
    ref_scenes = [ref_io.load_scene(p) for p in (from_ref, from_port)]
    port_scenes = [port_io.load_scene(p, device="cpu")
                   for p in (from_ref, from_port)]
    for (ps, pc), (rs, rc) in zip(port_scenes, ref_scenes):
        assert_same_scene(ps, rs)
        assert_same_camera(pc, rc)
    # The port's frame of the reference's file, and the reference's frame
    # of the port's file, equal each package's original frame.
    np.testing.assert_allclose(_port_frame(*port_scenes[0]),
                               _port_frame(port.scene, port.camera),
                               atol=1e-6)
    cfg = st.RenderConfig(**IRT_CFG)
    np.testing.assert_allclose(
        np.asarray(ref_render_sample(*ref_scenes[1], cfg)[0]),
        np.asarray(ref_render_sample(ref.scene, ref.camera, cfg)[0]),
        atol=1e-6)
    # The port's frame of the reference's file against the reference's
    # frame of it; the knot op by op, as its jitted cylinder arithmetic
    # is contracted into FMAs (ROADMAP C12).
    with (jax.disable_jit() if name in GALLERY_OP_BY_OP
          else contextlib.nullcontext()):
        ref_frame = np.asarray(ref_render_sample(*ref_scenes[0], cfg)[0])
    assert_image_close(_port_frame(*port_scenes[0]), ref_frame)


def test_irt_version_1(tmp_path):
    demo = make_scene("cornell", seed=1, device="cpu")
    path = str(tmp_path / "v2.irt")
    port_io.save_scene(path, demo.scene)
    with zipfile.ZipFile(path) as z:
        header = json.loads(z.read("header.json"))
        arrays = dict(np.load(io.BytesIO(z.read("arrays.npz"))))
    for slot in ("specular", "reflection", "transparency"):
        del arrays[f"materials.texture_{slot}"]
    header["version"] = 1
    old = str(tmp_path / "v1.irt")
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with zipfile.ZipFile(old, "w") as z:
        z.writestr("header.json", json.dumps(header))
        z.writestr("arrays.npz", buf.getvalue())
    scene, cam = port_io.load_scene(old, device="cpu")
    assert cam is None
    n = demo.scene.materials.color.shape[0]
    for slot in ("specular", "reflection", "transparency"):
        t = getattr(scene.materials, f"texture_{slot}")
        assert t.dtype == torch.int32 and t.tolist() == [-1] * n
    ref_scene, _ = ref_io.load_scene(old)
    assert_same_scene(scene, ref_scene)
    header["version"] = 3
    with zipfile.ZipFile(old, "w") as z:
        z.writestr("header.json", json.dumps(header))
        z.writestr("arrays.npz", buf.getvalue())
    with pytest.raises(ValueError):
        port_io.load_scene(old, device="cpu")


# -- images ------------------------------------------------------------

def _pixels(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_written_by_port(tmp_path, channels):
    px = _pixels((13, 7, channels))
    path = str(tmp_path / "p.png")
    save_image(path, px)
    with Image.open(path) as img:
        np.testing.assert_array_equal(np.asarray(img), px)
    rgba = port_io.load_image(path)
    assert rgba.shape == (13, 7, 4)
    np.testing.assert_array_equal(rgba[..., :channels], px)


@pytest.mark.parametrize("mode,channels", [("RGB", 3), ("RGBA", 4),
                                           ("L", 1), ("LA", 2)])
def test_png_written_by_pillow(tmp_path, mode, channels):
    y, x = np.mgrid[0:40, 0:33]
    px = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256, (y * 5) % 256,
                   255 - x], -1)[..., :channels].astype(np.uint8)
    path = str(tmp_path / "q.png")
    Image.fromarray(px.squeeze(-1) if channels == 1 else px, mode).save(
        path, optimize=True)
    with Image.open(path) as img:
        np.testing.assert_array_equal(port_io.load_image(path),
                                      np.asarray(img.convert("RGBA")))
    np.testing.assert_array_equal(port_io.load_image(path),
                                  ref_io.load_image(path))


def test_save_image_float_matches_reference(tmp_path):
    img = np.random.default_rng(1).uniform(-0.1, 1.1, (6, 5, 3))
    ref_io.image.save_image(str(tmp_path / "r.png"), img)
    save_image(str(tmp_path / "p.png"), img)
    np.testing.assert_array_equal(port_io.load_image(str(tmp_path / "p.png")),
                                  ref_io.load_image(str(tmp_path / "r.png")))


def test_texture_into_scene(tmp_path):
    img = np.zeros((4, 4, 4), np.uint8)
    img[..., 0] = 255
    p = str(tmp_path / "tex.tga")
    save_image(p, img)
    b = SceneBuilder()
    tid = b.add_texture(port_io.load_image(p))
    m = b.add_material(texture_diffuse=tid)
    b.add_sphere((0, 0, 2), 1.0, m)
    b.add_light((2, 2, -2))
    scene = b.build(use_bvh=False, device="cpu")
    with torch.no_grad():
        arr, _ = render_sample(scene, Camera.create(device="cpu"),
                               RenderConfig(width=16, height=16,
                                            max_bounces=1))
    assert arr[..., 0].max() > arr[..., 1].max()  # the red texture shows
    np.testing.assert_array_equal(port_io.load_image(p),
                                  ref_io.load_image(p))
