"""The port's native host library (solr_tpu_torch.native, built with g++)
against its plain versions and against solr_tpu.native: the LBVH build,
triangle AABBs and the OBJ parser (the cases of tests/test_native.py).

Node arrays, orders and AABBs compare exactly: both builders compute the
same float32 operations.  The OBJ files are written with ``%.9g``, which
gives each float32 back exactly through a single rounding (``strtof``)
and through Python's double one (``float`` then float32).
"""

import os
import shutil

import numpy as np
import pytest

import solr_tpu as st
from solr_tpu import native as ref_native
from solr_tpu.io.obj import load_obj as ref_load_obj

from solr_tpu_torch import native
from solr_tpu_torch.io.obj import load_obj, parse_obj
from solr_tpu_torch.ops.bvh import build_bvh, build_bvh_plain
from solr_tpu_torch.scene import SceneBuilder

BVH_ARRAYS = ("aabb_min", "aabb_max", "skip", "first_prim", "prim_count",
              "depth", "leaf_center", "leaf_radius", "leaf_first",
              "leaf_count")


def _random_aabbs(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return c - h, c + h


def _assert_same_bvh(got, want):
    for name in BVH_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)
    assert (got.max_depth, got.leaf_size) == (want.max_depth, want.leaf_size)


@pytest.mark.parametrize("n", [1, 3, 64, 65, 1000, 4097])
@pytest.mark.parametrize("leaf_size", [4, 8, 64])
def test_lbvh_matches_numpy_and_reference(n, leaf_size):
    amin, amax = _random_aabbs(n, seed=n)
    b_nat, o_nat = build_bvh(amin, amax, leaf_size, "cpu")
    b_np, o_np = build_bvh_plain(amin, amax, leaf_size, "cpu")
    np.testing.assert_array_equal(o_nat, o_np)
    _assert_same_bvh(b_nat, b_np)
    got = native.lbvh_build(amin, amax, leaf_size)
    want = ref_native.lbvh_build(amin, amax, leaf_size)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_lbvh_tree_invariants():
    amin, amax = _random_aabbs(2000, seed=7)
    bvh, order = build_bvh(amin, amax, 8, "cpu")
    first, count, skip = (getattr(bvh, k).numpy()
                          for k in ("first_prim", "prim_count", "skip"))
    k = first.shape[0]
    covered = np.zeros(2000, np.int32)  # every primitive in one leaf
    for f, c in zip(first, count):
        if f >= 0:
            covered[f:f + c] += 1
    assert (covered == 1).all()
    assert (skip > np.arange(k)).all() and (skip <= k).all()
    smin, smax = amin[order], amax[order]
    nmin, nmax = bvh.aabb_min.numpy(), bvh.aabb_max.numpy()
    for i in np.nonzero(first >= 0)[0]:
        s = slice(first[i], first[i] + count[i])
        assert (nmin[i] <= smin[s].min(axis=0)).all()
        assert (nmax[i] >= smax[s].max(axis=0)).all()


def test_lbvh_rejects_bad_arguments():
    amin, amax = _random_aabbs(10)
    with pytest.raises(ValueError):
        native.lbvh_build(amin[:0], amax[:0], 8)
    with pytest.raises(ValueError):
        native.lbvh_build(amin, amax[:5], 8)
    with pytest.raises(ValueError):
        native.lbvh_build(amin, amax, 0)
    with pytest.raises(ValueError, match="0 primitives"):
        build_bvh(amin[:0], amax[:0], 8, "cpu")


def test_triangle_aabbs():
    rng = np.random.default_rng(3)
    v0, v1, v2 = (rng.normal(size=(500, 3)).astype(np.float32)
                  for _ in range(3))
    lo, hi = native.triangle_aabbs(v0, v1, v2)
    np.testing.assert_array_equal(lo, np.minimum(np.minimum(v0, v1), v2))
    np.testing.assert_array_equal(hi, np.maximum(np.maximum(v0, v1), v2))
    want = ref_native.triangle_aabbs(v0, v1, v2)
    np.testing.assert_array_equal(lo, want[0])
    np.testing.assert_array_equal(hi, want[1])


DEMO_OBJ = """\
mtllib demo.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vn 0 0 1
vn 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl blue
f 1/1/2 2/2/2 5/1/2
f 3/3/2 4/4/2 5/1/2
f -1/-2/-1 -2/-3/-1 -3/-4/-1
"""
DEMO_MTL = """\
newmtl red
Kd 0.8 0.1 0.1
newmtl blue
Kd 0.1 0.1 0.8
"""


def _grid_obj(directory):
    """tests/test_native.py's 500-vertex, 300-face mesh."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(500, 3)).astype(np.float32)
    faces = rng.integers(1, 501, (300, 3))
    lines = ["v %.9g %.9g %.9g" % tuple(p) for p in v]
    lines += ["f %d %d %d" % tuple(f) for f in faces]
    path = os.path.join(directory, "grid.obj")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path, v, faces


def _demo_obj(directory):
    with open(os.path.join(directory, "demo.mtl"), "w") as fh:
        fh.write(DEMO_MTL)
    path = os.path.join(directory, "demo.obj")
    with open(path, "w") as fh:
        fh.write(DEMO_OBJ)
    return path


def _assert_same_parse(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, list):
            assert got[k] == w, k
        else:
            assert got[k].dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("name", ["demo", "grid"])
def test_obj_load_matches_parse_obj_and_reference(tmp_path, name):
    path = (_demo_obj(tmp_path) if name == "demo"
            else _grid_obj(tmp_path)[0])
    got = native.obj_load(path)
    _assert_same_parse(got, parse_obj(path))
    _assert_same_parse(got, ref_native.obj_load(path))


def test_obj_load_grid_is_exact(tmp_path):
    path, v, faces = _grid_obj(tmp_path)
    got = native.obj_load(path)
    np.testing.assert_array_equal(got["v"], v)
    np.testing.assert_array_equal(got["f_v"], faces - 1)
    assert (got["f_slot"] == -1).all()
    assert (got["f_vt"] == -1).all() and (got["f_vn"] == -1).all()


def test_obj_load_names_past_the_first_buffer(tmp_path):
    """Material names longer than the first 1 MB names buffer: the
    parse is done again with a buffer of the file's size."""
    names = [f"m{i:04d}_" + "x" * 600 for i in range(2000)]
    lines = ["v 0 0 0", "v 1 0 0", "v 0 1 0"]
    for name in names:
        lines += [f"usemtl {name}", "f 1 2 3"]
    path = os.path.join(tmp_path, "names.obj")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    got = native.obj_load(path)
    assert got["usemtls"] == names
    _assert_same_parse(got, parse_obj(path))


def test_obj_load_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        native.obj_load(os.path.join(tmp_path, "absent.obj"))


def _blocks(b):
    return [tuple(np.asarray(x) for x in blk) for blk in b._triangles]


def test_load_obj_blocks_unchanged(tmp_path, monkeypatch):
    """load_obj parses with the native parser; the builder's triangle
    blocks and materials equal those the plain parser gives, and the
    reference's load_obj, block for block."""
    path = _demo_obj(tmp_path)
    b = SceneBuilder()
    load_obj(path, b, center=False)
    ref = st.SceneBuilder()
    ref_load_obj(path, ref, center=False)
    plain = SceneBuilder()
    monkeypatch.setattr(native, "obj_load", parse_obj)
    load_obj(path, plain, center=False)
    got, want, refs = _blocks(b), _blocks(plain), _blocks(ref)
    assert len(got) == len(want) == len(refs) == 2
    for g, w, r in zip(got, want, refs):
        for x, y, z in zip(g, w, r):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    assert len(b._mat) == len(plain._mat) == len(ref._mat) == 3


def test_failed_compile_raises(tmp_path):
    """A source that does not compile raises with g++'s message; nothing
    falls back."""
    srcs = [tmp_path / os.path.basename(p) for p in native.SOURCES]
    for src, dst in zip(native.SOURCES, srcs):
        shutil.copy(src, dst)
    with open(srcs[0], "a") as fh:
        fh.write("\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.compile_library(srcs, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_compile_is_keyed_by_source(tmp_path):
    srcs = [tmp_path / os.path.basename(p) for p in native.SOURCES]
    for src, dst in zip(native.SOURCES, srcs):
        shutil.copy(src, dst)
    first = native.compile_library(srcs, tmp_path)
    assert native.compile_library(srcs, tmp_path) == first
    with open(srcs[1], "a") as fh:
        fh.write("\n// another source\n")
    second = native.compile_library(srcs, tmp_path)
    assert second != first and second.exists()
