"""solr_tpu_torch.ops.packet against solr_tpu.ops.packet on the CPU:
block packing, the bundle culls and the per-strip interval selection.

Tolerances:
* packed rows: rtol 1e-6 plus an atol of 1e-6 x the row's largest
  magnitude.  The reference's XLA CPU build contracts the cross-product
  chains a*b - c*d into FMAs (checked: every jnp.cross component equals
  fma(a, b, -(c*d))), the port rounds each product; a component that
  cancels then differs in its last bits relative to its terms, not to
  itself.
* block bounds: rtol 1e-6 (min/max and one add, no cancellation).
* sphere and cylinder packing: rtol 1e-6 (copies, one subtraction and
  a three-term dot per cylinder).
* sphere and cylinder block mirrors: t at rtol 5e-4 where both hit and
  prim ids equal there, hit/miss on more than 99.9% of the rays, the
  bounds tests/test_pallas_kernels.py sets for the reference's own two
  cylinder forms.  disc = b*b - c subtracts two numbers of about
  |o - c|^2 (400 for a sphere 20 away), so the last bits of b move disc
  by 5e-5, and near tangency sqrt(disc) turns that into 1e-4 of t; the
  reference contracts b*b - c into an FMA, the port does not.  Checked
  against f64 on the worst rays: both sit that far from it, on either
  side (measured 1.4e-4 for spheres, 4.3e-4 for cylinders).
  Transmittance at atol 1e-6.
* selection: counts and dropped equal; candidate lists equal as sets per
  strip, entry bounds equal in sorted order (top-k orders tied scores
  differently in the two frameworks, ROADMAP C7; at a tie on the list's
  cut either tied block may be kept, and each must carry the cut's
  entry).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops import packet as jpk
from solr_tpu.ops.camera import camera_rays as j_camera_rays

from data.torch_reference import numpy_tree, reference_bench_scene
from scenes_fixtures import (random_cylinder_field, random_sphere_field,
                             random_tri_field)
from solr_tpu_torch.bench_scene import bench_scene_arrays
from solr_tpu_torch.convert import scene_from_numpy
from solr_tpu_torch.ops import packet as tpk
from torch_sweep_helpers import tri_blocks_closest, tri_blocks_transmittance

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

CAM_FIELD = st.Camera.create(position=(0, 0, -6.0), fov=1.0)


def _field():
    return random_tri_field(1200).build(bvh_threshold=64), CAM_FIELD


def _terrain():
    scene, cam, _ = reference_bench_scene(bench_scene_arrays(20_000), 64, 64, 2)
    return scene, cam


SCENES = {"field": _field, "terrain": _terrain}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    jscene, jcam = SCENES[request.param]()
    tscene = scene_from_numpy(numpy_tree(jscene), "cpu")
    cfg = st.RenderConfig(width=64, height=64)
    o, d = j_camera_rays(jcam, cfg)
    perm, _ = jpk.tile_permutation(64, 64, 16, 16)
    o_t = np.asarray(o[perm], np.float32).reshape(-1, 256, 3)
    d_t = np.asarray(d[perm], np.float32).reshape(-1, 256, 3)
    return request.param, jscene, tscene, o_t, d_t


def _rows_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(a).max(axis=(0, 2), keepdims=True)
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=0.0 + 1e-6 * scale.max())
    err = np.abs(a - b)
    assert (err <= 1e-6 * np.abs(a) + 1e-6 * scale).all()


def test_build_tri_accel_matches_reference(case):
    _, jscene, _, _, _ = case
    tris = scene_from_numpy(numpy_tree(jscene), "cpu")
    accel = tpk.build_tri_accel(tris.triangles, tris.materials, jpk.BLOCK)
    ref = jscene.tri_accel
    assert accel.block == jpk.BLOCK
    assert accel.packed.shape == ref.packed.shape
    _rows_close(ref.packed, accel.packed.numpy())
    np.testing.assert_allclose(accel.block_bounds.numpy(),
                               np.asarray(ref.block_bounds), rtol=1e-6)


def _strip_entry(accel, o_t, d_t, live, tm, si, j, blk, g):
    """The strip's selection key for one block: the min slab entry over
    its live rays that hit the block (before the light, for shadows)."""
    ssb = o_t.shape[1] // g
    rows = slice(j * ssb, (j + 1) * ssb)
    o = torch.from_numpy(o_t[si:si + 1, rows])
    d = torch.from_numpy(d_t[si:si + 1, rows])
    entry, hit = tpk.slab_entries_g(o, d, accel.block_bounds[blk][None, None],
                                    1e-4)
    hit = hit[0, :, 0] & torch.from_numpy(live[si, rows])
    if tm is not None:
        hit = hit & (entry[0, :, 0] <= torch.from_numpy(tm[si, rows]))
    return float(entry[0, :, 0][hit].min())


def _same_lists(ref, port, accel, o_t, d_t, live, tm):
    """Equal counts and certificates; equal candidate sets, except that a
    tie at the list's cut may keep either of the tied blocks: those must
    then carry the cut's entry value."""
    cand_j, counts_j, nearb_j, dropped_j = (np.asarray(x) for x in ref)
    cand_t, counts_t, nearb_t, dropped_t = (x.numpy() for x in port)
    np.testing.assert_array_equal(counts_t, counts_j)
    np.testing.assert_array_equal(dropped_t, dropped_j)
    s, g, _ = cand_j.shape
    for si in range(s):
        for j in range(g):
            n = counts_j[si, j]
            np.testing.assert_array_equal(np.sort(nearb_t[si, j]),
                                          np.sort(nearb_j[si, j]))
            a, b = set(cand_j[si, j, :n]), set(cand_t[si, j, :n])
            if a == b:
                continue
            cut = nearb_j[si, j, n - 1]
            for blk in a ^ b:
                assert _strip_entry(accel, o_t, d_t, live, tm, si, j, blk,
                                    g) == cut
    assert counts_j.sum() > 0


@pytest.mark.parametrize("shadow", [False, True])
def test_strip_interval_select_matches_reference(case, shadow):
    name, jscene, tscene, o_t, d_t = case
    kt, ks = 48, 8
    live = np.ones(o_t.shape[:2], bool)
    live[1, :40] = False  # a partly parked tile
    tm = np.full(o_t.shape[:2], 12.0, np.float32) if shadow else None
    ref = jpk.strip_interval_select(
        jnp.asarray(o_t), jnp.asarray(d_t), jnp.asarray(live),
        jscene.tri_accel, kt, ks, 1e-4,
        tm_t=None if tm is None else jnp.asarray(tm))
    port = tpk.strip_interval_select(
        torch.from_numpy(o_t), torch.from_numpy(d_t), torch.from_numpy(live),
        tscene.tri_accel, kt, ks, 1e-4,
        tm_t=None if tm is None else torch.from_numpy(tm))
    _same_lists(ref, port, tscene.tri_accel, o_t, d_t, live, tm)


@pytest.mark.parametrize("shadow", [False, True])
def test_drop_certificate_holds_for_wide_bundles(case, shadow):
    """Rays from points in the scene box in every direction, as
    reflections give in later bounces: every real block a ray enters
    (before its light, for shadows) is in its strip's list or starts no
    nearer than the ray's ``dropped``.  The bundles are wide enough for
    the cull to pass the padding blocks too (ROADMAP C4)."""
    _, _, tscene, o_t, _ = case
    accel = tscene.tri_accel
    bb = accel.block_bounds
    real = bb[:, 0] < 1e29
    lo = (bb[real, 0:3] - bb[real, 3:6]).amin(0).numpy()
    hi = (bb[real, 0:3] + bb[real, 3:6]).amax(0).numpy()
    rng = np.random.default_rng(7)
    shape = o_t[:4].shape
    o = torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))
    d = rng.normal(size=shape)
    d = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True))
                         .astype(np.float32))
    live = torch.ones(shape[:2], dtype=torch.bool)
    tm = torch.full(shape[:2], 8.0) if shadow else None
    cand, counts, _, dropped = tpk.strip_interval_select(
        o, d, live, accel, 8, 4, 1e-4, tm_t=tm)

    s, g, _ = cand.shape
    nb = bb.shape[0]
    listed = torch.zeros((s, g, nb), dtype=torch.bool)
    for si in range(s):
        for j in range(g):
            listed[si, j, cand[si, j, :counts[si, j]].long()] = True
    listed = listed.repeat_interleave(shape[1] // g, dim=1)  # (S, SB, NB)
    entry, hit = tpk.slab_entries_g(o, d, bb[None].expand(s, nb, 8), 1e-4)
    hit = hit & real[None, None]
    if tm is not None:
        hit = hit & (entry <= tm[..., None])
    unlisted = hit & ~listed
    assert unlisted.any()  # the lists are short: the certificate has work
    assert (entry[unlisted] >= dropped[..., None].expand_as(entry)[unlisted]
            ).all()


def test_ray_box_exit_matches_reference(case):
    _, jscene, tscene, o_t, d_t = case
    from solr_tpu.ops.traverse import _scene_box as j_box
    from solr_tpu_torch.ops.traverse import _scene_box as t_box

    jb = j_box(jscene.tri_accel)
    tb = t_box(tscene.tri_accel)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    ref = jpk.ray_box_exit(jnp.asarray(o_t), jnp.asarray(d_t), *jb)
    port = tpk.ray_box_exit(torch.from_numpy(o_t), torch.from_numpy(d_t), *tb)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6)


def test_block_mirrors_match_reference(case):
    """tri_blocks_closest / _transmittance over every real block, fractional
    shadow factors.  t at rtol 1e-5: the reference's Woop chains are
    FMA-contracted, and t = -opz / dpz inherits the cancellation in opz
    on grazing rays (measured up to 1.01e-6 relative on the terrain).
    Prim ids equal on hits (no selection change on these rays).
    Transmittance at rtol 1e-5 (products of up to a few dozen
    fractional factors in another order)."""
    _, jscene, tscene, o_t, d_t = case
    packed = np.asarray(jscene.tri_accel.packed).copy()
    rng = np.random.default_rng(0)
    packed[:, 15, :] = rng.uniform(0.5, 0.95, packed[:, 15, :].shape)
    nb = int((np.asarray(jscene.tri_accel.block_bounds)[:, 0] < 1e29).sum())
    o_t, d_t = o_t[::2], d_t[::2]  # half the tiles keep the test short
    s = o_t.shape[0]
    cand = np.broadcast_to(np.arange(nb, dtype=np.int32)[None], (s, nb)).copy()
    counts = np.full((s,), nb, np.int32)
    tm = np.full(o_t.shape[:2], 30.0, np.float32)
    jargs = [jnp.asarray(x) for x in (packed, o_t, d_t, cand, counts)]
    t_j, i_j = jpk.tri_blocks_closest(*jargs, 1e-4)
    t_t, i_t = tri_blocks_closest(
        torch.from_numpy(packed), torch.from_numpy(o_t), torch.from_numpy(d_t),
        torch.from_numpy(cand), torch.from_numpy(counts), 1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-5)
    hit = np.asarray(t_j) < 1e30
    assert hit.any()
    np.testing.assert_array_equal(i_t.numpy()[hit], np.asarray(i_j)[hit])
    tr_j = jpk.tri_blocks_transmittance(*jargs[:3], jnp.asarray(tm),
                                        *jargs[3:], 1e-4)
    tr_t = tri_blocks_transmittance(
        torch.from_numpy(packed), torch.from_numpy(o_t), torch.from_numpy(d_t),
        torch.from_numpy(tm), torch.from_numpy(cand), torch.from_numpy(counts),
        1e-4)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=1e-5)
    assert (tr_t.numpy() < 1.0).any()


def test_tile_permutation_matches_reference():
    for shape in ((64, 48, 16, 16), (32, 32, 8, 16)):
        pj, ij = jpk.tile_permutation(*shape)
        pt, it = tpk.tile_permutation(*shape)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(it, ij)


PRIM_FIELDS = {"sphere": (lambda: random_sphere_field(900), "sph_accel",
                          tpk.build_sph_accel, "spheres"),
               "cyl": (lambda: random_cylinder_field(700), "cyl_accel",
                       tpk.build_cyl_accel, "cylinders")}


@pytest.fixture(scope="module", params=sorted(PRIM_FIELDS))
def prim_case(request):
    make, key, build, pool = PRIM_FIELDS[request.param]
    jscene = make().build(bvh_threshold=64)
    tscene = scene_from_numpy(numpy_tree(jscene), "cpu")
    cfg = st.RenderConfig(width=64, height=64)
    o, d = j_camera_rays(CAM_FIELD, cfg)
    perm, _ = jpk.tile_permutation(64, 64, 16, 16)
    o_t = np.asarray(o[perm], np.float32).reshape(-1, 256, 3)
    d_t = np.asarray(d[perm], np.float32).reshape(-1, 256, 3)
    return request.param, getattr(jscene, key), build, \
        getattr(tscene, pool), tscene.materials, o_t, d_t


def test_sphere_and_cylinder_accels_match_reference(prim_case):
    prim, ref, build, pool, mats, _, _ = prim_case
    accel = build(pool, mats, jpk.BLOCK)
    assert accel.block == jpk.BLOCK
    assert accel.packed.shape == ref.packed.shape
    np.testing.assert_allclose(accel.packed.numpy(), np.asarray(ref.packed),
                               rtol=1e-6)
    np.testing.assert_allclose(accel.block_bounds.numpy(),
                               np.asarray(ref.block_bounds), rtol=1e-6)
    # The pool's padding lanes never hit (radius -1) and pass light.
    n = pool.radius.shape[0]
    rows = accel.packed.numpy().transpose(1, 0, 2).reshape(16, -1)
    assert (rows[3][n:] <= 0.0).all() and (rows[3][:n] == pool.radius.numpy()).all()


def test_sphere_and_cylinder_mirrors_match_reference(prim_case):
    """tri_blocks_closest / _transmittance with prim="sphere" and "cyl"
    over every real block, fractional shadow factors."""
    prim, ref, _, _, _, o_t, d_t = prim_case
    packed = np.asarray(ref.packed).copy()
    rng = np.random.default_rng(0)
    packed[:, 15, :] = rng.uniform(0.5, 0.95, packed[:, 15, :].shape)
    nb = int((np.asarray(ref.block_bounds)[:, 0] < 1e29).sum())
    o_t, d_t = o_t[::2], d_t[::2]
    s = o_t.shape[0]
    cand = np.broadcast_to(np.arange(nb, dtype=np.int32)[None], (s, nb)).copy()
    counts = np.full((s,), nb, np.int32)
    tm = np.full(o_t.shape[:2], 30.0, np.float32)
    jargs = [jnp.asarray(x) for x in (packed, o_t, d_t, cand, counts)]
    targs = [torch.from_numpy(np.ascontiguousarray(x))
             for x in (packed, o_t, d_t, cand, counts)]
    t_j, i_j = (np.asarray(x) for x in jpk.tri_blocks_closest(
        *jargs, 1e-4, prim=prim))
    t_t, i_t = (x.numpy() for x in tri_blocks_closest(
        *targs, 1e-4, prim=prim))
    hit_j, hit_t = t_j < 1e30, t_t < 1e30
    assert hit_j.sum() > 100
    assert (hit_j == hit_t).mean() > 0.999
    both = hit_j & hit_t
    np.testing.assert_allclose(t_t[both], t_j[both], rtol=5e-4)
    np.testing.assert_array_equal(i_t[both], i_j[both])
    tr_j = jpk.tri_blocks_transmittance(*jargs[:3], jnp.asarray(tm),
                                        *jargs[3:], 1e-4, prim=prim)
    tr_t = tri_blocks_transmittance(*targs[:3], torch.from_numpy(tm),
                                    *targs[3:], 1e-4, prim=prim)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), atol=1e-6)
    assert (tr_t.numpy() < 1.0).any()
