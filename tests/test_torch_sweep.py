"""The sweep kernels' plain versions against the Pallas kernels they
replace, run in interpret mode on the CPU as tests/test_pallas_kernels.py
runs them, on the same inputs: the reference's strip selection of a
random triangle field.

Tolerances: t at rtol 1e-6 and prim ids equal on hits (the reference's
CPU build contracts the Woop chains into FMAs: last-bit t differences);
visits equal (the same early-out rule); transmittance exactly equal with
the scene's 0/1 shadow factors and at rtol 1e-6 with fractional ones
(the Pallas kernel multiplies a block's factors with a halving tree, the
port in ascending lane order, ROADMAP C3).

Spheres and cylinders (``prim="sphere"``, ``"cyl"``), on the reference's
random_sphere_field(900) / random_cylinder_field(700): hit/miss agree on
more than 99.9% of the rays, t at rtol 5e-4 and prim ids equal where
both hit, visits equal, and transmittance within atol 1e-6 on more than
99.9% of the rays.  Their quadratics subtract two numbers of about
|o - c|^2 (disc = b*b - c), which the reference's CPU build contracts
into an FMA and the port does not; near tangency sqrt(disc) turns the
last bits into 1e-4 of t, and a grazing ray can flip between hit and
miss (measured: t 1.4e-4 spheres, 4.3e-4 cylinders; one cylinder ray of
4,096 flips, and its transmittance with it; both sides sit that far
from an f64 evaluation, tests/test_torch_packet.py).

The kernels themselves need the card: tests/test_torch_gpu.py holds them
to these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops import packet as jpk
from solr_tpu.ops.camera import camera_rays as j_camera_rays
from solr_tpu.ops.pallas_kernels import make_rays16t
from solr_tpu.ops.pallas_kernels import sweep_closest as p_closest
from solr_tpu.ops.pallas_kernels import sweep_transmittance as p_trans
from solr_tpu.ops.traverse import _scene_box

from scenes_fixtures import (random_cylinder_field, random_sphere_field,
                             random_tri_field)
from solr_tpu_torch.ops import sweep

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

CAM = st.Camera.create(position=(0, 0, -6.0), fov=1.0)
KS, KT = 8, 48


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@pytest.fixture(scope="module")
def setup():
    scene = random_tri_field(1200).build(bvh_threshold=64)
    accel = scene.tri_accel
    cfg = st.RenderConfig(width=64, height=64)
    o, d = j_camera_rays(CAM, cfg)
    perm, _ = jpk.tile_permutation(64, 64, 16, 16)
    o_t = o[perm].reshape(-1, 256, 3).astype(jnp.float32)
    d_t = d[perm].reshape(-1, 256, 3).astype(jnp.float32)
    live = np.ones(o_t.shape[:2], bool)
    live[2, 32:70] = False  # dead rays inside live strips
    live[3] = False  # a fully parked tile
    live = jnp.asarray(live)
    cand, counts, nearb, _ = jpk.strip_interval_select(
        o_t, d_t, live, accel, KT, KS, 1e-4)
    t_cap = jpk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    return accel, o_t, d_t, live, t_cap, cand, counts, nearb


def _closest_both(setup, nearb=None):
    accel, o_t, d_t, live, t_cap, cand, counts, nb = setup
    nb = nb if nearb is None else nearb
    rays_t = make_rays16t(o_t, d_t, tmax_t=t_cap, live_t=live)
    ref = p_closest(accel.packed, rays_t, cand, counts, nb, 1e-4,
                    interpret=True)
    port = sweep.sweep_closest(_t(accel.packed), _t(o_t), _t(d_t), _t(t_cap),
                               _t(live), _t(cand), _t(counts), _t(nb), 1e-4)
    return [np.asarray(x) for x in ref], [x.numpy() for x in port]


def test_closest_matches_pallas(setup):
    (t_j, i_j, v_j), (t_t, i_t, v_t) = _closest_both(setup)
    np.testing.assert_allclose(t_t, t_j, rtol=1e-6)
    hit = t_j < 1e30
    assert hit.sum() > 500
    np.testing.assert_array_equal(i_t[hit], i_j[hit])
    assert (i_t[~hit] == -1).all()
    np.testing.assert_array_equal(v_t, v_j)
    assert v_t[3] == 0  # the parked tile never runs


def test_closest_without_early_out_matches_pallas(setup):
    """All-zero entry bounds: nothing may be skipped; same result."""
    nearb = jnp.zeros_like(setup[-1])
    (t_j, i_j, v_j), (t_t, i_t, v_t) = _closest_both(setup, nearb)
    np.testing.assert_allclose(t_t, t_j, rtol=1e-6)
    np.testing.assert_array_equal(v_t, v_j)
    (t_e, _, v_e), _ = _closest_both(setup)
    np.testing.assert_allclose(t_t, t_e, rtol=1e-6)
    assert v_e.sum() <= v_t.sum()


def test_closest_forced_ties_match_pallas(setup):
    """Duplicated triangles inside each block (lanes [h, 2h) repeat lanes
    [0, h)) and across listed blocks (each candidate followed by a copy
    of itself): the lowest lane and the earlier block win, as in the
    Pallas kernel (ROADMAP C2)."""
    accel, o_t, d_t, live, t_cap, cand, counts, nearb = setup
    packed = np.asarray(accel.packed).copy()
    nb_, _, block = packed.shape
    h = block // 2
    packed[:, :, h:2 * h] = packed[:, :, :h]
    packed = np.concatenate([packed, packed])
    s, g, k = cand.shape
    c2 = np.stack([np.asarray(cand), np.asarray(cand) + nb_], -1)
    c2 = c2.reshape(s, g, 2 * k)[..., :k].astype(np.int32)
    nb2 = np.repeat(np.asarray(nearb), 2, axis=-1)[..., :k]
    n2 = np.minimum(np.asarray(counts) * 2, k).astype(np.int32)
    rays_t = make_rays16t(o_t, d_t, tmax_t=t_cap, live_t=live)
    t_j, i_j, v_j = (np.asarray(x) for x in p_closest(
        jnp.asarray(packed), rays_t, jnp.asarray(c2), jnp.asarray(n2),
        jnp.asarray(nb2), 1e-4, interpret=True))
    t_t, i_t, v_t = (x.numpy() for x in sweep.sweep_closest(
        _t(packed), _t(o_t), _t(d_t), _t(t_cap), _t(live), _t(c2), _t(n2),
        _t(nb2), 1e-4))
    np.testing.assert_allclose(t_t, t_j, rtol=1e-6)
    hit = t_j < 1e30
    assert hit.sum() > 300
    np.testing.assert_array_equal(i_t[hit], i_j[hit])
    assert (i_t[hit] < nb_ * block).all()  # never the later copy
    assert (i_t[hit] % block < h).any()
    np.testing.assert_array_equal(v_t, v_j)


@pytest.mark.parametrize("factors", ["scene", "fractional"])
def test_transmittance_matches_pallas(setup, factors):
    accel, o_t, d_t, live, _, _, _, _ = setup
    t_max = jnp.full(o_t.shape[:2], 50.0, jnp.float32)
    cand, counts, _, _ = jpk.strip_interval_select(
        o_t, d_t, live, accel, KT, KS, 1e-4, tm_t=t_max)
    packed = np.asarray(accel.packed).copy()
    if factors == "fractional":
        rng = np.random.default_rng(1)
        packed[:, 15, :] = rng.uniform(0.6, 0.98, packed[:, 15, :].shape)
    rays_t = make_rays16t(o_t, d_t, tmax_t=t_max, live_t=live)
    tr_j, v_j = (np.asarray(x) for x in p_trans(
        jnp.asarray(packed), rays_t, cand, counts, 1e-4, interpret=True))
    tr_t, v_t = (x.numpy() for x in sweep.sweep_transmittance(
        _t(packed), _t(o_t), _t(d_t), _t(t_max), _t(live), _t(cand),
        _t(counts), 1e-4))
    assert (tr_j < 1.0).any()
    np.testing.assert_array_equal(v_t, v_j)
    if factors == "scene":
        np.testing.assert_array_equal(tr_t, tr_j)
    else:
        assert ((tr_j > 0.0) & (tr_j < 1.0)).any()
        np.testing.assert_allclose(tr_t, tr_j, rtol=1e-6)


def test_lane_ordered_product_is_sequential():
    rng = np.random.default_rng(2)
    f = torch.from_numpy(rng.uniform(0.3, 1.0, (3, 64)).astype(np.float32))
    occ = torch.from_numpy(rng.uniform(size=(3, 5, 64)) < 0.2)
    got = sweep._lane_ordered_product(occ, f)
    for r in range(3):
        for i in range(5):
            p = torch.tensor(1.0)
            for lane in range(64):
                if occ[r, i, lane]:
                    p = p * f[r, lane]
            assert got[r, i] == p


def test_wrapper_rejects_devices_without_a_kernel(setup):
    accel, o_t, d_t, live, t_cap, cand, counts, nearb = setup
    meta = [_t(x).to("meta") for x in (accel.packed, o_t, d_t, t_cap, live,
                                      cand, counts, nearb)]
    with pytest.raises(ValueError):
        sweep.sweep_closest(*meta, 1e-4)


PRIM_FIELDS = {"sphere": (lambda: random_sphere_field(900), "sph_accel"),
               "cyl": (lambda: random_cylinder_field(700), "cyl_accel")}


@pytest.fixture(scope="module", params=sorted(PRIM_FIELDS))
def prim_setup(request):
    """The reference's strip selection of a random sphere or cylinder
    field, as TestSphereSweep / TestCylinderSweep make it."""
    make, key = PRIM_FIELDS[request.param]
    accel = getattr(make().build(bvh_threshold=64), key)
    cfg = st.RenderConfig(width=64, height=64)
    o, d = j_camera_rays(CAM, cfg)
    perm, _ = jpk.tile_permutation(64, 64, 16, 16)
    o_t = o[perm].reshape(-1, 256, 3).astype(jnp.float32)
    d_t = d[perm].reshape(-1, 256, 3).astype(jnp.float32)
    live = np.ones(o_t.shape[:2], bool)
    live[2, 32:70] = False
    live = jnp.asarray(live)
    return request.param, accel, o_t, d_t, live


def test_prim_closest_matches_pallas(prim_setup):
    prim, accel, o_t, d_t, live = prim_setup
    cand, counts, nearb, _ = jpk.strip_interval_select(
        o_t, d_t, live, accel, KT, KS, 1e-4)
    t_cap = jpk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    rays_t = make_rays16t(o_t, d_t, tmax_t=t_cap, live_t=live)
    t_j, i_j, v_j = (np.asarray(x) for x in p_closest(
        accel.packed, rays_t, cand, counts, nearb, 1e-4, interpret=True,
        prim=prim))
    t_t, i_t, v_t = (x.numpy() for x in sweep.sweep_closest(
        _t(accel.packed), _t(o_t), _t(d_t), _t(t_cap), _t(live), _t(cand),
        _t(counts), _t(nearb), 1e-4, prim=prim))
    hit_j, hit_t = t_j < 1e30, t_t < 1e30
    assert hit_j.sum() > 300
    assert (hit_j == hit_t).mean() > 0.999
    both = hit_j & hit_t
    np.testing.assert_allclose(t_t[both], t_j[both], rtol=5e-4)
    np.testing.assert_array_equal(i_t[both], i_j[both])
    assert (i_t[~hit_t] == -1).all()
    np.testing.assert_array_equal(v_t, v_j)


@pytest.mark.parametrize("factors", ["scene", "fractional"])
def test_prim_transmittance_matches_pallas(prim_setup, factors):
    prim, accel, o_t, d_t, live = prim_setup
    t_max = jnp.full(o_t.shape[:2], 40.0, jnp.float32)
    cand, counts, _, _ = jpk.strip_interval_select(
        o_t, d_t, live, accel, KT, KS, 1e-4, tm_t=t_max)
    packed = np.asarray(accel.packed).copy()
    if factors == "fractional":
        rng = np.random.default_rng(1)
        packed[:, 15, :] = rng.uniform(0.6, 0.98, packed[:, 15, :].shape)
    rays_t = make_rays16t(o_t, d_t, tmax_t=t_max, live_t=live)
    tr_j, v_j = (np.asarray(x) for x in p_trans(
        jnp.asarray(packed), rays_t, cand, counts, 1e-4, interpret=True,
        prim=prim))
    tr_t, v_t = (x.numpy() for x in sweep.sweep_transmittance(
        _t(packed), _t(o_t), _t(d_t), _t(t_max), _t(live), _t(cand),
        _t(counts), 1e-4, prim=prim))
    assert (tr_j < 1.0).any()
    np.testing.assert_array_equal(v_t, v_j)
    assert (np.abs(tr_t - tr_j) <= 1e-6).mean() > 0.999
