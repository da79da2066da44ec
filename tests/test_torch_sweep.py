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

from scenes_fixtures import random_tri_field
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
