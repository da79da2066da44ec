"""The camera modes, the thin lens and antialiasing jitter of the port
against solr_tpu on the CPU, and the port's random keys.

The reference draws from ``jax.random`` keys; the port, handed a
``JaxKey`` (tests/torch_rng_helpers.py) that wraps the same key, makes
the same draws, so the rays can be compared one by one.

Tolerances: origins and directions at rtol 1e-6 and, for components
near zero, atol 2.5e-7 (two float32 ulps at 1: sin, cos and atan2 of
the fisheye and the lens round differently in the two libraries, by up
to 1.9e-7 on a component of 0.09; the rest is the same arithmetic).
The f64 camera over an f32 pixel grid is held to the same tolerance.  The port's own ``Key``: equal draws from equal keys (and folds),
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops import camera as jcam

from data.torch_reference import numpy_tree
from solr_tpu_torch.convert import camera_from_numpy, config_from_reference_fields
from solr_tpu_torch.ops import camera as tcam
from solr_tpu_torch.ops.rng import Key
from torch_rng_helpers import JaxKey

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 2.5e-7
MODES = ("MONO", "SIDE_BY_SIDE", "ANAGLYPH", "FISHEYE")
# (antialias_jitter, aperture, key)
VARIANTS = {"pinhole": (False, 0.0, False), "keyed-pinhole": (False, 0.0, True),
            "jitter": (True, 0.0, True), "lens": (False, 0.25, True),
            "jitter-lens": (True, 0.25, True)}


def _camera(aperture, dtype=np.float32):
    jc = st.Camera.create(position=(0.3, 1.0, -4.0), angles=(0.2, -0.15, 0.05),
                          fov=0.9, aperture=aperture, focal_distance=3.5,
                          eye_separation=0.2)
    if dtype == np.float64:
        jc = jax.tree.map(lambda x: x.astype(jnp.float64), jc)
    tc = camera_from_numpy(numpy_tree(jc), "cpu",
                           torch.float64 if dtype == np.float64 else torch.float32)
    return jc, tc


def _cfg(mode, jitter, width=24, height=16):
    jcfg = st.RenderConfig(width=width, height=height,
                           camera_mode=st.CameraMode[mode],
                           antialias_jitter=jitter)
    return jcfg, config_from_reference_fields(dataclasses.asdict(jcfg))


def _close(port, ref):
    for p, r in zip(port, ref):
        r = np.asarray(r)
        assert p.dtype == torch.from_numpy(r).dtype
        np.testing.assert_allclose(p.numpy(), r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mode", MODES)
def test_camera_rays_match_reference(mode, variant):
    jitter, aperture, keyed = VARIANTS[variant]
    jc, tc = _camera(aperture)
    jcfg, cfg = _cfg(mode, jitter)
    key = jax.random.PRNGKey(7) if keyed else None
    ref = jcam.camera_rays(jc, jcfg, key)
    port = tcam.camera_rays(tc, cfg, JaxKey(key) if keyed else None)
    _close(port, ref)


@pytest.mark.parametrize("mode", MODES)
def test_rays_from_pixels_subset(mode):
    """A scattered pixel subset, as one device of a sharded render
    passes it, with jitter and a lens."""
    jc, tc = _camera(0.25)
    jcfg, cfg = _cfg(mode, True, 40, 30)
    rng = np.random.default_rng(3)
    pix = np.stack([rng.integers(0, 40, 200), rng.integers(0, 30, 200)],
                   -1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = jcam.rays_from_pixels(jc, jcfg, jnp.asarray(pix), key)
    port = tcam.rays_from_pixels(tc, cfg, torch.as_tensor(pix), JaxKey(key))
    _close(port, ref)


@pytest.mark.parametrize("keyed", [False, True], ids=["no-key", "key"])
@pytest.mark.parametrize("eye", [-1.0, 1.0])
def test_eye_rays_match_reference(eye, keyed):
    jc, tc = _camera(0.25)
    jcfg, cfg = _cfg("ANAGLYPH", True)
    key = jax.random.PRNGKey(5) if keyed else None
    ref = jcam.eye_rays(jc, jcfg, eye, key, jnp.float32)
    port = tcam.eye_rays(tc, cfg, eye, JaxKey(key) if keyed else None,
                         torch.float32)
    _close(port, ref)


@pytest.mark.parametrize("mode", MODES)
def test_f64_camera_over_f32_grid(mode):
    """An f64 camera with the pixel grid, jitter and lens draws in f32
    (the reference's SceneBuilder(dtype=float64) keeps f32 scene info):
    the rays come out f64, widened where the reference widens them."""
    jc, tc = _camera(0.25, np.float64)
    jcfg, cfg = _cfg(mode, True)
    key = jax.random.PRNGKey(2)
    ref = jcam.camera_rays(jc, jcfg, key, jnp.float32)
    port = tcam.camera_rays(tc, cfg, JaxKey(key), torch.float32)
    assert port[1].dtype == torch.float64
    _close(port, ref)


def test_side_by_side_halves_use_different_eyes():
    _, tc = _camera(0.0)
    _, cfg = _cfg("SIDE_BY_SIDE", False)
    o, _ = tcam.camera_rays(tc, cfg)
    o = o.reshape(cfg.height, cfg.width, 3)
    left, right = o[:, : cfg.width // 2], o[:, cfg.width // 2:]
    sep = float(tc.eye_separation)
    assert torch.allclose((right - left).norm(dim=-1),
                          torch.full(left.shape[:2], 2 * sep), atol=1e-6)


def test_key_is_a_value():
    """Drawing and splitting leave a key as it was: equal keys give equal
    draws and children; children differ from each other and from the
    parent."""
    k = Key.seed(3, "cpu")
    a = k.uniform((5, 2))
    assert torch.equal(a, k.uniform((5, 2)))
    assert torch.equal(k.normal((7,), torch.float64),
                       Key.seed(3, "cpu").normal((7,), torch.float64))
    c1, c2 = k.split(2)
    assert [c.state for c in k.split(2)] == [c1.state, c2.state]
    assert len({k.state, c1.state, c2.state}) == 3
    assert not torch.equal(c1.uniform((5, 2)), c2.uniform((5, 2)))
    assert k.split(3)[:2][0].state == c1.state
    assert a.dtype == torch.float32 and (a >= 0).all() and (a < 1).all()


def test_fold_in_is_a_value():
    """fold_in(i) (the per-rank key of a sharded render): the same
    (key, i) gives the same key and draws, other i and the split
    children other keys."""
    k = Key.seed(3, "cpu")
    f = k.fold_in(2)
    assert f.state == Key.seed(3, "cpu").fold_in(2).state
    assert torch.equal(f.uniform((5, 2)), k.fold_in(2).uniform((5, 2)))
    folds = [k.fold_in(i) for i in range(8)]
    states = {x.state for x in folds} | {c.state for c in k.split(8)}
    assert len(states | {k.state}) == 17
    assert not torch.equal(folds[0].uniform((5, 2)), folds[1].uniform((5, 2)))
    assert f.device == k.device


@pytest.mark.parametrize("i", [0, 1, 7])
def test_jaxkey_fold_in_matches_jax(i):
    key = jax.random.PRNGKey(11)
    want = jax.random.uniform(jax.random.fold_in(key, i), (4, 3), jnp.float32)
    got = JaxKey(key).fold_in(i).uniform((4, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(JaxKey(key).fold_in(i + 1).uniform((4, 3)),
                              got.numpy())


def test_key_defaults_to_the_card():
    assert Key.seed(0).device.type == "cuda"
    assert Key.seed(0, "cpu").split(2)[1].device.type == "cpu"
