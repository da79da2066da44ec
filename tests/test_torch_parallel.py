"""``solr_tpu_torch.parallel`` (ROADMAP A15) on gloo ranks with CPU
tensors, each scenario of tests/test_parallel.py held to ``solr_tpu``
on its 8-virtual-device mesh.

One spawned group per world size (4 and 2) runs every scenario
(tests/torch_parallel_helpers.py ``cpu_scenarios``) while this process
computes the references; the cases below read its results.  Which
reference each scenario is held to, and how closely:

* frames: the port's sharded frame against the port's one-process
  ``render_sample``, atol 1e-6 (depth 1e-4), test_parallel.py's own
  tolerance; and against ``solr_tpu.parallel.shard_render`` on 8
  devices under ``jax.jit``, atol 1e-4 outside 0.2% of pixels (f32 edge
  flips where XLA contracts into FMAs, ROADMAP C1);
* keyed SIDE_BY_SIDE and ANAGLYPH frames (jitter, a lens, soft
  shadows), drawn through ``JaxKey.fold_in`` per rank on four ranks:
  against ``solr_tpu.parallel.shard_render`` with the same key on four
  devices (a keyed frame depends on the band count), as above;
* gradients, on the f64 Cornell scene: the port's sharded loss and
  gradients (psum and reduce_scatter, 1-D and host-chip meshes) against
  the reference's eager single-device ``jax.value_and_grad``
  (``reference_grads``; under shard_map and jit XLA rewrites the pixel
  grid's arithmetic, C10), every leaf within 1e-6 of its largest entry,
  the loss rtol 1e-6; and against the port's own one-process gradients
  at test_parallel.py's rtol 1e-4, atol 1e-6;
* psum against reduce_scatter, host-chip against 1-D: rtol 1e-5, atol
  1e-7; ZeRO-1 against psum over three Adam steps: rtol 1e-4, atol
  1e-6; the albedo-only train step halves the loss in 41 steps (all as
  test_parallel.py);
* the ring: hit ids equal to the brute-force sweep of both packages and
  to ``solr_tpu``'s ring, t rtol 1e-6 on hits.

The groups use gloo on the CPU, one thread per rank, a deadline on
every collective and on the group.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops import intersect as j_isect
from solr_tpu.ops.render import render_sample as j_render
from solr_tpu.parallel import make_mesh as j_make_mesh
from solr_tpu.parallel import ring_closest_hit as j_ring
from solr_tpu.parallel import shard_render as j_shard_render
from solr_tpu.parallel.grads import flatten_params as j_flatten_params

from data.torch_reference import numpy_tree, reference_grads
from scenes_fixtures import cornell_box, cornell_camera, random_tri_field
from solr_tpu_torch.convert import (camera_from_numpy,
                                    config_from_reference_fields,
                                    scene_from_numpy)
from solr_tpu_torch.ops import intersect
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.parallel import (initialize_distributed, process_info,
                                     sharded_loss_grad)
from solr_tpu_torch.parallel.grads import flatten_params, unflatten_params
from solr_tpu_torch.parallel.launch import spawn_group
from torch_parallel_helpers import cpu_scenarios

torch.set_num_threads(2)

CFG = st.RenderConfig(width=32, height=32, max_bounces=2)
KEYED = dict(antialias_jitter=True, shadow_samples=2)
KEY_SEED = 7
GROUP_DEADLINE_S = 240.0
ATOL, BUDGET = 1e-4, 0.002
WORLDS = (4, 2)


def _cfg(**kw):
    return config_from_reference_fields(dataclasses.asdict(
        dataclasses.replace(CFG, **kw)))


def _rays(n=512):
    rng = np.random.default_rng(0)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    o[:, 2] = -20.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) * 6 + 2
    return {"o": o, "d": d / np.linalg.norm(d, axis=-1, keepdims=True)}


@pytest.fixture(scope="module")
def jax_cases():
    """The reference's scenes and cameras."""
    scene = cornell_box(n_spheres=4).build()
    cam = cornell_camera()
    scene64 = cornell_box(n_spheres=4, dtype=np.float64).build()
    cam64 = st.Camera.create(position=(0.0, 0.0, -1.6), fov=1.1,
                             dtype=jnp.float64)
    lens = st.Camera.create(position=(0.0, 0.0, -1.6), fov=1.1,
                            aperture=0.05, focal_distance=2.0)
    tri = random_tri_field(500).build(bvh_threshold=10**9)
    return dict(scene=scene, cam=cam, scene64=scene64, cam64=cam64,
                lens=lens, tri=tri, rays=_rays())


@pytest.fixture(scope="module")
def cases(jax_cases):
    """The same, flattened to numpy for the ranks."""
    j = jax_cases
    img, _ = j_render(j["scene"], j["cam"], CFG)
    img64, _ = j_render(j["scene64"], j["cam64"], CFG)
    return {
        "cornell": {"scene": numpy_tree(j["scene"]),
                    "camera": numpy_tree(j["cam"])},
        # f64 leaves, f32 info, as SceneBuilder(dtype=float64) leaves it.
        "cornell64": {"scene": numpy_tree(j["scene64"]),
                      "camera": numpy_tree(j["cam64"]),
                      "info_dtype": torch.float32},
        "lens_camera": numpy_tree(j["lens"]),
        "cfg": _cfg(),
        "odd_cfg": _cfg(width=33, height=31),
        "side_by_side_cfg": _cfg(camera_mode=st.types.CameraMode.SIDE_BY_SIDE,
                                 **KEYED),
        "anaglyph_cfg": _cfg(camera_mode=st.types.CameraMode.ANAGLYPH,
                             **KEYED),
        "key_seed": KEY_SEED,
        "target": np.asarray(img[..., :3]) * 0.7,
        "target64": np.asarray(img64[..., :3]) * 0.7,
        "tri_field": numpy_tree(j["tri"]),
        "rays": j["rays"],
    }


@pytest.fixture(scope="module")
def started(cases):
    """Both groups, started before the references are computed so that
    the two overlap."""
    groups = {w: spawn_group(cpu_scenarios, w, (cases,), device="cpu",
                             timeout_s=GROUP_DEADLINE_S) for w in WORLDS}
    yield groups
    for g in groups.values():  # a group never joined is killed
        g.close()


@pytest.fixture(scope="module")
def reference(jax_cases, cases):
    """solr_tpu's sharded frames, ring and eager gradients."""
    j = jax_cases
    mesh = j_make_mesh(8)
    frame = jax.jit(lambda s, c: j_shard_render(s, c, CFG, mesh))
    out = {"frame": np.asarray(frame(j["scene"], j["cam"])[0])}
    # A keyed frame depends on the number of bands (each folds in its
    # index): the reference's takes four devices, as the port's ranks.
    mesh4 = j_make_mesh(4)
    key = jax.random.PRNGKey(KEY_SEED)
    for name, mode in (("side_by_side", st.types.CameraMode.SIDE_BY_SIDE),
                       ("anaglyph", st.types.CameraMode.ANAGLYPH)):
        cfg = dataclasses.replace(CFG, camera_mode=mode, **KEYED)
        out[f"keyed_{name}"] = np.asarray(jax.jit(
            lambda s, c, k, cfg=cfg: j_shard_render(s, c, cfg, mesh4, k))(
                j["scene"], j["lens"], key)[0])
    o, d = (jnp.asarray(j["rays"][k]) for k in ("o", "d"))
    t, i = jax.jit(lambda o, d: j_ring(j["tri"], o, d, mesh))(o, d)
    tri = j["tri"].triangles
    tm = j_isect.triangle_t(o, d, tri.v0, tri.v1, tri.v2, 1e-4)
    out["ring"] = (np.asarray(t), np.asarray(i))
    out["brute"] = (np.asarray(tm.min(-1)), np.asarray(jnp.argmin(tm, -1)))
    loss, grads = reference_grads(j["scene64"], j["cam64"], CFG,
                                  j["scene64"].params,
                                  jnp.asarray(cases["target64"]))
    out["grads"] = (float(loss), jax.tree.map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def ranks(started, reference):
    """Each world's per-rank results."""
    return {w: g.join() for w, g in started.items()}


@pytest.fixture(scope="module")
def single(cases):
    """The port in this one process: the frame, and the loss and
    gradients with no process group (the one-process mesh)."""
    c = cases["cornell"]
    scene = scene_from_numpy(c["scene"], "cpu")
    cam = camera_from_numpy(c["camera"], "cpu")
    c64 = cases["cornell64"]
    s64 = scene_from_numpy(c64["scene"], "cpu", torch.float64).replace(
        info=scene_from_numpy(c64["scene"], "cpu").info)
    cam64 = camera_from_numpy(c64["camera"], "cpu", torch.float64)
    img, depth = render_sample(scene, cam, cases["cfg"])
    loss, grads = sharded_loss_grad(s64, cam64, cases["cfg"],
                                    torch.as_tensor(cases["target64"]))
    return dict(scene=scene, s64=s64, img=img.numpy(), depth=depth.numpy(),
                loss=float(loss), grads=_np(grads))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_np(v) for v in tree)
    return np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                      else tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], k)]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}[{i}]")]
    return [(prefix, np.asarray(tree, np.float64))]


def assert_frame_close(img, ref):
    err = np.abs(np.asarray(img) - np.asarray(ref)).max(-1)
    assert np.isfinite(img).all()
    frac = float((err > ATOL).mean())
    assert frac <= BUDGET, f"{frac:.4f} of pixels past {ATOL} (max {err.max()})"


def assert_grads_close(got, want, tol):
    """Every leaf within ``tol`` of its largest reference entry."""
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        scale = np.abs(b).max() if b.size else 0.0
        err = np.abs(a - b).max() if b.size else 0.0
        assert err <= tol * scale, f"{name}: {err:.3e} > {tol} x {scale:.3e}"


def assert_trees_allclose(got, want, rtol, atol):
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


# --------------------------------------------------------------------------
# Frames (TestShardRender, TestHostChipMesh.test_render_matches_single_device)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_shard_render_matches_single_device(ranks, single, reference, world):
    for img, depth in (r["render"] for r in ranks[world]):
        np.testing.assert_allclose(img, single["img"], atol=1e-6)
        np.testing.assert_allclose(depth, single["depth"], atol=1e-4)
        assert_frame_close(img, reference["frame"])


def test_uneven_mesh_of_two_ranks_in_four(ranks, single):
    """make_mesh(2) in a job of four (the reference's make_mesh(4) of
    eight devices): ranks 0 and 1 render, 2 and 3 are outside it."""
    res = [r["render_sub"] for r in ranks[4]]
    assert res[2] is None and res[3] is None
    for img, _ in res[:2]:
        np.testing.assert_allclose(img, single["img"], atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_indivisible_raises_on_every_rank(ranks, world):
    for r in ranks[world]:
        assert "not divisible" in r["indivisible"]


def test_host_chip_mesh_render(ranks, single, reference):
    for r in ranks[4]:
        assert r["host_chip_axes"] == ("host", "chip")
        img, _ = r["host_chip_render"]
        np.testing.assert_allclose(img, single["img"], atol=1e-6)
        assert_frame_close(img, reference["frame"])


@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_scene(ranks, world):
    assert all(r["broadcast_equal"] for r in ranks[world])


@pytest.mark.parametrize("name", ["side_by_side", "anaglyph"])
def test_keyed_frames_match_reference(ranks, reference, name):
    """Rank i folds i into the key (JaxKey.fold_in replays
    jax.random.fold_in), so the keyed frame is solr_tpu's."""
    frames = [r[f"keyed_{name}"][0] for r in ranks[4]]
    for img in frames[1:]:
        np.testing.assert_array_equal(img, frames[0])
    assert_frame_close(frames[0], reference[f"keyed_{name}"])
    unkeyed = reference["frame"]
    assert np.abs(frames[0] - unkeyed).max() > 1e-3  # the key was used


# --------------------------------------------------------------------------
# Gradients (TestShardedGrads, TestHostChipMesh, TestReduceScatter)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("world,mode", [(4, "psum"), (4, "reduce_scatter"),
                                        (2, "psum"), (2, "reduce_scatter")])
def test_sharded_grads_match_reference(ranks, single, reference, world,
                                       mode):
    l_ref, g_ref = reference["grads"]
    for r in ranks[world]:
        loss, grads = r[f"grads_{mode}"]
        np.testing.assert_allclose(loss, l_ref, rtol=1e-6)
        assert_grads_close(grads, g_ref, 1e-6)
        np.testing.assert_allclose(loss, single["loss"], rtol=1e-5)
        assert_trees_allclose(grads, single["grads"], 1e-4, 1e-6)


def test_host_chip_grads_match_1d(ranks, reference):
    for r in ranks[4]:
        loss_hc, g_hc = r["host_chip_grads"]
        loss_1d, g_1d = r["grads_psum"]
        np.testing.assert_allclose(loss_hc, loss_1d, rtol=1e-6)
        assert_trees_allclose(g_hc, g_1d, 1e-5, 1e-7)
        assert_grads_close(g_hc, reference["grads"][1], 1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_scatter_matches_psum(ranks, world):
    for r in ranks[world]:
        assert_trees_allclose(r["grads_reduce_scatter"][1],
                              r["grads_psum"][1], 1e-5, 1e-7)


def test_zero_train_step_matches_psum(ranks):
    for r in ranks[4]:
        (l_a, p_a), (l_b, p_b) = (r["zero"][m]
                                  for m in ("psum", "reduce_scatter"))
        np.testing.assert_allclose(l_a[-1], l_b[-1], rtol=1e-5)
        assert all(np.isfinite(l_a + l_b))
        assert_trees_allclose(p_a, p_b, 1e-4, 1e-6)


def test_train_step_reduces_loss(ranks):
    l0, l1 = ranks[4][0]["train"]
    assert l1 < 0.5 * l0
    assert all(r["train"] == (l0, l1) for r in ranks[4])


def test_flatten_params_matches_reference(jax_cases, single):
    """The flat vector, leaf order and padding are the reference's, so
    the ZeRO shards hold the same parameters."""
    for n in (1, 3, 8):
        j_flat, _ = j_flatten_params(jax_cases["scene"].params, n)
        flat, spec = flatten_params(single["scene"].params, n)
        np.testing.assert_array_equal(flat.numpy(), np.asarray(j_flat))
        back = unflatten_params(flat, spec)
        assert_trees_allclose(_np(back), _np(single["scene"].params), 0, 0)


# --------------------------------------------------------------------------
# TestDistributedEntry, TestRingMode
# --------------------------------------------------------------------------


def test_single_process_noop(monkeypatch):
    for name in ("SOLR_COORDINATOR", "SOLR_NUM_PROCESSES", "SOLR_PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    info = initialize_distributed()
    assert info["process_count"] == 1
    assert info == process_info()
    assert not torch.distributed.is_initialized()


def test_ring_matches_brute_force(ranks, jax_cases, reference):
    tri = scene_from_numpy(numpy_tree(jax_cases["tri"]), "cpu").triangles
    o, d = (torch.as_tensor(jax_cases["rays"][k]) for k in ("o", "d"))
    tm = intersect.triangle_t(o, d, tri.v0, tri.v1, tri.v2, 1e-4)
    t_port, i_port = tm.min(-1)
    t_ref, i_ref = reference["brute"]
    hit = t_ref < 1e30
    assert hit.sum() > 20
    np.testing.assert_array_equal(i_port.numpy()[hit], i_ref[hit])
    for t, i in (r["ring"] for r in ranks[4]):
        np.testing.assert_array_equal(i[hit], i_ref[hit])
        np.testing.assert_array_equal(i[hit], reference["ring"][1][hit])
        np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-6)
        assert (i[~hit] == -1).all()
