"""The CUDA sweep kernels, emulated on the CPU (tests/torch_sweep_helpers.py:
csrc/sweep.cu built by the host's C++ compiler, one thread per CUDA
thread, real barriers), against their plain PyTorch versions: t, idx,
tr and visits bit-equal, as on the card.  The emulation compiles without
FMA contraction, as nvcc does with --fmad=false, and runs the kernels'
own control flow: the staged kernels' lane slices and their combine
(B1-B6) at a BLOCK that their slices of 2 or 4 lanes do not divide,
with forced ties, empty and K-long lists, fractional factors, padding
spheres, rays that start inside spheres, and their launch order, the
strips with the longest lists first, which an order kernel computes.

The card's own runs are tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.constants import RAY_EPS
from solr_tpu_torch.kernel_shapes import fractional, primary_tiles
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import packet as pk
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.ops.traverse import _scene_box
from torch_sweep_helpers import build_emulated, compiler, forced_ties

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

TILES = 2  # 16 strips: 16 emulated CTAs per launch
SPHERE_ATOMS = 600
# The sphere cases' list length: forced ties give every strip of tile 1
# a list this long, and 16 blocks keep those cases quick.
SPHERE_K = 16


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a C++17 compiler to build the emulation")
    return sweep.load_library(build_emulated(sweep._SRC,
                                             tmp_path_factory.mktemp("emu")))


def _no_stream(monkeypatch):
    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())


def _run(monkeypatch, lib, launch, args, prim):
    _no_stream(monkeypatch)
    return launch(lib, *args, prim=prim)


def _rays(cam, cfg, accel):
    """The frame's TILES tiles with the longest strip lists over
    ``accel``, a few dead rays in one strip."""
    o_t, d_t, live = primary_tiles(cam, cfg)
    _, counts, _, _ = pk.strip_interval_select(o_t, d_t, live, accel, 256,
                                               64, RAY_EPS)
    busy = torch.argsort(counts.sum(1), descending=True, stable=True)[:TILES]
    o_t, d_t, live = o_t[busy], d_t[busy], live[busy]
    live[1, 32:70] = False
    return o_t.contiguous(), d_t.contiguous(), live.contiguous()


@pytest.mark.parametrize("block,ties", [(64, False), (64, True),
                                        (200, False), (200, True)])
def test_emulated_closest_tri(emulated, monkeypatch, block, ties):
    """B1 (closest_staged, 8 slices) on a triangle field."""
    scene, cam, cfg = bench_scene(4_000, block=block, width=64, height=64,
                                  device="cpu")
    accel = scene.tri_accel
    o_t, d_t, live = _rays(cam, cfg, accel)
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS)
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    packed = accel.packed
    if ties:
        packed, cand, counts, nearb = forced_ties(packed, cand, counts, nearb)
    args = (packed, o_t, d_t, t_cap, live, cand, counts, nearb, RAY_EPS)
    got = _run(monkeypatch, emulated, sweep.launch_closest, args, "tri")
    want = sweep.sweep_closest_plain(*args, prim="tri")
    assert (want[0] < 1e30).sum() > 100 and int(want[2].sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _selection(accel, cam, cfg, closest, t_max=None, k=64):
    """A selection over ``accel`` of the TILES busiest tiles, as the
    kernels take it, with lists of up to ``k`` blocks: (o_t, d_t, t_cap
    or t_max, live, cand, counts and, for closest hits, nearb).  Shadow
    rays run from the camera to ``t_max``."""
    o_t, d_t, live = _rays(cam, cfg, accel)
    if closest:
        cand, counts, nearb, _ = pk.strip_interval_select(
            o_t, d_t, live, accel, 256, k, RAY_EPS)
        t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
        return o_t, d_t, t_cap, live, cand, counts, nearb
    tm = torch.full(o_t.shape[:2], t_max)
    cand, counts, _, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, k, RAY_EPS, tm_t=tm)
    return o_t, d_t, tm, live, cand, counts


def _trans_equal(monkeypatch, emulated, accel, sel, factors, ties, prim):
    o_t, d_t, tm, live, cand, counts = sel
    packed = fractional(accel.packed) if factors == "fractional" \
        else accel.packed
    if ties:
        packed, cand, counts = forced_ties(packed, cand, counts)
    args = (packed, o_t, d_t, tm, live, cand, counts, RAY_EPS)
    got = _run(monkeypatch, emulated, sweep.launch_transmittance, args, prim)
    want = sweep.sweep_transmittance_plain(*args, prim=prim)
    assert (want[0] < 1.0).any() and (want[0] > 0.0).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("block,factors,ties", [
    (64, "scene", True), (64, "fractional", False),
    (200, "scene", False), (200, "fractional", True)])
def test_emulated_transmittance_cyl(emulated, monkeypatch, block, factors,
                                    ties):
    """B6 (trans_staged, 4 slices) on a small molecule's cylinders."""
    scene, cam, cfg = molecule_scene(400, 16, width=64, height=64,
                                     block=block, device="cpu")
    accel = scene.cyl_accel
    _trans_equal(monkeypatch, emulated, accel,
                 _selection(accel, cam, cfg, False, 8.0), factors, ties,
                 "cyl")


@pytest.mark.parametrize("block,factors,ties", [
    (64, "scene", True), (64, "fractional", False),
    (200, "scene", False), (200, "fractional", True)])
def test_emulated_transmittance_tri(emulated, monkeypatch, block, factors,
                                    ties):
    """B2 (trans_staged on Woop rows) on a triangle field."""
    scene, cam, cfg = bench_scene(4_000, block=block, width=64, height=64,
                                  device="cpu")
    accel = scene.tri_accel
    _trans_equal(monkeypatch, emulated, accel,
                 _selection(accel, cam, cfg, False, 50.0), factors, ties,
                 "tri")


def _closest_equal(monkeypatch, emulated, accel, sel, ties, prim):
    """Kernel against plain version on a closest-hit selection; with
    ``ties``, forced ties whose lists are longest in tile 1 and empty for
    strip 0, so the launch order is not the strips' id order.  Returns
    the plain version's (t, idx, visits)."""
    o_t, d_t, t_cap, live, cand, counts, nearb = sel
    packed = accel.packed
    if ties:
        packed, cand, counts, nearb = forced_ties(packed, cand, counts, nearb)
        order = sweep.longest_first(counts)
        assert not torch.equal(order, torch.sort(order).values)
    args = (packed, o_t, d_t, t_cap, live, cand, counts, nearb, RAY_EPS)
    got = _run(monkeypatch, emulated, sweep.launch_closest, args, prim)
    want = sweep.sweep_closest_plain(*args, prim=prim)
    assert (want[0] < 1e30).sum() > 100 and int(want[2].sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if ties:  # the earlier copy of a block wins every tie
        hit = want[1] >= 0
        assert hit.any() and (want[1][hit] < accel.packed.numel() // 16).all()
    return want


@pytest.mark.parametrize("block,ties", [(64, False), (64, True),
                                        (200, False), (200, True)])
def test_emulated_closest_cyl(emulated, monkeypatch, block, ties):
    """B5 (closest_staged on cylinders) on a small molecule's cylinders."""
    scene, cam, cfg = molecule_scene(400, 16, width=64, height=64,
                                     block=block, device="cpu")
    accel = scene.cyl_accel
    _closest_equal(monkeypatch, emulated, accel,
                   _selection(accel, cam, cfg, True), ties, "cyl")


@pytest.mark.parametrize("block,ties", [(64, False), (64, True),
                                        (200, False), (200, True)])
def test_emulated_closest_sphere(emulated, monkeypatch, block, ties):
    """B3 (closest_staged on spheres) on a small molecule's atoms; the
    last block ends in padding spheres (radius -1 at the origin), which
    the forced ties' K-long lists visit.  600 atoms: at 400, the rays of
    the busiest tiles hit only lanes that BLOCK=200's ties overwrite."""
    scene, cam, cfg = molecule_scene(SPHERE_ATOMS, 16, width=64, height=64,
                                     block=block, device="cpu")
    accel = scene.sph_accel
    _closest_equal(monkeypatch, emulated, accel,
                   _selection(accel, cam, cfg, True, k=SPHERE_K), ties,
                   "sphere")


def test_emulated_closest_sphere_inside(emulated, monkeypatch):
    """B3 on rays that start inside spheres: strip 1 of tile 0 starts on
    the centres of 32 atoms, so each of its rays meets its own atom with
    lo <= t_min < hi and must take the exit root."""
    scene, cam, cfg = molecule_scene(SPHERE_ATOMS, 16, width=64, height=64,
                                     block=64, device="cpu")
    accel = scene.sph_accel
    o_t, d_t, live = _rays(cam, cfg, accel)
    rows = accel.packed.permute(0, 2, 1).reshape(-1, 16)
    atoms = rows[rows[:, 3] > 0][:32]
    o_t[0, 32:64] = atoms[:, :3]
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS)
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    t, _, _ = _closest_equal(
        monkeypatch, emulated, accel,
        (o_t, d_t, t_cap, live, cand, counts, nearb), False, "sphere")
    assert (t[0, 32:64] <= atoms[:, 3] * (1 + 1e-6)).all()


@pytest.mark.parametrize("block,factors,ties", [
    (64, "scene", True), (64, "fractional", False),
    (200, "scene", False), (200, "fractional", True)])
def test_emulated_transmittance_sphere(emulated, monkeypatch, block, factors,
                                       ties):
    """B4 (trans_staged on spheres) on a small molecule's atoms, padding
    spheres as for B3."""
    scene, cam, cfg = molecule_scene(SPHERE_ATOMS, 16, width=64, height=64,
                                     block=block, device="cpu")
    accel = scene.sph_accel
    _trans_equal(monkeypatch, emulated, accel,
                 _selection(accel, cam, cfg, False, 8.0, SPHERE_K), factors,
                 ties, "sphere")


@pytest.mark.parametrize("n,k_max", [(16, 64), (1000, 64), (2077, 5)])
def test_emulated_launch_order(emulated, monkeypatch, n, k_max):
    """The order kernel, which every staged launch runs first, against
    its plain version (a stable descending sort): random lengths with a
    run of empty lists and a run of full ones, over warp ranges that 32
    does not divide; a k_max whose counters exceed shared memory
    raises."""
    gen = np.random.default_rng(n)
    counts = torch.from_numpy(
        gen.integers(0, k_max + 1, size=n).astype(np.int32))
    counts[n // 5: n // 3] = 0
    counts[n // 2: n // 2 + 40] = k_max
    counts = counts.reshape(-1, 8) if n % 8 == 0 else counts
    _no_stream(monkeypatch)
    got = sweep.launch_order(emulated, counts, k_max)
    assert torch.equal(got, sweep.longest_first(counts))
    with pytest.raises(RuntimeError, match="launch order"):
        sweep.launch_order(emulated, counts, 4000)


def test_emulated_kernel_shapes(emulated):
    """Every entry runs a staged kernel for every primitive kind; the
    staged rows of every BLOCK the frames use fit the card's shared
    memory per CTA, and B2's at the bench's BLOCK=512, the largest of
    them, leave room for 4 CTAs in an SM's 228 KB (1 KB reserved per
    CTA).  B3 and B4 stage 4 rows, and 5 with the factor."""
    limit = emulated.solr_sweep_smem_limit()
    for entry in ("sweep_closest", "sweep_transmittance"):
        for prim in sweep.PRIMS:
            for block in (64, 200, 256, 512):
                shape = sweep.kernel_shape(entry, prim, block, emulated)
                assert shape["design"] == "staged"
                assert shape["warps_per_cta"] in (2, 4, 6, 8)
                assert 0 < shape["smem_bytes"] <= limit
    b2 = sweep.kernel_shape("sweep_transmittance", "tri", 512, emulated)
    assert b2["smem_bytes"] == 2 * 13 * 512 * 4 + 2048
    assert 4 * (b2["smem_bytes"] + 1024) <= 228 * 1024
    for entry, rows in (("sweep_closest", 4), ("sweep_transmittance", 5)):
        stages = 2 * rows * 256 * 4  # two buffers at the molecule's BLOCK
        sph = sweep.kernel_shape(entry, "sphere", 256, emulated)
        assert stages < sph["smem_bytes"] <= stages + 4096
    big = sweep.kernel_shape("sweep_transmittance", "tri", 8192, emulated)
    assert big["smem_bytes"] > limit
