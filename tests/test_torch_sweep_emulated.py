"""The CUDA sweep kernels, emulated on the CPU (tests/torch_sweep_helpers.py:
csrc/sweep.cu built by the host's C++ compiler, one thread per CUDA
thread, real barriers), against their plain PyTorch versions: t, idx,
tr and visits bit-equal, as on the card.  The emulation compiles without
FMA contraction, as nvcc does with --fmad=false, and runs the kernels'
own control flow: the staged kernels' lane slices and their combine
(B1, B6) at a BLOCK that 8 and 4 slices of 4 lanes do not divide, with
forced ties, empty and K-long lists, fractional factors; and the
warp-per-strip kernel of B5, which shares B6's cylinder test.

The card's own runs are tests/test_torch_gpu.py."""

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


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a C++17 compiler to build the emulation")
    return sweep.load_library(build_emulated(sweep._SRC,
                                             tmp_path_factory.mktemp("emu")))


def _run(monkeypatch, lib, launch, args, prim):
    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
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


@pytest.mark.parametrize("block,factors,ties", [
    (64, "scene", True), (64, "fractional", False),
    (200, "scene", False), (200, "fractional", True)])
def test_emulated_transmittance_cyl(emulated, monkeypatch, block, factors,
                                    ties):
    """B6 (trans_staged, 4 slices) on a small molecule's cylinders."""
    scene, cam, cfg = molecule_scene(400, 16, width=64, height=64,
                                     block=block, device="cpu")
    accel = scene.cyl_accel
    o_t, d_t, live = _rays(cam, cfg, accel)
    tm = torch.full(o_t.shape[:2], 8.0)
    cand, counts, _, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS, tm_t=tm)
    packed = fractional(accel.packed) if factors == "fractional" \
        else accel.packed
    if ties:
        packed, cand, counts = forced_ties(packed, cand, counts)
    args = (packed, o_t, d_t, tm, live, cand, counts, RAY_EPS)
    got = _run(monkeypatch, emulated, sweep.launch_transmittance, args, "cyl")
    want = sweep.sweep_transmittance_plain(*args, prim="cyl")
    assert (want[0] < 1.0).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_emulated_closest_cyl(emulated, monkeypatch):
    """B5 (closest_kernel, one warp per strip) on the same cylinders."""
    scene, cam, cfg = molecule_scene(400, 16, width=64, height=64, block=64,
                                     device="cpu")
    accel = scene.cyl_accel
    o_t, d_t, live = _rays(cam, cfg, accel)
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS)
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    args = (accel.packed, o_t, d_t, t_cap, live, cand, counts, nearb, RAY_EPS)
    got = _run(monkeypatch, emulated, sweep.launch_closest, args, "cyl")
    want = sweep.sweep_closest_plain(*args, prim="cyl")
    assert (want[0] < 1e30).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
