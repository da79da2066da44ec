"""The sweep kernels on the card against their plain PyTorch versions,
and the bench and molecule frames rendered on the card against the same
frames on the CPU.

These need a CUDA card and nvcc; without a card they skip.  The file
imports neither JAX nor solr_tpu, so it runs where only PyTorch is
installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Kernel and plain version must agree bit for bit on the same device (no
FMA contraction, the same association, tie rules and product order).
The card's frame is held to the CPU frame at atol 1e-4 outside 0.2% of
pixels: the plain PyTorch code around the kernels runs through other
elementwise and reduction kernels on the two devices.
"""

import pytest
import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.constants import RAY_EPS
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import packet as pk
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.ops.camera import camera_rays
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.ops.traverse import _scene_box

N_TRIS, SIZE, BLOCK = 20_000, 64, 512
N_ATOMS, GROUND_RES = 2_000, 32
ACCEL = {"sphere": "sph_accel", "cyl": "cyl_accel"}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels have no CPU mode")
    sweep.build()
    return torch.device("cuda")


def _selection(device):
    scene, cam, cfg = bench_scene(N_TRIS, block=BLOCK, width=SIZE,
                                  height=SIZE, device=device)
    accel = scene.tri_accel
    perm, _ = pk.tile_permutation(SIZE, SIZE, 16, 16)
    perm = torch.as_tensor(perm, device=device)
    o, d = camera_rays(cam, cfg)
    o_t, d_t = o[perm].reshape(-1, 256, 3), d[perm].reshape(-1, 256, 3)
    live = torch.ones(o_t.shape[:2], dtype=torch.bool, device=device)
    live[2, 32:70] = False
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS)
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    return accel, o_t, d_t, live, t_cap, cand, counts, nearb


@pytest.mark.gpu
def test_closest_kernel_matches_plain(cuda):
    accel, o_t, d_t, live, t_cap, cand, counts, nearb = _selection(cuda)
    args = (accel.packed, o_t, d_t, t_cap, live, cand, counts, nearb, RAY_EPS)
    before = sweep.LAUNCHES["sweep_closest"]
    got = sweep.sweep_closest(*args)
    assert sweep.LAUNCHES["sweep_closest"] == before + 1
    want = sweep.sweep_closest_plain(*args)
    assert (got[0] < 1e30).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("factors", ["scene", "fractional"])
def test_transmittance_kernel_matches_plain(cuda, factors):
    accel, o_t, d_t, live, _, _, _, _ = _selection(cuda)
    tm = torch.full(o_t.shape[:2], 50.0, device=cuda)
    cand, counts, _, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS, tm_t=tm)
    packed = accel.packed
    if factors == "fractional":
        gen = torch.Generator(device=cuda).manual_seed(1)
        packed = packed.clone()
        packed[:, 15, :] = torch.rand(packed[:, 15, :].shape, generator=gen,
                                      device=cuda) * 0.4 + 0.55
    args = (packed, o_t, d_t, tm, live, cand, counts, RAY_EPS)
    before = sweep.LAUNCHES["sweep_transmittance"]
    got = sweep.sweep_transmittance(*args)
    assert sweep.LAUNCHES["sweep_transmittance"] == before + 1
    want = sweep.sweep_transmittance_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_frame_on_card_matches_cpu(cuda):
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam, cfg = bench_scene(N_TRIS, block=BLOCK, width=SIZE,
                                      height=SIZE, device=dev)
        before = dict(sweep.LAUNCHES)
        with torch.no_grad():
            imgs.append(render_sample(scene, cam, cfg)[0].cpu())
        if dev != "cpu":  # the bench frame's pools are triangles, spheres
            # under bvh_threshold: only the triangle kernels launch
            assert min(sweep.LAUNCHES[k] - before[k]
                       for k in ("sweep_closest", "sweep_transmittance")) > 0
    cpu, card = imgs
    assert torch.isfinite(card).all()
    err = (card - cpu).abs().amax(-1)
    assert float((err > 1e-4).float().mean()) <= 0.002


@pytest.fixture(scope="module")
def molecule(cuda):
    """The reduced molecule frame on the card, its primary rays in tiles
    (a few dead rays in one strip) and a shadow ray per pixel."""
    scene, cam, cfg = molecule_scene(N_ATOMS, GROUND_RES, width=SIZE,
                                     height=SIZE, device=cuda)
    perm, _ = pk.tile_permutation(SIZE, SIZE, 16, 16)
    perm = torch.as_tensor(perm, device=cuda)
    o, d = camera_rays(cam, cfg)
    o_t, d_t = o[perm].reshape(-1, 256, 3), d[perm].reshape(-1, 256, 3)
    live = torch.ones(o_t.shape[:2], dtype=torch.bool, device=cuda)
    live[2, 32:70] = False
    return scene, o_t, d_t, live


@pytest.mark.gpu
@pytest.mark.parametrize("prim", sorted(ACCEL))
def test_prim_closest_kernel_matches_plain(molecule, prim):
    scene, o_t, d_t, live = molecule
    accel = getattr(scene, ACCEL[prim])
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS)
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    args = (accel.packed, o_t, d_t, t_cap, live, cand, counts, nearb, RAY_EPS)
    name = sweep.kernel_name("sweep_closest", prim)
    before = sweep.LAUNCHES[name]
    got = sweep.sweep_closest(*args, prim=prim)
    assert sweep.LAUNCHES[name] == before + 1
    want = sweep.sweep_closest_plain(*args, prim=prim)
    assert (got[0] < 1e30).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("factors", ["scene", "fractional"])
@pytest.mark.parametrize("prim", sorted(ACCEL))
def test_prim_transmittance_kernel_matches_plain(molecule, prim, factors):
    """Shadow rays from the camera toward points past the molecule."""
    scene, o_t, d_t, live = molecule
    accel = getattr(scene, ACCEL[prim])
    tm = torch.full(o_t.shape[:2], 8.0, device=o_t.device)
    cand, counts, _, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS, tm_t=tm)
    packed = accel.packed
    if factors == "fractional":
        gen = torch.Generator(device=packed.device).manual_seed(1)
        packed = packed.clone()
        packed[:, 15, :] = torch.rand(packed[:, 15, :].shape, generator=gen,
                                      device=packed.device) * 0.4 + 0.55
    args = (packed, o_t, d_t, tm, live, cand, counts, RAY_EPS)
    name = sweep.kernel_name("sweep_transmittance", prim)
    before = sweep.LAUNCHES[name]
    got = sweep.sweep_transmittance(*args, prim=prim)
    assert sweep.LAUNCHES[name] == before + 1
    want = sweep.sweep_transmittance_plain(*args, prim=prim)
    assert (got[0] < 1.0).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_molecule_frame_on_card_matches_cpu(cuda):
    """The reduced molecule frame: all six kernels launch on the card,
    and the image agrees with the CPU's within the frame budget."""
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam, cfg = molecule_scene(N_ATOMS, GROUND_RES, width=SIZE,
                                         height=SIZE, device=dev)
        before = dict(sweep.LAUNCHES)
        with torch.no_grad():
            imgs.append(render_sample(scene, cam, cfg)[0].cpu())
        if dev != "cpu":
            assert min(sweep.LAUNCHES[k] - before[k] for k in before) > 0
    cpu, card = imgs
    assert torch.isfinite(card).all()
    err = (card - cpu).abs().amax(-1)
    assert float((err > 1e-4).float().mean()) <= 0.002
