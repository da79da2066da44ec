"""The exactness net (solr_tpu_torch.ops.traverse) on the CPU: one block
list per 32-ray strip of needy rays, swept by the sweep kernels' plain
versions, against the chunk-union net it replaced, rebuilt here from the
block mirrors (``tri_blocks_closest`` / ``tri_blocks_transmittance`` of
tests/torch_sweep_helpers.py over
each 512-ray chunk's union of hit blocks), on fields whose unions never
reach the old 512-block cap.

Equal bit for bit: each strip's list holds every block, in the same id
order, that can hold a hit of its rays before their bounds, and a hit
replaces the carry only where strictly closer.  The shadow factors are
0 and 0.5, so every product is exact whatever order the mirror
multiplies in (ROADMAP C3)."""

import numpy as np
import pytest
import torch

from solr_tpu_torch import RenderConfig, SceneBuilder
from solr_tpu_torch.constants import T_FAR
from solr_tpu_torch.ops import packet as pk
from solr_tpu_torch.ops import traverse
from solr_tpu_torch.ops.camera import camera_rays
from solr_tpu_torch.types import Camera
from torch_sweep_helpers import tri_blocks_closest, tri_blocks_transmittance

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

T_MIN = 1e-4
OLD_CHUNK, OLD_UCAP = 512, 512


def _field(prim: str, seed: int = 5, extent: float = 10.0):
    """A random field of one primitive kind in blocks of 16, half of it
    opaque and half of it passing half the light."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mats = [b.add_material(transparency=0.0), b.add_material(transparency=0.5)]
    n = {"tri": 1200, "sphere": 900, "cyl": 700}[prim]
    centers = rng.uniform(-extent, extent, (n, 3)) + [0.0, 0.0, extent * 1.5]
    for i, c in enumerate(centers):
        m = mats[i % 2]
        if prim == "tri":
            b.add_triangle(c, c + rng.normal(0, 0.5, 3),
                           c + rng.normal(0, 0.5, 3), m)
        elif prim == "sphere":
            b.add_sphere(tuple(c), float(rng.uniform(0.2, 0.6)), m)
        else:
            b.add_cylinder(tuple(c), tuple(c + rng.normal(0, 1.0, 3)),
                           float(rng.uniform(0.1, 0.3)), m)
    scene = b.build(block=16, device="cpu")
    return {"tri": scene.tri_accel, "sphere": scene.sph_accel,
            "cyl": scene.cyl_accel}[prim]


@pytest.fixture(scope="module", params=["tri", "sphere", "cyl"])
def field(request):
    """(prim, accel, o, d, t_cap, sort key, bound, carry) over a 64x64
    camera's rays: ``bound`` is the light distance of the shadow rays,
    the carry a best hit found before the net for a third of the rays."""
    prim = request.param
    accel = _field(prim)
    cam = Camera.create(position=(0, 0, -6.0), fov=1.0, device="cpu")
    o, d = camera_rays(cam, RenderConfig(width=64, height=64))
    gen = torch.Generator().manual_seed(1)
    r = o.shape[0]
    bmin, bmax = traverse._scene_box(accel)
    t_cap = pk.ray_box_exit(o, d, bmin, bmax)
    bt = torch.where(torch.rand(r, generator=gen) < 0.33,
                     12.0 + 20.0 * torch.rand(r, generator=gen),
                     torch.full((r,), T_FAR))
    bi = torch.where(bt < T_FAR, torch.randint(0, 100, (r,), generator=gen,
                                               dtype=torch.int32),
                     torch.full((r,), -1, dtype=torch.int32))
    tm = 8.0 + 24.0 * torch.rand(r, generator=gen)
    tr = torch.rand(r, generator=gen)
    key = traverse.spatial_keys(o + d * 10.0, bmin, bmax)
    return prim, accel, o, d, t_cap, key, tm, (bt, bi, tr)


def _need(r: int, n: int, seed: int = 2):
    need = torch.zeros(r, dtype=torch.bool)
    need[torch.randperm(r, generator=torch.Generator().manual_seed(seed))[:n]] = True
    return need


def _old_net(accel, prim, o, d, need, key, bound, carry, query):
    """The chunk-union net: the needy rays in ``key`` order, in chunks of
    OLD_CHUNK; each chunk sweeps, with the block mirrors, the union of
    the blocks that its rays' slabs enter at or before their bounds."""
    carry = tuple(x.clone() for x in carry)
    idx_all = need.nonzero().squeeze(1)
    idx_all = idx_all[torch.argsort(key[idx_all].to(torch.float32),
                                    stable=True)]
    for c0 in range(0, idx_all.shape[0], OLD_CHUNK):
        idx = idx_all[c0:c0 + OLD_CHUNK]
        b = carry[0][idx] if query == "closest" else bound[idx]
        entry, hitm = traverse._ray_block_slabs(o[idx], d[idx],
                                                accel.block_bounds, T_MIN)
        union = (hitm & (entry <= b[:, None])).any(0)
        assert int(union.sum()) <= OLD_UCAP  # this chunk never overflowed
        cand = union.nonzero().squeeze(1).to(torch.int32)[None]
        counts = torch.tensor([cand.shape[1]], dtype=torch.int32)
        if query == "closest":
            bt, bi = carry
            t, i = tri_blocks_closest(accel.packed, o[idx][None],
                                      d[idx][None], cand, counts, T_MIN, prim)
            better = t[0] < bt[idx]
            bt[idx] = torch.where(better, t[0], bt[idx])
            bi[idx] = torch.where(better, i[0], bi[idx])
        else:
            carry[0][idx] = tri_blocks_transmittance(
                accel.packed, o[idx][None], d[idx][None], bound[idx][None],
                cand, counts, T_MIN, prim)[0]
    return carry


def _new_net(accel, prim, o, d, t_cap, need, key, bound, carry, query):
    carry = tuple(x.clone() for x in carry)
    if query == "closest":
        return traverse._net_closest(accel, prim, o, d, t_cap, *carry, need,
                                     key, T_MIN)
    return (traverse._net_transmittance(accel, prim, o, d, bound, carry[0],
                                        need, key, T_MIN),)


def _carry(carry, query):
    bt, bi, tr = carry
    return (bt, bi) if query == "closest" else (tr,)


def _zero_stats():
    traverse.NET_STATS.update(dict.fromkeys(traverse.NET_STATS, 0))


@pytest.mark.parametrize("query", ["closest", "shadow"])
def test_strip_lists_give_the_chunk_union_net_bit_for_bit(field, query):
    prim, accel, o, d, t_cap, key, tm, carry = field
    carry = _carry(carry, query)
    need = _need(o.shape[0], 1500)
    _zero_stats()
    new = _new_net(accel, prim, o, d, t_cap, need, key, tm, carry, query)
    old = _old_net(accel, prim, o, d, need, key, tm, carry, query)
    for a, b in zip(new, old):
        assert torch.equal(a, b)
    # The net did work, and left the rays it was not given alone.
    assert not torch.equal(new[0][need], carry[0][need])
    for a, b in zip(new, carry):
        assert torch.equal(a[~need], b[~need])
    if query == "shadow":
        tr = new[0][need]
        assert (tr == 0.0).any() and ((tr > 0.0) & (tr < 1.0)).any()
    else:
        # A hit at exactly the carry's t keeps the carry's primitive.
        hit = need & (new[0] < T_FAR)
        tie = (new[0], torch.where(hit, -7, new[1]).to(torch.int32))
        again = _new_net(accel, prim, o, d, t_cap, need, key, tm, tie, query)
        assert hit.any() and (again[1][hit] == -7).all()
    _zero_stats()
    _new_net(accel, prim, o, d, t_cap, need, key, tm, carry, query)
    stats = traverse.NET_STATS
    assert stats["calls"] == 1 and stats["needy_rays"] == 1500
    assert stats["strips"] == -(-1500 // 32)
    assert stats["windows"] == 1
    assert stats["strip_blocks"] > stats["strips"]


@pytest.mark.parametrize("query", ["closest", "shadow"])
def test_lists_wider_than_a_window_sweep_in_windows(field, query,
                                                    monkeypatch):
    """With a window of 3 blocks, every list wider than that is swept in
    several launches, carrying the best hit or the product between them:
    the result is the one-window result."""
    prim, accel, o, d, t_cap, key, tm, carry = field
    carry = _carry(carry, query)
    need = _need(o.shape[0], 1500)
    one = _new_net(accel, prim, o, d, t_cap, need, key, tm, carry, query)
    monkeypatch.setattr(traverse, "_NET_WINDOW", 3)
    _zero_stats()
    windowed = _new_net(accel, prim, o, d, t_cap, need, key, tm, carry, query)
    assert traverse.NET_STATS["windows"] > 2
    for a, b in zip(windowed, one):
        assert torch.equal(a, b)


def test_padding_rays_leave_the_carry_alone(field):
    """37 needy rays fill two strips of one tile; the 219 padding slots
    repeat ray 0 (here a ray through the middle of the field) and are not
    live: they add no block to a list, and only the needy rays' carry
    changes."""
    prim, accel, o, d, t_cap, key, tm, carry = field
    r = o.shape[0]
    mid = r // 2 + 32
    o, d = o.clone(), d.clone()
    o[0], d[0] = o[mid], d[mid]
    for query in ("closest", "shadow"):
        c = _carry(carry, query)
        need = _need(r, 37, seed=3)
        need[0] = False
        _zero_stats()
        new = _new_net(accel, prim, o, d, t_cap, need, key, tm, c, query)
        old = _old_net(accel, prim, o, d, need, key, tm, c, query)
        for a, b, before in zip(new, old, c):
            assert torch.equal(a, b)
            assert torch.equal(a[~need], before[~need])
        # The two strips' lists: the needy rays' blocks and no others.
        idx = need.nonzero().squeeze(1)
        idx = idx[torch.argsort(key[idx].to(torch.float32), stable=True)]
        bound = c[0] if query == "closest" else tm
        want = 0
        for strip in (idx[:32], idx[32:]):
            entry, hit = traverse._ray_block_slabs(
                o[strip], d[strip], accel.block_bounds, T_MIN)
            want += int((hit & (entry <= bound[strip, None])).any(0).sum())
        entry, hit = traverse._ray_block_slabs(o[:1], d[:1],
                                               accel.block_bounds, T_MIN)
        assert (hit & (entry <= bound[:1, None])).any()  # ray 0 would add
        assert traverse.NET_STATS["strips"] == 2
        assert traverse.NET_STATS["strip_blocks"] == want
