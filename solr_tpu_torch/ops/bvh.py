"""BVH build, refit and the per-ray walks (counterpart of
solr_tpu/ops/bvh.py).

The BVH is a median-split tree over a Morton-ordered pool, flattened in
DFS preorder with skip pointers: a ray that hits node i goes on to
i + 1, one that misses jumps to ``skip[i]``.  It is built on the host in
numpy (``build_bvh``, the reference's numpy path, whose node arrays its
native builder reproduces) and refitted on the device (``bvh_refit``).

Two walks, each with a plain PyTorch version and a wrapper, for the
sphere, triangle and cylinder pools:

* ``bvh_closest_hit`` (replaces ``bvh_closest_hit``, a ``lax.while_loop``
  at solr_tpu/ops/bvh.py:333): the closest primitive with
  t_min < t <= t_max, and the lowest pool row among equally near ones.
  A box is entered when its slab interval meets [t_min, min(best,
  t_max)]; inside a leaf the lowest lane wins a tie.  The DFS walk
  (``bvh_closest_hit_plain``) replaces the best across leaves only when
  strictly nearer, and leaves come in ascending rows.  The kernels walk
  with a stack (``bvh_closest_hit_ordered_plain``), left child first or
  near child first, and break a tie across leaves by the lower row.
  Left child first returns the DFS walk's (t, idx) on any tree; near
  child first only where every leaf box holds its primitives, which
  ``Scene.with_params`` breaks by moving them without a refit (ROADMAP
  C9).  So triangles walk near child first while ``leaf_boxes_hold``,
  and left child first on a stale tree; spheres and cylinders always
  walk left child first (``walks_near_first``).
* ``bvh_transmittance`` (replaces ``bvh_transmittance`` at
  solr_tpu/ops/bvh.py:397): the product over every occluder with
  t < t_max of its material's transparency (1 for an emissive one).  A
  leaf's factors multiply in ascending lane order and the leaf product
  then multiplies into the ray's, in DFS order; the walk stops once that
  is <= 1e-6.

Both also count, per ray, the nodes visited (1 for the root and 2 for
each inner node whose box is hit, the shadow walk's nodes up to its
stop) and the leaf lanes tested.  CPU tensors take the plain versions
(the closest hit in the order the kernel would walk); CUDA tensors take
the hand-written kernels of ``solr_tpu_torch/csrc/bvh_walk.cu``, built
with nvcc at first use (``sweep.compile_library``, the same flags) and
loaded with ctypes.  A build or launch failure raises; nothing falls
back.  Kernel and plain version agree bit for bit on the same device:
the same association in every primitive test and in the slab test, no
FMA contraction, IEEE division and square root.

The kernels read layouts derived from the BVH and the pool
(``pack_nodes``: one 64-byte row per inner node with both children's
boxes; ``pack_triangles``: (v0, e1, e2, shadow factor) per row;
``pack_spheres``: (centre, radius, radius^2, shadow factor) per row;
``pack_cylinders``: (p0, radius, axis, |axis|^2, 1 / |axis|^2,
radius^2, shadow factor) per row), built on the device at a launch and
reused, one per pool, while every source tensor is the same object at
the same version (``_derived``); so is the triangles' leaf-box
check.

The plain walks are masked step loops: every step takes one node per
ray; every ``_CHECK_EVERY`` steps one host sync drops the rays whose
walk has ended.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import numpy as np
import torch

from solr_tpu_torch.constants import (BVH_LEAF_SIZE, INTERSECT_EPS,
                                      POOL_CYLINDER, POOL_SPHERE,
                                      POOL_TRIANGLE, T_FAR)
from solr_tpu_torch.ops import intersect as isect
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.types import BVH

__all__ = [
    "LAUNCHES",
    "PRIMS",
    "build",
    "build_bvh",
    "bvh_closest_hit",
    "bvh_closest_hit_ordered_plain",
    "bvh_closest_hit_plain",
    "bvh_refit",
    "bvh_transmittance",
    "bvh_transmittance_plain",
    "kernel_name",
    "launch_closest",
    "launch_transmittance",
    "leaf_boxes_hold",
    "load_library",
    "morton_codes",
    "morton_order",
    "outside_leaf_boxes",
    "pack_cylinders",
    "pack_nodes",
    "pack_spheres",
    "pack_triangles",
    "pool_aabbs",
    "walks_near_first",
]

_AABB_PAD = 1e-5

# Primitive kinds in the order of their codes in csrc/bvh_walk.cu, and
# the pool each walks.
PRIMS = ("tri", "sphere", "cyl")
_PRIM_POOL = {"tri": POOL_TRIANGLE, "sphere": POOL_SPHERE,
              "cyl": POOL_CYLINDER}
POOL_PRIM = {c: p for p, c in _PRIM_POOL.items()}
ENTRIES = ("bvh_closest_hit", "bvh_transmittance")


def kernel_name(entry: str, prim: str, dfs: bool = False) -> str:
    """One walk kernel's name: the entry point and the primitive kind
    ("bvh_closest_hit_tri", ...), and "_dfs" for the triangle closest
    hit in the DFS walk's order (spheres and cylinders walk in no
    other)."""
    return f"{entry}_{prim}" + ("_dfs" if dfs else "")


# Kernel launch counts, one per kernel (entry point x primitive kind,
# and the DFS-order triangle closest hit); incremented only where a
# wrapper launches that kernel.
LAUNCHES = {kernel_name(e, p): 0 for p in PRIMS for e in ENTRIES}
LAUNCHES[kernel_name("bvh_closest_hit", "tri", dfs=True)] = 0

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "bvh_walk.cu"
_lib = None
_lock = threading.Lock()

# Steps of the plain walks between two checks for finished rays.
_CHECK_EVERY = 8


# --------------------------------------------------------------------------
# Build (host, numpy)
# --------------------------------------------------------------------------


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v to every 3rd bit."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit 3-D Morton codes of points quantized into a 1024^3 grid."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / span) * 1023.0, 0, 1023).astype(np.uint32)
    return ((_expand_bits(q[:, 0]) << np.uint64(2))
            | (_expand_bits(q[:, 1]) << np.uint64(1))
            | _expand_bits(q[:, 2]))


def morton_order(amin: np.ndarray, amax: np.ndarray) -> np.ndarray:
    """The stable Morton order of AABBs (N, 3) by their centroids: the
    order ``build_bvh`` puts a pool in."""
    return np.argsort(morton_codes(0.5 * (amin + amax)),
                      kind="stable").astype(np.int32)


@functools.lru_cache(maxsize=None)
def _subtree_nodes(m: int, leaf_size: int) -> int:
    """Nodes of the median-split subtree over m primitives: a node over
    more than leaf_size splits into m // 2 and m - m // 2."""
    if m <= leaf_size:
        return 1
    return (1 + _subtree_nodes(m // 2, leaf_size)
            + _subtree_nodes(m - m // 2, leaf_size))


def _preorder_ranges(n: int, leaf_size: int):
    """(starts, ends, skips, depths) of the median-split tree over n
    primitives in DFS preorder: the reference's recursion
    (bvh.py:118-138) built level by level.  A subtree's shape depends
    only on its size, so a node's right child sits after its left
    child's whole subtree."""
    k = _subtree_nodes(n, leaf_size)
    starts, ends, skips, depths = (np.empty(k, np.int32) for _ in range(4))
    s, e, idx = (np.array([v], np.int64) for v in (0, n, 0))
    depth = 0
    while s.size:
        m = e - s
        sizes, inv = np.unique(m, return_inverse=True)
        nodes = np.array([_subtree_nodes(int(x), leaf_size) for x in sizes])
        starts[idx], ends[idx], depths[idx] = s, e, depth
        skips[idx] = idx + nodes[inv.reshape(-1)]
        inner = m > leaf_size
        s, e, idx, m = s[inner], e[inner], idx[inner], m[inner]
        mid = s + m // 2  # = (s + e) // 2
        half = np.array([_subtree_nodes(int(x), leaf_size) for x in m // 2],
                        np.int64)
        s, e = np.concatenate([s, mid]), np.concatenate([mid, e])
        idx = np.concatenate([idx + 1, idx + 1 + half])
        depth += 1
    return starts, ends, skips, depths


def build_bvh(aabb_min, aabb_max, leaf_size: int = BVH_LEAF_SIZE,
              device="cuda"):
    """Build the median-split BVH over primitives given their AABBs
    (N, 3), on the host.  Returns (bvh with tensors on ``device``,
    order): leaf ranges index the reordered pool ``pool[order]``."""
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    n = aabb_min.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over 0 primitives")
    order = morton_order(aabb_min, aabb_max)
    smin, smax = aabb_min[order], aabb_max[order]
    starts, ends, skips, depths = _preorder_ranges(n, leaf_size)
    is_leaf = ends - starts <= leaf_size
    k = starts.shape[0]
    nmin = np.empty((k, 3), np.float32)
    nmax = np.empty((k, 3), np.float32)
    # Leaves reduce their sorted primitives; leaf ranges ascend and
    # partition the pool.  Inner nodes join their two children, deepest
    # level first.
    leaf_ids = np.nonzero(is_leaf)[0]
    nmin[leaf_ids] = np.minimum.reduceat(smin, starts[leaf_ids], axis=0)
    nmax[leaf_ids] = np.maximum.reduceat(smax, starts[leaf_ids], axis=0)
    for lvl in range(int(depths.max()) - 1, -1, -1):
        ids = np.nonzero((depths == lvl) & ~is_leaf)[0]
        left = ids + 1
        right = skips[left]
        nmin[ids] = np.minimum(nmin[left], nmin[right])
        nmax[ids] = np.maximum(nmax[left], nmax[right])
    nmin -= _AABB_PAD
    nmax += _AABB_PAD
    return (_assemble_bvh(starts, ends, skips, depths, nmin, nmax, leaf_size,
                          device), order)


def _assemble_bvh(starts, ends, skips, depths, nmin, nmax, leaf_size: int,
                  device) -> BVH:
    """The BVH from its flattened node arrays, with the leaf view."""
    counts = ends - starts
    is_leaf = counts <= leaf_size
    leaf_ids = np.nonzero(is_leaf)[0]
    lmin, lmax = nmin[leaf_ids], nmax[leaf_ids]
    n_leaves = len(leaf_ids)
    pad = -(-n_leaves // 128) * 128 - n_leaves
    lc = np.concatenate([0.5 * (lmin + lmax),
                         np.full((pad, 3), 1e30, np.float32)])
    lr = np.concatenate([0.5 * np.linalg.norm(lmax - lmin, axis=-1),
                         np.zeros(pad, np.float32)])
    lfirst = np.concatenate([starts[leaf_ids], np.zeros(pad, np.int32)])
    lcount = np.concatenate([counts[leaf_ids], np.zeros(pad, np.int32)])

    def ten(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    f32, i32 = torch.float32, torch.int32
    return BVH(
        aabb_min=ten(nmin, f32), aabb_max=ten(nmax, f32),
        skip=ten(skips, i32),
        first_prim=ten(np.where(is_leaf, starts, -1), i32),
        prim_count=ten(np.where(is_leaf, counts, 0), i32),
        depth=ten(depths, i32), leaf_center=ten(lc, f32),
        leaf_radius=ten(lr, f32), leaf_first=ten(lfirst, i32),
        leaf_count=ten(lcount, i32), max_depth=int(depths.max()),
        leaf_size=int(leaf_size))


def _prim_aabbs(scene, prim: str):
    """Per-primitive AABBs (N, 3) each of the pool of kind ``prim``, as
    tensors on the pool's device: a sphere's c -+ r, a triangle's
    vertex min and max, a cylinder's end-point min and max -+ r."""
    if prim == "sphere":
        c, r = scene.spheres.center, scene.spheres.radius[:, None]
        return c - r, c + r
    if prim == "tri":
        t = scene.triangles
        return (torch.minimum(torch.minimum(t.v0, t.v1), t.v2),
                torch.maximum(torch.maximum(t.v0, t.v1), t.v2))
    p = scene.cylinders
    r = p.radius[:, None]
    return torch.minimum(p.p0, p.p1) - r, torch.maximum(p.p0, p.p1) + r


def pool_aabbs(scene, pool_code: int):
    """Per-primitive AABBs (numpy (N, 3) each) of an accelerated pool."""
    if pool_code not in POOL_PRIM:
        raise ValueError(f"pool {pool_code} is not BVH-accelerated")
    with torch.no_grad():
        return tuple(x.cpu().numpy()
                     for x in _prim_aabbs(scene, POOL_PRIM[pool_code]))


@torch.no_grad()
def bvh_refit(bvh: BVH, prim_min, prim_max) -> BVH:
    """Node AABBs recomputed from primitive bounds (N, 3) at fixed
    topology, deepest level first.  The BVH is a derived accelerator and
    carries no gradient."""
    k, leaf_size = bvh.n_nodes, bvh.leaf_size
    is_leaf = bvh.first_prim >= 0
    lane = torch.arange(leaf_size, device=prim_min.device)
    pidx = (bvh.first_prim[:, None] + lane).clamp(0, prim_min.shape[0] - 1)
    mask = (lane < bvh.prim_count[:, None])[..., None]
    inf = torch.tensor(float("inf"), device=prim_min.device)
    nmin = torch.where(mask, prim_min[pidx], inf).amin(1)
    nmax = torch.where(mask, prim_max[pidx], -inf).amax(1)
    nmin = torch.where(is_leaf[:, None], nmin, inf)
    nmax = torch.where(is_leaf[:, None], nmax, -inf)
    left = (torch.arange(k, device=prim_min.device) + 1).clamp(max=k - 1)
    right = bvh.skip[left].long().clamp(0, k - 1)
    for lvl in range(bvh.max_depth - 1, -1, -1):
        sel = ((bvh.depth == lvl) & ~is_leaf)[:, None]
        nmin = torch.where(sel, torch.minimum(nmin[left], nmin[right]), nmin)
        nmax = torch.where(sel, torch.maximum(nmax[left], nmax[right]), nmax)
    return bvh.replace(aabb_min=nmin - _AABB_PAD, aabb_max=nmax + _AABB_PAD)


# --------------------------------------------------------------------------
# Plain walks
# --------------------------------------------------------------------------


def _pool_size(scene, prim: str) -> int:
    return {"tri": scene.triangles.v0, "sphere": scene.spheres.radius,
            "cyl": scene.cylinders.radius}[prim].shape[0]


def _leaf_t(scene, prim: str, o, d, first, cnt, leaf_size: int, t_min):
    """t of each ray (R, 3) against the ``leaf_size`` lanes from
    ``first`` (R,): (R, leaf_size), T_FAR where the lane is not below
    ``cnt`` (R,); the pool tests the brute force takes
    (ops/intersect.py).  Also returns the lanes' pool rows."""
    lanes = torch.arange(leaf_size, device=cnt.device, dtype=cnt.dtype)
    pids = (first[:, None] + lanes).clamp(0, _pool_size(scene, prim) - 1).long()
    ob, db = o[:, None, :], d[:, None, :]
    if prim == "sphere":
        p = scene.spheres
        t = isect.sphere_t_p(ob, db, p.center[pids], p.radius[pids], t_min)
    elif prim == "tri":
        p = scene.triangles
        t = isect.triangle_t_p(ob, db, p.v0[pids], p.v1[pids], p.v2[pids],
                               t_min)
    else:
        p = scene.cylinders
        t = isect.cylinder_t_p(ob, db, p.p0[pids], p.p1[pids],
                               p.radius[pids], t_min)
    return torch.where(lanes < cnt[:, None], t, torch.full_like(t, T_FAR)), pids


def _walk(scene, bvh: BVH, prim, o, d, t_min, t_max, closest: bool):
    """The masked step loop of both walks.  Returns (value, idx or None,
    visits, tests), each of the rays' shape."""
    r_shape = o.shape[:-1]
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n_rays, dev, k = o.shape[0], o.device, bvh.n_nodes
    tm = torch.as_tensor(t_max, dtype=o.dtype, device=dev).expand(
        r_shape).reshape(-1)
    inv_d = 1.0 / torch.where(d.abs() > 1e-12, d, torch.full_like(d, 1e-12))
    value = torch.full((n_rays,), T_FAR if closest else 1.0, dtype=o.dtype,
                       device=dev)
    best_i = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    visits = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    tests = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    ptr = torch.zeros(n_rays, dtype=torch.int64, device=dev)
    ids = torch.arange(n_rays, device=dev)
    mats = scene.materials
    pool = {"tri": scene.triangles, "sphere": scene.spheres,
            "cyl": scene.cylinders}[prim]
    # The rays still walking, compacted: their state and inputs.
    st = [ptr, value, best_i, visits, tests, o, d, inv_d, tm]
    while ids.numel():
        p, val, bi, vis, tst, oc, dc, ic, tmc = st
        for _ in range(_CHECK_EVERY):
            alive = p < k
            sp = p.clamp(max=k - 1)
            limit = torch.minimum(val, tmc) if closest else tmc
            hit = isect.aabb_hit(oc, ic, bvh.aabb_min[sp], bvh.aabb_max[sp],
                                 t_min, limit) & alive
            first = bvh.first_prim[sp]
            cnt = torch.where(hit, bvh.prim_count[sp], 0)
            t, pids = _leaf_t(scene, prim, oc, dc, first, cnt, bvh.leaf_size,
                              t_min)
            if closest:
                t = torch.where(t <= limit[:, None], t, torch.full_like(t, T_FAR))
                # Lowest lane first among equal t (a strict < in
                # ascending lanes), then a strict < against the best.
                lm = torch.full_like(val, T_FAR)
                la = torch.zeros_like(bi)
                for j in range(bvh.leaf_size):
                    better = t[:, j] < lm
                    lm = torch.where(better, t[:, j], lm)
                    la = torch.where(better, j, la)
                better = lm < val
                val = torch.where(better, lm, val)
                bi = torch.where(better, first + la, bi)
            else:
                occ = t < tmc[:, None]  # lanes past cnt are T_FAR
                m = pool.material[pids].long()
                f = torch.where(mats.emission[m] > 0.0,
                                torch.ones_like(mats.transparency[m]),
                                mats.transparency[m])
                prod = torch.ones_like(val)
                for j in range(bvh.leaf_size):
                    prod = prod * torch.where(occ[:, j], f[:, j],
                                              torch.ones_like(prod))
                val = val * prod
            nxt = torch.where(hit & (first < 0), sp + 1, bvh.skip[sp].long())
            p = torch.where(alive, nxt, p)
            if not closest:  # a ray in full shadow stops walking
                p = torch.where(val <= 1e-6, torch.full_like(p, k), p)
            vis = vis + alive.to(torch.int32)
            tst = tst + cnt
        done = p >= k
        fin = ids[done]
        value[fin], best_i[fin] = val[done], bi[done]
        visits[fin], tests[fin] = vis[done], tst[done]
        keep = ~done
        ids = ids[keep]  # the host sync of this check
        st = [x[keep] for x in (p, val, bi, vis, tst, oc, dc, ic, tmc)]
    return (value.reshape(r_shape), best_i.reshape(r_shape) if closest
            else None, visits.reshape(r_shape), tests.reshape(r_shape))


def bvh_closest_hit_plain(scene, bvh: BVH, prim: str, o, d, t_min,
                          t_max=T_FAR):
    """Plain PyTorch closest-hit walk of the pool of kind ``prim``.
    Returns (t, idx, visits, tests), of the rays' shape: T_FAR and idx 0
    on a miss."""
    return _walk(scene, bvh, prim, o, d, t_min, t_max, True)


def bvh_transmittance_plain(scene, bvh: BVH, prim: str, o, d, t_min,
                            t_max):
    """Plain PyTorch shadow walk of the pool of kind ``prim``.  Returns
    (tr in [0, 1], visits, tests), of the rays' shape."""
    tr, _, visits, tests = _walk(scene, bvh, prim, o, d, t_min, t_max, False)
    return tr, visits, tests


def bvh_closest_hit_ordered_plain(scene, bvh: BVH, prim: str, o, d, t_min,
                                  t_max=T_FAR, near_first: bool = True):
    """Plain PyTorch closest-hit walk in the kernels' order: at
    an inner node both children are slab-tested; of two hit children the
    ray enters the one with the smaller entry distance tn (the left one
    on equal tn; always the left one when not ``near_first``) and pushes
    the other with its tn onto a stack of ``bvh.max_depth + 1`` entries;
    a popped entry is dropped when not tn <= min(best, t_max).  A leaf's
    lowest-lane nearest hit replaces the best when nearer, or equally
    near (and a hit) with a lower pool row.  Returns (t, idx, visits,
    tests) as :func:`bvh_closest_hit_plain` does, with (t, idx) equal to
    it where every box contains its primitives, and on any tree when
    not ``near_first`` (the DFS walk's leaf order, and a limit that
    only falls); visits count 1 for the root and 2 per inner node
    entered."""
    r_shape = o.shape[:-1]
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n_rays, dev, k = o.shape[0], o.device, bvh.n_nodes
    depth = bvh.max_depth + 1
    tm = torch.as_tensor(t_max, dtype=o.dtype, device=dev).expand(
        r_shape).reshape(-1)
    inv_d = 1.0 / torch.where(d.abs() > 1e-12, d, torch.full_like(d, 1e-12))
    value = torch.full((n_rays,), T_FAR, dtype=o.dtype, device=dev)
    best_i = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    visits = torch.ones(n_rays, dtype=torch.int32, device=dev)
    tests = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    ids = torch.arange(n_rays, device=dev)
    left = (torch.arange(k, device=dev) + 1).clamp(max=k - 1)
    right = bvh.skip[left].long().clamp(max=k - 1)
    tn, tf = isect.aabb_slab(o, inv_d, bvh.aabb_min[0], bvh.aabb_max[0])
    has = (tn <= tf) & (tf >= t_min) & (tn <= torch.minimum(value, tm))
    cur = torch.zeros(n_rays, dtype=torch.int64, device=dev)
    stack = torch.zeros((n_rays, depth), dtype=torch.int64, device=dev)
    stack_tn = torch.zeros((n_rays, depth), dtype=o.dtype, device=dev)
    sp = torch.zeros(n_rays, dtype=torch.int64, device=dev)
    # The rays still walking, compacted: their state and inputs.  A ray
    # holds a node to take (has: cur, entered at cur_tn) or pops one.
    st = [has, cur, tn, stack, stack_tn, sp, value, best_i, visits, tests, o,
          d, inv_d, tm]
    while ids.numel():
        (h, c, ctn, stk, stn, p, val, bi, vis, tst, oc, dc, ic, tmc) = st
        rows = torch.arange(c.shape[0], device=dev)
        for _ in range(_CHECK_EVERY):
            limit = torch.minimum(val, tmc)
            h = h & (ctn <= limit)  # a popped entry past the limit drops
            first = bvh.first_prim[c]
            leaf = h & (first >= 0)
            inner = h & (first < 0)
            # A leaf: its lanes, the lowest nearest one, the tie rule.
            cnt = torch.where(leaf, bvh.prim_count[c], 0)
            t, _ = _leaf_t(scene, prim, oc, dc, first, cnt, bvh.leaf_size,
                           t_min)
            t = torch.where(t <= limit[:, None], t, torch.full_like(t, T_FAR))
            lm = torch.full_like(val, T_FAR)
            la = torch.zeros_like(bi)
            for j in range(bvh.leaf_size):
                better = t[:, j] < lm
                lm = torch.where(better, t[:, j], lm)
                la = torch.where(better, j, la)
            row = first + la
            better = (lm < val) | ((lm == val) & (val < T_FAR) & (row < bi))
            val = torch.where(better, lm, val)
            bi = torch.where(better, row, bi)
            tst = tst + cnt
            # An inner node: both children, the nearer hit first.
            lc, rc = left[c], right[c]
            tn0, tf0 = isect.aabb_slab(oc, ic, bvh.aabb_min[lc],
                                       bvh.aabb_max[lc])
            tn1, tf1 = isect.aabb_slab(oc, ic, bvh.aabb_min[rc],
                                       bvh.aabb_max[rc])
            h0 = inner & (tn0 <= tf0) & (tf0 >= t_min) & (tn0 <= limit)
            h1 = inner & (tn1 <= tf1) & (tf1 >= t_min) & (tn1 <= limit)
            vis = vis + 2 * inner.to(torch.int32)
            both = h0 & h1
            rnear = (tn1 < tn0) & near_first
            slot = p.clamp(max=depth - 1)
            stk[rows, slot] = torch.where(both, torch.where(rnear, lc, rc),
                                          stk[rows, slot])
            stn[rows, slot] = torch.where(both, torch.where(rnear, tn0, tn1),
                                          stn[rows, slot])
            p = p + both.long()
            take_r = h1 & (rnear | ~h0)
            c = torch.where(h0 | h1, torch.where(take_r, rc, lc), c)
            ctn = torch.where(h0 | h1, torch.where(take_r, tn1, tn0), ctn)
            h = h0 | h1
            # Otherwise the latest pending entry.
            pop = ~h & (p > 0)
            p = p - pop.long()
            top = p.clamp(min=0)
            c = torch.where(pop, stk[rows, top], c)
            ctn = torch.where(pop, stn[rows, top], ctn)
            h = h | pop
        done = ~h
        fin = ids[done]
        value[fin], best_i[fin] = val[done], bi[done]
        visits[fin], tests[fin] = vis[done], tst[done]
        keep = ~done
        ids = ids[keep]  # the host sync of this check
        st = [x[keep] for x in (h, c, ctn, stk, stn, p, val, bi, vis, tst,
                                oc, dc, ic, tmc)]
    return tuple(x.reshape(r_shape) for x in (value, best_i, visits, tests))


# --------------------------------------------------------------------------
# CUDA build and wrappers
# --------------------------------------------------------------------------


def load_library(path):
    """Load a compiled walk library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    lib.solr_bvh_closest_packed.argtypes = [i32, i32] + [vp] * 5 + [
        i64, f32] + [vp] * 5
    lib.solr_bvh_closest_packed.restype = i32
    lib.solr_bvh_transmittance_packed.argtypes = [i32] + [vp] * 5 + [
        i64, f32] + [vp] * 4
    lib.solr_bvh_transmittance_packed.restype = i32
    return lib


def build(verbose: bool = False) -> str:
    """Compile ``csrc/bvh_walk.cu`` for sm_90a (once per source and flag
    set) and load it.  Returns the compiler's output when it built, ''
    when the library was already there.  Raises on any failure."""
    global _lib
    with _lock:
        path, log = sweep.compile_library(_SRC.read_bytes(),
                                          stem="libsolr_bvh_walk",
                                          verbose=verbose)
        if _lib is None:
            _lib = load_library(path)
        return log


def _library():
    if _lib is None:
        build()
    return _lib


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


# The deepest stack of the kernels (kMaxStack in bvh_walk.cu).
_MAX_STACK = 32


def pack_nodes(bvh: BVH):
    """The kernels' node rows (R, 4, 4) float32, 64 bytes each:
    row 0 holds the root, row r > 0 the inner node of inner rank r - 1
    (DFS order), with its left child c0 (node i + 1) and right child c1
    (``skip[i + 1]``) as (c0.lo, c0.hi.x), (c0.hi.yz, c1.lo.xy),
    (c1.lo.z, c1.hi) and the int32 bits of (ref0, ref1, count0,
    count1): an inner child's ref is its row, a leaf's is ~first_prim.
    The root sits in row 0's c0 slots; the rest of row 0 is 0."""
    i32, dev = torch.int32, bvh.skip.device
    inner = bvh.first_prim < 0
    rank = torch.cumsum(inner.to(i32), 0, dtype=i32)
    ref = torch.where(inner, rank, ~bvh.first_prim.to(i32))
    cnt = bvh.prim_count.to(i32)
    lo = bvh.aabb_min.to(torch.float32).contiguous().view(i32)
    hi = bvh.aabb_max.to(torch.float32).contiguous().view(i32)
    ids = torch.nonzero(inner).squeeze(1)
    left = ids + 1
    right = bvh.skip[left].long()
    ids0 = torch.zeros(1, dtype=torch.long, device=dev)

    def slots(c):  # (M, 8): a child's box and its ref and count
        return torch.cat([lo[c], hi[c], ref[c, None], cnt[c, None]], 1)

    a, b = slots(left), slots(right)
    rows = torch.cat([a[:, :6], b[:, :6], a[:, 6:7], b[:, 6:7], a[:, 7:],
                      b[:, 7:]], 1)
    r0 = slots(ids0)
    root = torch.cat([r0[:, :6], torch.zeros_like(r0[:, :6]), r0[:, 6:7],
                      torch.zeros_like(r0[:, :1]), r0[:, 7:],
                      torch.zeros_like(r0[:, :1])], 1)
    return torch.cat([root, rows]).contiguous().view(torch.float32).view(
        -1, 4, 4)


def _shadow_factor(material, mats):
    """Each row's shadow factor (float32): 1 for an emissive material,
    else its transparency."""
    m = material.long()
    return torch.where(mats.emission[m] > 0.0,
                       torch.ones_like(mats.transparency[m]),
                       mats.transparency[m]).to(torch.float32)


def pack_triangles(scene):
    """The triangle kernels' rows (N, 3, 4) float32, in pool order:
    (v0, e1.x), (e1.yz, e2.xy), (e2.z, factor, 0, 0) with e1 = v1 - v0
    and e2 = v2 - v0 in float32 (the rounding of
    intersect.triangle_t_p) and the row's shadow factor: 1 for an
    emissive material, else its transparency."""
    p = scene.triangles

    def f32(x):
        return x.to(torch.float32)

    v0 = f32(p.v0)
    factor = _shadow_factor(p.material, scene.materials)
    return torch.cat([v0, f32(p.v1) - v0, f32(p.v2) - v0, factor[:, None],
                      torch.zeros_like(v0[:, :2])], 1).contiguous().view(
                          -1, 3, 4)


def pack_spheres(scene):
    """The sphere kernels' rows (N, 2, 4) float32, in pool order:
    (center, r), (r * r, factor, 0, 0) with r * r in float32 (the
    rounding of intersect.sphere_t_p) and the row's shadow factor: 1 for
    an emissive material, else its transparency."""
    p = scene.spheres
    c = p.center.to(torch.float32)
    r = p.radius.to(torch.float32)
    factor = _shadow_factor(p.material, scene.materials)
    zero = torch.zeros_like(r)
    return torch.stack([c[:, 0], c[:, 1], c[:, 2], r, r * r, factor, zero,
                        zero], 1).contiguous().view(-1, 2, 4)


def pack_cylinders(scene):
    """The cylinder kernels' rows (N, 3, 4) float32, in pool order:
    (p0, r), (axis, h2), (1 / max(h2, 1e-8), r * r, factor, 0) with
    axis = p1 - p0 and h2 = (x * x + y * y) + z * z in float32, each term
    by the f32 operations of intersect.cylinder_t_p -> packet.cyl_core,
    and the row's shadow factor: 1 for an emissive material, else its
    transparency."""
    p = scene.cylinders
    p0 = p.p0.to(torch.float32)
    r = p.radius.to(torch.float32)
    axis = p.p1.to(torch.float32) - p0
    ax, ay, az = axis.unbind(1)
    h2 = ax * ax + ay * ay + az * az
    inv_h2 = 1.0 / torch.clamp(h2, min=INTERSECT_EPS)
    factor = _shadow_factor(p.material, scene.materials)
    return torch.stack([p0[:, 0], p0[:, 1], p0[:, 2], r, ax, ay, az, h2,
                        inv_h2, r * r, factor, torch.zeros_like(r)],
                       1).contiguous().view(-1, 3, 4)


# One derived value per kind: (the source tensors, their keys, the
# value).  The sources are held, so no other tensor can take their
# memory while the entry stands.
_DERIVED: dict = {}


def _derived(kind: str, sources, make):
    """``make()``, or the value of ``kind`` made last, while each of
    ``sources`` is the same tensor object with the same data pointer,
    shape, strides and version (an in-place write bumps the version;
    ``with_params`` and ``bvh_refit`` make new tensors)."""
    def key(x):
        return (x.data_ptr(), x._version, tuple(x.shape), x.stride())

    sources = tuple(sources)
    if any(x.is_inference() for x in sources):
        return make()
    keys = tuple(key(x) for x in sources)
    hit = _DERIVED.get(kind)
    if (hit is not None and hit[1] == keys
            and all(a is b for a, b in zip(hit[0], sources))):
        return hit[2]
    out = make()
    _DERIVED[kind] = (sources, keys, out)
    return out


def _tree_tensors(bvh: BVH):
    return (bvh.aabb_min, bvh.aabb_max, bvh.skip, bvh.first_prim,
            bvh.prim_count)


@torch.no_grad()
def outside_leaf_boxes(scene, bvh: BVH, prim: str):
    """(N,) bool, on the pool's device: the pool rows of kind ``prim``
    whose AABB (as ``pool_aabbs`` bounds it) is not inside the box of
    the leaf that holds them, or is NaN.  Inner boxes hold their
    children by construction (``build_bvh``, ``bvh_refit``), so a tree
    without such a row has boxes that contain their primitives."""
    pmin, pmax = _prim_aabbs(scene, prim)
    n, dev = pmin.shape[0], pmin.device
    lane = torch.arange(bvh.leaf_size, device=dev)
    pidx = (bvh.first_prim[:, None] + lane).clamp(0, n - 1)
    held = (bvh.first_prim >= 0)[:, None] & (lane < bvh.prim_count[:, None])
    lo = bvh.aabb_min.to(pmin.dtype)[:, None]
    hi = bvh.aabb_max.to(pmax.dtype)[:, None]
    inside = ((lo <= pmin[pidx]) & (pmax[pidx] <= hi)).all(-1)
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    return out.index_put_((pidx[held],), ~inside[held])


def leaf_boxes_hold(scene, bvh: BVH, prim: str) -> bool:
    """Whether every leaf box of ``bvh`` holds its primitives of kind
    ``prim`` (no :func:`outside_leaf_boxes` row): where it does, a
    near-first walk returns the DFS walk's (t, idx).  One host sync per
    version of the tree and the pool's geometry, whose tensors key the
    cached answer."""
    return _derived(f"holds_{prim}", _tree_tensors(bvh)
                    + _pool_tensors(scene, prim, False),
                    lambda: not bool(outside_leaf_boxes(scene, bvh,
                                                        prim).any()))


def walks_near_first(scene, bvh: BVH, prim: str) -> bool:
    """The closest hit's order: near child first for triangles while
    :func:`leaf_boxes_hold`, else (a stale triangle tree, and every
    sphere and cylinder tree) left child first, the DFS walk's order."""
    return prim == "tri" and leaf_boxes_hold(scene, bvh, "tri")


def _packed_layouts(scene, bvh: BVH, prim: str, rows=None):
    """The packed nodes and rows of the kernels of kind ``prim``,
    derived (or reused) from the BVH's and the pool's current tensors,
    one cached pair per pool; ``rows`` instead of the rows where
    given."""
    if bvh.max_depth + 1 > _MAX_STACK:
        raise ValueError(f"the walk kernels take trees of at most "
                         f"{_MAX_STACK - 1} levels, got {bvh.max_depth}")
    mats = scene.materials
    nodes = _derived(f"nodes_{prim}", _tree_tensors(bvh),
                     lambda: pack_nodes(bvh))
    if rows is not None:
        return nodes, rows
    if prim == "tri":
        p = scene.triangles
        rows = _derived("tris", (p.v0, p.v1, p.v2, p.material, mats.emission,
                                 mats.transparency),
                        lambda: pack_triangles(scene))
    elif prim == "sphere":
        p = scene.spheres
        rows = _derived("sphs", (p.center, p.radius, p.material,
                                 mats.emission, mats.transparency),
                        lambda: pack_spheres(scene))
    else:
        p = scene.cylinders
        rows = _derived("cyls", (p.p0, p.p1, p.radius, p.material,
                                 mats.emission, mats.transparency),
                        lambda: pack_cylinders(scene))
    return nodes, rows


def _check_prim(prim: str):
    if prim not in PRIMS:
        raise ValueError(f"prim must be one of {PRIMS}, got {prim!r}")


def _walk_rays(o, d, t_max):
    """The flat contiguous float32 rays a walk kernel reads: (o, d,
    t_max)."""
    if o.shape != d.shape or o.shape[-1] != 3:
        raise ValueError("o and d must both be (..., 3)")
    dev = o.device
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(
        o.shape[:-1]).reshape(-1).contiguous()
    return tuple(x.to(dtype=torch.float32).reshape(-1, 3).contiguous()
                 for x in (o, d)) + (tm,)


def launch_closest(lib, scene, bvh: BVH, prim: str, o, d, t_min,
                   t_max=T_FAR, near_first: bool = True, rows=None):
    """One launch of ``lib``'s closest-hit walk on CUDA tensors.
    Returns what :func:`bvh_closest_hit_ordered_plain` returns with the
    same ``near_first``.  ``rows``, where given, replaces the pool's
    packed rows (another layout, for a variant of the kernel)."""
    _check_prim(prim)
    of, df, tm = _walk_rays(o, d, t_max)
    n = of.shape[0]
    out_t = torch.empty(n, dtype=torch.float32, device=of.device)
    out_i, vis, tst = (torch.empty(n, dtype=torch.int32, device=of.device)
                       for _ in range(3))
    stream = ctypes.c_void_p(torch.cuda.current_stream(of.device).cuda_stream)
    outs = (_ptr(out_t), _ptr(out_i), _ptr(vis), _ptr(tst), stream)
    layouts = _packed_layouts(scene, bvh, prim, rows)
    err = lib.solr_bvh_closest_packed(
        PRIMS.index(prim), int(near_first),
        *(_ptr(x) for x in layouts + (of, df, tm)), n, float(t_min), *outs)
    if err != 0:
        name = kernel_name("bvh_closest_hit", prim,
                           dfs=prim == "tri" and not near_first)
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    r_shape = o.shape[:-1]
    return tuple(x.reshape(r_shape) for x in (out_t, out_i, vis, tst))


def launch_transmittance(lib, scene, bvh: BVH, prim: str, o, d, t_min,
                         t_max, rows=None):
    """One launch of ``lib``'s shadow walk on CUDA tensors.  Returns
    what :func:`bvh_transmittance_plain` returns; ``rows`` as for
    :func:`launch_closest`."""
    _check_prim(prim)
    of, df, tm = _walk_rays(o, d, t_max)
    n = of.shape[0]
    out_tr = torch.empty(n, dtype=torch.float32, device=of.device)
    vis, tst = (torch.empty(n, dtype=torch.int32, device=of.device)
                for _ in range(2))
    stream = ctypes.c_void_p(torch.cuda.current_stream(of.device).cuda_stream)
    outs = (_ptr(out_tr), _ptr(vis), _ptr(tst), stream)
    layouts = _packed_layouts(scene, bvh, prim, rows)
    err = lib.solr_bvh_transmittance_packed(
        PRIMS.index(prim), *(_ptr(x) for x in layouts + (of, df, tm)), n,
        float(t_min), *outs)
    if err != 0:
        raise RuntimeError(f"{kernel_name('bvh_transmittance', prim)} kernel "
                           f"launch failed: cudaError {err}")
    r_shape = o.shape[:-1]
    return tuple(x.reshape(r_shape) for x in (out_tr, vis, tst))


def _pool_tensors(scene, prim: str, shadow: bool):
    """The scene tensors a walk reads: the pool's geometry, and for the
    shadow walk its materials' emission and transparency."""
    if prim == "tri":
        p = scene.triangles
        geo = (p.v0, p.v1, p.v2)
    elif prim == "sphere":
        p = scene.spheres
        geo = (p.center, p.radius)
    else:
        p = scene.cylinders
        geo = (p.p0, p.p1, p.radius)
    if shadow:
        geo += (scene.materials.emission, scene.materials.transparency)
    return geo


def _kernel_device(o) -> bool:
    """True for CUDA rays (the kernel), False for CPU ones (the plain
    version); other devices raise."""
    if o.device.type == "cpu":
        return False
    if o.device.type != "cuda":
        raise ValueError(f"no BVH walk kernel for device {o.device}")
    return True


def bvh_closest_hit(scene, bvh: BVH, pool_code: int, o, d, t_min,
                    t_max=T_FAR):
    """Closest hit within one BVH-accelerated pool (traverse.POOL_*
    code) for rays o, d (..., 3) and t_max, a number or of the rays'
    shape.  Returns (t, idx): T_FAR and idx 0 on a miss.  The walk's
    order is :func:`walks_near_first`'s.  Raises under grad mode on an
    input that requires grad (sweep.check_detached)."""
    prim = POOL_PRIM[pool_code]
    sweep.check_detached(kernel_name("bvh_closest_hit", prim), o, d, t_max,
                         *_pool_tensors(scene, prim, False))
    near = walks_near_first(scene, bvh, prim)
    if not _kernel_device(o):
        plain = (bvh_closest_hit_ordered_plain if near
                 else bvh_closest_hit_plain)
        return plain(scene, bvh, prim, o, d, t_min, t_max)[:2]
    out = launch_closest(_library(), scene, bvh, prim, o, d, t_min, t_max,
                         near_first=near)
    LAUNCHES[kernel_name("bvh_closest_hit", prim,
                         dfs=prim == "tri" and not near)] += 1
    return out[:2]


def bvh_transmittance(scene, bvh: BVH, pool_code: int, o, d, t_min, t_max):
    """Shadow transmittance in [0, 1] through one BVH-accelerated pool:
    the product over every occluder with t_min < t < t_max of its
    material's transparency, emissive primitives never occluding.
    Raises under grad mode on an input that requires grad."""
    prim = POOL_PRIM[pool_code]
    sweep.check_detached(kernel_name("bvh_transmittance", prim), o, d, t_max,
                         *_pool_tensors(scene, prim, True))
    if not _kernel_device(o):
        return bvh_transmittance_plain(scene, bvh, prim, o, d, t_min, t_max)[0]
    out = launch_transmittance(_library(), scene, bvh, prim, o, d, t_min,
                               t_max)
    LAUNCHES[kernel_name("bvh_transmittance", prim)] += 1
    return out[0]
