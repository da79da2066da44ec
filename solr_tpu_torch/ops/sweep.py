"""Per-strip interval sweeps over candidate primitive blocks: the
kernels of the port (counterpart of solr_tpu/ops/pallas_kernels.py).

Each entry point has a plain PyTorch version and a wrapper, and takes
``prim``, the kind of the packed rows: "tri" (Woop rows,
packet.block_pack), "sphere" (packet.sphere_pack) or "cyl"
(packet.cylinder_pack):

* ``sweep_closest`` (replaces ``sweep_closest`` / ``_closest_kernel`` at
  solr_tpu/ops/pallas_kernels.py:175 with ``_woop_rows`` :108,
  ``_sphere_rows`` :136 or ``_cyl_rows`` :158): for each 32-ray strip,
  walk its candidate blocks front to back, test every primitive with
  t > t_min, keep the block minimum (lowest prim id on a tie) and
  replace the ray's best only when strictly smaller; skip a candidate
  once its entry bound ``nearb`` is not below the strip's ``done``
  bound, the max over its live rays of min(best t, box exit).
* ``sweep_transmittance`` (replaces ``sweep_transmittance`` /
  ``_trans_kernel`` at pallas_kernels.py:255 with the same bodies): for
  each strip, multiply into every ray the row-15 factor of each
  primitive hit with t_min < t < t_max; stop a strip, between blocks,
  once the max of its live rays' transmittance is <= 1e-6.

Both also count strip visits per tile.  The wrappers dispatch on the
device of the tensors: CPU tensors go to the plain version, CUDA tensors
to the hand-written kernels in ``solr_tpu_torch/csrc/sweep.cu``, which
are built with nvcc at first use and loaded with ctypes.  A build or
launch failure raises, and so does a BLOCK whose rows do not fit the
shared memory of the kernel it would run (every kernel stages them
there, and takes its strips longest list first); nothing falls back to
the plain version.  The plain and kernel
versions agree bit for bit on the same device: the same association in
every primitive test, no FMA contraction, IEEE sqrt and division, the
same tie rules and product order (ascending lanes within a block).

Rays are passed directly as o_t/d_t (S, SB, 3), t_cap or t_max (S, SB)
and live (S, SB); SB / G must be 32 for the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from solr_tpu_torch.constants import T_FAR
from solr_tpu_torch.ops.packet import PRIM_T, STRIP, _masked_max

__all__ = [
    "LAUNCHES",
    "PRIMS",
    "build",
    "check_detached",
    "compile_library",
    "kernel_name",
    "kernel_shape",
    "launch_closest",
    "launch_order",
    "launch_transmittance",
    "load_library",
    "longest_first",
    "sweep_closest",
    "sweep_closest_plain",
    "sweep_transmittance",
    "sweep_transmittance_plain",
]

# Primitive kinds in the order of their codes in csrc/sweep.cu.
PRIMS = ("tri", "sphere", "cyl")


def kernel_name(entry: str, prim: str) -> str:
    """The name of one kernel: the entry point, suffixed by the primitive
    kind except for triangles ("sweep_closest", "sweep_closest_sphere",
    ...)."""
    return entry if prim == "tri" else f"{entry}_{prim}"


# Kernel launch counts, one per kernel (entry point x primitive kind);
# incremented only where a wrapper launches that kernel.
LAUNCHES = {kernel_name(e, p): 0 for p in PRIMS
            for e in ("sweep_closest", "sweep_transmittance")}

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "sweep.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "solr_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
]

_lib = None
_lock = threading.Lock()


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def _strips(o_t, d_t, ray_vals, live, g):
    s, sb = o_t.shape[:2]
    ssb = sb // g
    return (o_t.reshape(s * g, ssb, 3), d_t.reshape(s * g, ssb, 3),
            ray_vals.reshape(s * g, ssb), live.reshape(s * g, ssb).bool())


def sweep_closest_plain(packed, o_t, d_t, t_cap, live, cand, counts, nearb,
                        t_min, prim: str = "tri"):
    """Plain PyTorch closest-hit sweep; any strip width.  Returns
    (t (S, SB), prim idx (S, SB) with -1 on a miss, visits (S,))."""
    s, sb = o_t.shape[:2]
    _, g, k_max = cand.shape
    block = packed.shape[2]
    o, d, cap, lv = _strips(o_t, d_t, t_cap, live, g)
    c = cand.reshape(s * g, k_max).long()
    n = counts.reshape(s * g)
    nb = nearb.reshape(s * g, k_max)
    best_t = torch.full(cap.shape, T_FAR, dtype=o.dtype, device=o.device)
    best_i = torch.full(cap.shape, -1, dtype=torch.int32, device=o.device)
    done = _masked_max(cap, lv)
    visits = torch.zeros(s * g, dtype=torch.int32, device=o.device)
    for k in range(k_max):
        rows = ((k < n) & (nb[:, k] < done)).nonzero().squeeze(1)
        if rows.numel() == 0:
            if not bool((k < n).any()):
                break
            continue
        blk = c[rows, k]
        t = PRIM_T[prim](o[rows], d[rows], packed[blk], t_min)  # (R, ssb, block)
        c_min, lane = t.min(-1)
        bt = best_t[rows]
        better = c_min < bt
        bt = torch.where(better, c_min, bt)
        best_t[rows] = bt
        best_i[rows] = torch.where(
            better, (blk[:, None] * block + lane).to(torch.int32), best_i[rows])
        done[rows] = _masked_max(torch.minimum(bt, cap[rows]), lv[rows])
        visits[rows] += 1
    return (best_t.reshape(s, sb), best_i.reshape(s, sb),
            visits.reshape(s, g).sum(1, dtype=torch.int32))


def _lane_ordered_product(occ, f):
    """Product over lanes, in ascending lane order, of ``f`` (R, block)
    where ``occ`` (R, ssb, block); 1 elsewhere.  Multiplying by 1 is
    exact, so the ordered product over the occluding lanes alone is the
    ordered product over all lanes."""
    r, ssb, block = occ.shape
    p = torch.ones((r, ssb), dtype=f.dtype, device=f.device)
    m = int(occ.sum(-1).max()) if occ.numel() else 0
    if m == 0:
        return p
    lanes = torch.arange(block, device=f.device).expand_as(occ)
    lanes = torch.where(occ, lanes, torch.full_like(lanes, block))
    first = torch.topk(lanes, m, dim=-1, largest=False, sorted=True).values
    first = torch.sort(first, dim=-1).values  # ascending, whatever topk gives
    f1 = torch.cat([f, torch.ones((r, 1), dtype=f.dtype, device=f.device)], -1)
    fm = torch.gather(f1[:, None, :].expand(r, ssb, block + 1), -1, first)
    for i in range(m):
        p = p * fm[..., i]
    return p


def sweep_transmittance_plain(packed, o_t, d_t, t_max, live, cand, counts,
                              t_min, prim: str = "tri"):
    """Plain PyTorch shadow sweep; any strip width.  Returns
    (tr (S, SB) in [0, 1], visits (S,))."""
    s, sb = o_t.shape[:2]
    _, g, k_max = cand.shape
    o, d, tm, lv = _strips(o_t, d_t, t_max, live, g)
    c = cand.reshape(s * g, k_max).long()
    n = counts.reshape(s * g)
    tr = torch.ones(tm.shape, dtype=o.dtype, device=o.device)
    lit = lv.to(o.dtype).amax(1)
    visits = torch.zeros(s * g, dtype=torch.int32, device=o.device)
    for k in range(k_max):
        rows = ((k < n) & (lit > 1e-6)).nonzero().squeeze(1)
        if rows.numel() == 0:
            break  # a strip that stops never resumes
        w = packed[c[rows, k]]
        t = PRIM_T[prim](o[rows], d[rows], w, t_min)
        p = _lane_ordered_product(t < tm[rows][..., None], w[:, 15, :])
        new = tr[rows] * p
        tr[rows] = new
        lit[rows] = _masked_max(new, lv[rows])
        visits[rows] += 1
    return tr.reshape(s, sb), visits.reshape(s, g).sum(1, dtype=torch.int32)


# --------------------------------------------------------------------------
# CUDA build and wrappers
# --------------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the sweep kernels need the CUDA toolkit")


def compile_library(src: bytes, stem: str = "libsolr_sweep",
                    verbose: bool = False):
    """Compile the CUDA source ``src`` for sm_90a into
    ``build/solr_tpu_torch/{stem}_{hash}.so``, unless it is there.
    Returns (path, the compiler's output or '')."""
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"{stem}_{tag}.so"
    if out.exists():
        return out, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = out.with_suffix(f".{os.getpid()}.cu")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cu.write_bytes(src)
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", str(tmp), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    cu.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def load_library(path):
    """Load a compiled sweep library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    lib.solr_sweep_closest.argtypes = [
        i32, vp, i32, vp, vp, vp, vp, vp, vp, vp, vp, i64, i32, f32, vp, vp,
        vp, vp]
    lib.solr_sweep_closest.restype = i32
    lib.solr_sweep_transmittance.argtypes = [
        i32, vp, i32, vp, vp, vp, vp, vp, vp, vp, i64, i32, f32, vp, vp, vp]
    lib.solr_sweep_transmittance.restype = i32
    lib.solr_sweep_order.argtypes = [vp, i64, i32, vp, vp]
    lib.solr_sweep_order.restype = i32
    lib.solr_sweep_warps.argtypes = [i32, i32]
    lib.solr_sweep_warps.restype = i32
    lib.solr_sweep_smem_bytes.argtypes = [i32, i32, i32]
    lib.solr_sweep_smem_bytes.restype = i64
    lib.solr_sweep_smem_limit.argtypes = []
    lib.solr_sweep_smem_limit.restype = i64
    return lib


def build(verbose: bool = False) -> str:
    """Compile ``csrc/sweep.cu`` for sm_90a (once per source and flag
    set) and load it.  Returns the compiler's output when it built, ''
    when the library was already there.  Raises on any failure."""
    global _lib
    with _lock:
        path, log = compile_library(_SRC.read_bytes(), verbose=verbose)
        if _lib is None:
            _lib = load_library(path)
        return log


def _library():
    if _lib is None:
        build()
    return _lib


def check_detached(name: str, *tensors):
    """Raise if grad mode is on and any of ``tensors`` requires grad.

    The differentiability contract: traversal runs detached and the hit
    distance is recomputed with autograd afterwards, so no kernel needs
    a backward pass.  A kernel wrapper called on a tensor that requires
    grad, with grad mode on, breaks that contract; this guard says so
    rather than returning a result with no gradient."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() on "
            f"detached tensors (traversal runs detached, the hit distance "
            f"is recomputed with autograd)")


def _check_inputs(packed, o_t, d_t, ray_vals, live, cand, counts, prim,
                  nearb=None):
    if prim not in PRIMS:
        raise ValueError(f"prim must be one of {PRIMS}, got {prim!r}")
    s, sb = o_t.shape[:2]
    g = cand.shape[1]
    if sb != g * STRIP:
        raise ValueError(f"the sweep kernels take {STRIP}-ray strips; got "
                         f"{sb} rays per tile in {g} strips")
    dev = packed.device
    for name, x in (("o_t", o_t), ("d_t", d_t), ("ray values", ray_vals),
                    ("live", live), ("cand", cand), ("counts", counts)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, packed on {dev}")
    if packed.dtype != torch.float32 or packed.dim() != 3 or packed.shape[1] != 16:
        raise ValueError("packed must be (NB, 16, block) float32")
    if o_t.shape != (s, sb, 3) or d_t.shape != (s, sb, 3) \
            or ray_vals.shape != (s, sb) or live.shape != (s, sb):
        raise ValueError("ray tensors must be (S, SB, 3) and (S, SB)")
    if cand.dim() != 3 or cand.shape[0] != s or counts.shape != (s, g):
        raise ValueError("cand must be (S, G, K) and counts (S, G)")
    if nearb is not None and (nearb.shape != cand.shape or nearb.device != dev):
        raise ValueError("nearb must be (S, G, K) on the device of packed")


def _f32(x):
    return x.to(torch.float32).contiguous()


def _i32(x):
    return x.to(torch.int32).contiguous()


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _check_smem(lib, closest: bool, prim: str, block: int):
    """Raise if the rows of ``block`` primitives do not fit the shared
    memory of the kernel that the entry runs for ``prim``."""
    need = lib.solr_sweep_smem_bytes(int(closest), PRIMS.index(prim), block)
    limit = lib.solr_sweep_smem_limit()
    if need < 0 or need > limit:
        entry = "sweep_closest" if closest else "sweep_transmittance"
        raise ValueError(f"block={block} needs {need} bytes of shared memory "
                         f"for {kernel_name(entry, prim)}; the card allows "
                         f"{limit}")


def kernel_shape(entry: str, prim: str, block: int, lib=None) -> dict:
    """The kernel that ``entry`` runs for ``prim`` in ``lib`` (default:
    the built ``csrc/sweep.cu``): its design, "staged" (one CTA of
    ``warps_per_cta`` warps per strip), and the dynamic shared memory it
    takes at this ``block``, in bytes."""
    lib = lib or _library()
    closest, code = int(entry == "sweep_closest"), PRIMS.index(prim)
    return dict(design="staged",
                warps_per_cta=lib.solr_sweep_warps(closest, code),
                smem_bytes=lib.solr_sweep_smem_bytes(closest, code, block))


def longest_first(counts):
    """The kernels' launch order, plain version: strip ids (int32) by
    descending list length, equal lengths in id order (a stable sort),
    so that the strips that take longest start first.
    The kernels' entries compute it on the card (:func:`launch_order`)."""
    return torch.argsort(counts.reshape(-1), descending=True,
                         stable=True).to(torch.int32)


def launch_order(lib, counts, k_max: int):
    """The order kernel that every launch of ``lib`` runs first, alone,
    on CUDA ``counts`` (S, G) with entries in [0, ``k_max``]: what
    :func:`longest_first` returns."""
    counts = _i32(counts)
    order = torch.empty(counts.numel(), dtype=torch.int32,
                        device=counts.device)
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    _raise_on(lib.solr_sweep_order(_ptr(counts), counts.numel(), k_max,
                                   _ptr(order), ctypes.c_void_p(stream)),
              "launch order")
    return order


def launch_closest(lib, packed, o_t, d_t, t_cap, live, cand, counts, nearb,
                   t_min, prim: str = "tri"):
    """One launch of ``lib``'s closest-hit kernel on CUDA tensors checked
    by the caller; the kernel takes its strips in :func:`longest_first`
    order.  Returns what :func:`sweep_closest` returns."""
    s, sb = o_t.shape[:2]
    g, k_max = cand.shape[1:]
    ins = (_f32(packed), _f32(o_t), _f32(d_t), _f32(t_cap),
           live.to(torch.uint8).contiguous(), _i32(cand), _i32(counts),
           _f32(nearb), torch.empty(s * g, dtype=torch.int32,
                                    device=packed.device))
    out_t = torch.empty((s, sb), dtype=torch.float32, device=packed.device)
    out_i = torch.empty((s, sb), dtype=torch.int32, device=packed.device)
    out_v = torch.empty((s, g), dtype=torch.int32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.solr_sweep_closest(
        PRIMS.index(prim), _ptr(ins[0]), packed.shape[2],
        *(_ptr(x) for x in ins[1:]), s * g, k_max, float(t_min), _ptr(out_t),
        _ptr(out_i), _ptr(out_v), ctypes.c_void_p(stream))
    _raise_on(err, kernel_name("sweep_closest", prim))
    return out_t, out_i, out_v.sum(1, dtype=torch.int32)


def launch_transmittance(lib, packed, o_t, d_t, t_max, live, cand, counts,
                         t_min, prim: str = "tri"):
    """One launch of ``lib``'s shadow kernel on CUDA tensors checked by
    the caller; the kernel takes its strips in :func:`longest_first`
    order.  Returns what :func:`sweep_transmittance` returns."""
    s, sb = o_t.shape[:2]
    g, k_max = cand.shape[1:]
    ins = (_f32(packed), _f32(o_t), _f32(d_t), _f32(t_max),
           live.to(torch.uint8).contiguous(), _i32(cand), _i32(counts),
           torch.empty(s * g, dtype=torch.int32, device=packed.device))
    out_tr = torch.empty((s, sb), dtype=torch.float32, device=packed.device)
    out_v = torch.empty((s, g), dtype=torch.int32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.solr_sweep_transmittance(
        PRIMS.index(prim), _ptr(ins[0]), packed.shape[2],
        *(_ptr(x) for x in ins[1:]), s * g, k_max, float(t_min), _ptr(out_tr),
        _ptr(out_v), ctypes.c_void_p(stream))
    _raise_on(err, kernel_name("sweep_transmittance", prim))
    return out_tr, out_v.sum(1, dtype=torch.int32)


def sweep_closest(packed, o_t, d_t, t_cap, live, cand, counts, nearb, t_min,
                  prim: str = "tri"):
    """Closest hit over per-strip front-to-back candidate lists.

    packed (NB, 16, block) rows of kind ``prim``; o_t/d_t (S, SB, 3);
    t_cap (S, SB) per-ray box exit; live (S, SB) bool; cand (S, G, K)
    block ids per strip sorted by entry; counts (S, G); nearb (S, G, K)
    ascending entry bounds.  Returns (t (S, SB), prim idx (S, SB), -1 on
    a miss, visits (S,)).  Raises under grad mode on an input that
    requires grad (:func:`check_detached`).
    """
    check_detached(kernel_name("sweep_closest", prim), packed, o_t, d_t,
                   t_cap, nearb)
    if packed.device.type == "cpu":
        return sweep_closest_plain(packed, o_t, d_t, t_cap, live, cand,
                                   counts, nearb, t_min, prim)
    if packed.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {packed.device}")
    _check_inputs(packed, o_t, d_t, t_cap, live, cand, counts, prim, nearb)
    lib = _library()
    _check_smem(lib, True, prim, packed.shape[2])
    out = launch_closest(lib, packed, o_t, d_t, t_cap, live, cand, counts,
                         nearb, t_min, prim)
    LAUNCHES[kernel_name("sweep_closest", prim)] += 1
    return out


def sweep_transmittance(packed, o_t, d_t, t_max, live, cand, counts, t_min,
                        prim: str = "tri"):
    """Shadow transmittance over per-strip candidate lists.

    t_max (S, SB) per-ray segment length; other arguments as for
    :func:`sweep_closest`.  Returns (tr (S, SB) in [0, 1], visits (S,)).
    Raises under grad mode on an input that requires grad.
    """
    check_detached(kernel_name("sweep_transmittance", prim), packed, o_t,
                   d_t, t_max)
    if packed.device.type == "cpu":
        return sweep_transmittance_plain(packed, o_t, d_t, t_max, live, cand,
                                         counts, t_min, prim)
    if packed.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {packed.device}")
    _check_inputs(packed, o_t, d_t, t_max, live, cand, counts, prim)
    lib = _library()
    _check_smem(lib, False, prim, packed.shape[2])
    out = launch_transmittance(lib, packed, o_t, d_t, t_max, live, cand,
                               counts, t_min, prim)
    LAUNCHES[kernel_name("sweep_transmittance", prim)] += 1
    return out
