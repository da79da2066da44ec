"""Per-strip interval sweeps over candidate triangle blocks: the kernels
of the slice (counterpart of solr_tpu/ops/pallas_kernels.py).

Each entry point has a plain PyTorch version and a wrapper:

* ``sweep_closest`` (replaces ``sweep_closest`` / ``_closest_kernel`` at
  solr_tpu/ops/pallas_kernels.py:175): for each 32-ray strip, walk its
  candidate blocks front to back, run the Woop test on every triangle
  with t > t_min, keep the block minimum (lowest prim id on a tie) and
  replace the ray's best only when strictly smaller; skip a candidate
  once its entry bound ``nearb`` is not below the strip's ``done``
  bound, the max over its live rays of min(best t, box exit).
* ``sweep_transmittance`` (replaces ``sweep_transmittance`` /
  ``_trans_kernel`` at pallas_kernels.py:255): for each strip, multiply
  into every ray the row-15 factor of each triangle hit with
  t_min < t < t_max; stop a strip, between blocks, once the max of its
  live rays' transmittance is <= 1e-6.

Both also count strip visits per tile.  The wrappers dispatch on the
device of the tensors: CPU tensors go to the plain version, CUDA tensors
to the hand-written kernels in ``solr_tpu_torch/csrc/sweep.cu``, which
are built with nvcc at first use and loaded with ctypes.  A build or
launch failure raises; nothing falls back to the plain version.  The
plain and kernel versions agree bit for bit on the same device: same
Woop association, no FMA contraction, the same tie rules and product
order (ascending lanes within a block).

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
from solr_tpu_torch.ops.packet import STRIP, _masked_max, _woop_t

__all__ = [
    "LAUNCHES",
    "build",
    "sweep_closest",
    "sweep_closest_plain",
    "sweep_transmittance",
    "sweep_transmittance_plain",
]

# Kernel launch counts, one per wrapper; incremented only where the
# wrapper launches its kernel.
LAUNCHES = {"sweep_closest": 0, "sweep_transmittance": 0}

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
                        t_min):
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
        t = _woop_t(o[rows], d[rows], packed[blk], t_min)  # (R, ssb, block)
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
                              t_min):
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
        t = _woop_t(o[rows], d[rows], w, t_min)
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


def build(verbose: bool = False) -> str:
    """Compile ``csrc/sweep.cu`` for sm_90a (once per source and flag
    set) and load it.  Returns the compiler's output when it built, ''
    when the library was already there.  Raises on any failure."""
    global _lib
    with _lock:
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = _BUILD_DIR / f"libsolr_sweep_{tag}.so"
        log = ""
        if not out.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
                + ["-o", str(tmp), str(_SRC)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
            os.replace(tmp, out)
            log = res.stdout + res.stderr
        if _lib is None:
            lib = ctypes.CDLL(str(out))
            vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                                 ctypes.c_float)
            lib.solr_sweep_closest.argtypes = [
                vp, i32, vp, vp, vp, vp, vp, vp, vp, i64, i32, f32, vp, vp, vp, vp]
            lib.solr_sweep_closest.restype = i32
            lib.solr_sweep_transmittance.argtypes = [
                vp, i32, vp, vp, vp, vp, vp, vp, i64, i32, f32, vp, vp, vp]
            lib.solr_sweep_transmittance.restype = i32
            _lib = lib
        return log


def _library():
    if _lib is None:
        build()
    return _lib


def _check_inputs(packed, o_t, d_t, ray_vals, live, cand, counts, nearb=None):
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


def sweep_closest(packed, o_t, d_t, t_cap, live, cand, counts, nearb, t_min):
    """Closest hit over per-strip front-to-back candidate lists.

    packed (NB, 16, block); o_t/d_t (S, SB, 3); t_cap (S, SB) per-ray box
    exit; live (S, SB) bool; cand (S, G, K) block ids per strip sorted by
    entry; counts (S, G); nearb (S, G, K) ascending entry bounds.
    Returns (t (S, SB), prim idx (S, SB), -1 on a miss, visits (S,)).
    """
    if packed.device.type == "cpu":
        return sweep_closest_plain(packed, o_t, d_t, t_cap, live, cand,
                                   counts, nearb, t_min)
    if packed.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {packed.device}")
    _check_inputs(packed, o_t, d_t, t_cap, live, cand, counts, nearb)
    lib = _library()
    s, sb = o_t.shape[:2]
    g, k_max = cand.shape[1:]
    ins = (_f32(packed), _f32(o_t), _f32(d_t), _f32(t_cap),
           live.to(torch.uint8).contiguous(), _i32(cand), _i32(counts),
           _f32(nearb))
    out_t = torch.empty((s, sb), dtype=torch.float32, device=packed.device)
    out_i = torch.empty((s, sb), dtype=torch.int32, device=packed.device)
    out_v = torch.empty((s, g), dtype=torch.int32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.solr_sweep_closest(
        _ptr(ins[0]), packed.shape[2], *(_ptr(x) for x in ins[1:]),
        s * g, k_max, float(t_min), _ptr(out_t), _ptr(out_i), _ptr(out_v),
        ctypes.c_void_p(stream))
    _raise_on(err, "sweep_closest")
    LAUNCHES["sweep_closest"] += 1
    return out_t, out_i, out_v.sum(1, dtype=torch.int32)


def sweep_transmittance(packed, o_t, d_t, t_max, live, cand, counts, t_min):
    """Shadow transmittance over per-strip candidate lists.

    t_max (S, SB) per-ray segment length; other arguments as for
    :func:`sweep_closest`.  Returns (tr (S, SB) in [0, 1], visits (S,)).
    """
    if packed.device.type == "cpu":
        return sweep_transmittance_plain(packed, o_t, d_t, t_max, live, cand,
                                         counts, t_min)
    if packed.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {packed.device}")
    _check_inputs(packed, o_t, d_t, t_max, live, cand, counts)
    lib = _library()
    s, sb = o_t.shape[:2]
    g, k_max = cand.shape[1:]
    ins = (_f32(packed), _f32(o_t), _f32(d_t), _f32(t_max),
           live.to(torch.uint8).contiguous(), _i32(cand), _i32(counts))
    out_tr = torch.empty((s, sb), dtype=torch.float32, device=packed.device)
    out_v = torch.empty((s, g), dtype=torch.int32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.solr_sweep_transmittance(
        _ptr(ins[0]), packed.shape[2], *(_ptr(x) for x in ins[1:]),
        s * g, k_max, float(t_min), _ptr(out_tr), _ptr(out_v),
        ctypes.c_void_p(stream))
    _raise_on(err, "sweep_transmittance")
    LAUNCHES["sweep_transmittance"] += 1
    return out_tr, out_v.sum(1, dtype=torch.int32)
