"""Helpers of the kernel tests: inputs with forced ties, the block
mirrors, and a CPU emulation of the CUDA kernels in
solr_tpu_torch/csrc/sweep.cu, bvh_walk.cu, gather.cu and procedural.cu.

The block mirrors (``tri_blocks_closest`` / ``tri_blocks_transmittance``)
test every ray of a tile against every block of the tile's candidate
list with the sweeps' block tests (``sweep.PRIM_T``), as the
reference's mirrors of the same names do: tests hold them to the
reference, and the exactness net to them.

The emulation compiles a kernel source with the host's C++ compiler
against a
stand-in for the CUDA runtime: one std::thread per CUDA thread, the
CTAs of a launch one after another, __syncthreads, __syncwarp and the
warp shuffles and matches as real barriers, cp.async as a plain copy,
atomicAdd under one lock, two multiprocessors, and shared memory filled
with NaN before each CTA.  It runs the kernels' own control flow (which
thread owns which lanes, the barriers, the slice combine, the early-out
and stop rules) on CPU tensors through the same C entry points, so the
tests can hold it to the plain PyTorch versions bit for bit.  It says
nothing of the card: its memory model, the nvcc build or speed.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import torch

from solr_tpu_torch.constants import T_FAR
from solr_tpu_torch.ops.sweep import PRIM_T

_RUNTIME = r"""
#pragma once
#include <stdint.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 threadIdx;
inline Dim3 emu_block_idx, blockDim, gridDim;
#define blockIdx emu_block_idx
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
using std::max;
using std::min;
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T> cudaError_t cudaFuncSetAttribute(T, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* value, int attr, int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? 2 : 0;
  return 0;
}

// A barrier that aborts the process instead of hanging when a thread
// never arrives (control flow that is not uniform where it must be).
struct EmuBarrier {
  explicit EmuBarrier(int n) : n(n) {}
  void wait() {
    std::unique_lock<std::mutex> l(m);
    const long g = gen;
    if (++count == n) { count = 0; ++gen; cv.notify_all(); return; }
    if (!cv.wait_for(l, std::chrono::seconds(60), [&] { return gen != g; })) {
      fprintf(stderr, "emulated barrier timed out\n");
      std::_Exit(3);
    }
  }
  std::mutex m;
  std::condition_variable cv;
  int n, count = 0;
  long gen = 0;
};
inline EmuBarrier* emu_cta;
inline std::vector<EmuBarrier*> emu_warps;
inline float emu_lanes[32][32];
inline double emu_lanes64[32][32];
inline int emu_keys[32][32];
inline long long emu_keys64[32][32];
inline std::mutex emu_atomic;
inline float* emu_smem;
inline void __syncthreads() { emu_cta->wait(); }
inline void __syncwarp() { emu_warps[threadIdx.x / 32]->wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_lanes[w][l] = v;
  emu_warps[w]->wait();
  const float r = emu_lanes[w][l ^ off];
  emu_warps[w]->wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_lanes[w][l] = v;
  emu_warps[w]->wait();
  const float r = emu_lanes[w][src];
  emu_warps[w]->wait();
  return r;
}
inline double __shfl_sync(unsigned, double v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_lanes64[w][l] = v;
  emu_warps[w]->wait();
  const double r = emu_lanes64[w][src];
  emu_warps[w]->wait();
  return r;
}
inline unsigned __match_any_sync(unsigned, long long v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_keys64[w][l] = v;
  emu_warps[w]->wait();
  unsigned peers = 0;
  for (int j = 0; j < 32; ++j)
    peers |= (emu_keys64[w][j] == v ? 1u : 0u) << j;
  emu_warps[w]->wait();
  return peers;
}
template <class T> inline T atomicAdd(T* p, T v) {
  std::lock_guard<std::mutex> l(emu_atomic);
  const T old = *p;
  *p = old + v;
  return old;
}
inline unsigned __match_any_sync(unsigned, int v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_keys[w][l] = v;
  emu_warps[w]->wait();
  unsigned peers = 0;
  for (int j = 0; j < 32; ++j) peers |= (emu_keys[w][j] == v ? 1u : 0u) << j;
  emu_warps[w]->wait();
  return peers;
}
inline void emu_launch(unsigned grid, unsigned block, int64_t smem,
                       const std::function<void()>& body) {
  std::vector<float> buf(smem / 4 + 4);
  emu_smem = buf.data();
  blockDim.x = block;
  gridDim.x = grid;
  for (unsigned b = 0; b < grid; ++b) {
    emu_block_idx.x = b;
    std::fill(buf.begin(), buf.end(), NAN);
    EmuBarrier cta(block);
    emu_cta = &cta;
    std::deque<EmuBarrier> warps;
    emu_warps.clear();
    for (unsigned w = 0; w < block / 32; ++w) {
      warps.emplace_back(32);
      emu_warps.push_back(&warps.back());
    }
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([&, t] { threadIdx.x = t; body(); });
    for (auto& t : threads) t.join();
  }
}
"""


def emulated_source(src: str) -> str:
    """``src`` (a source of solr_tpu_torch/csrc/) rewritten for the stand-in
    runtime: launches call emu_launch, cp.async copies at once, the
    dynamic shared array is the emulator's buffer."""
    def launch(m):
        grid, block, smem = (x.strip() for x in m.group(2).split(",")[:3])
        return (f"emu_launch({grid}, {block}, {smem}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")

    out, n = re.subn(r"([\w<>]+)<<<(.*?)>>>\((.*?)\);", launch, src,
                     flags=re.S)
    assert n >= 2, "kernel launches not found"
    for size in (16, 4) if "cp.async" in src else ():
        out, n = re.subn(
            rf'asm volatile\("cp\.async\.\w+\.shared\.global \[%0\], '
            rf'\[%1\], {size};\\n" ::"r"\(s\),\s*"l"\(src\)\);',
            f"memcpy(dst, src, {size}); (void)s;", out)
        assert n == 1, f"cp.async of {size} bytes not found"
    out = re.sub(r"asm volatile\(.*?\);", ";", out, flags=re.S)
    out = out.replace("__cvta_generic_to_shared(dst)", "0")
    out = out.replace("extern __shared__ __align__(16) float smem[];",
                      "float* smem = emu_smem;")
    out = out.replace(
        "extern __shared__ __align__(16) unsigned char smem_bytes[];",
        "unsigned char* smem_bytes = reinterpret_cast<unsigned char*>("
        "emu_smem);")
    assert "__shared__" not in out, "static shared memory is not emulated"
    return out


def compiler():
    return shutil.which("g++") or shutil.which("c++")


def build_emulated(src_path: Path, out_dir: Path) -> Path:
    """Compile the emulation of ``src_path`` into ``out_dir``; returns the
    shared library's path."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "cuda_runtime.h").write_text(_RUNTIME)
    cpp = out_dir / f"{src_path.stem}_emulated.cpp"
    cpp.write_text(emulated_source(src_path.read_text()))
    lib = out_dir / f"lib{src_path.stem}_emulated.so"
    res = subprocess.run(
        [compiler(), "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
         "-fPIC", "-Wno-unknown-pragmas", f"-I{out_dir}", "-o", str(lib),
         str(cpp), "-lpthread"], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"emulation build failed:\n{res.stderr}")
    return lib


def forced_ties(packed, cand, counts, nearb=None):
    """Forced ties: lanes [h, 2h) of every block repeat lanes [0, h), and
    each listed block b is followed in its list by b + NB, a copy of it
    (the list cut at K).  Strip 0 of tile 0 gets an empty list, every
    strip of tile 1 a K-long one (blocks in id order, entry bounds 0).
    Returns (packed, cand, counts) and, given ``nearb``, the new entry
    bounds."""
    nb_, _, block = packed.shape
    h = block // 2
    p = packed.clone()
    p[:, :, h:2 * h] = p[:, :, :h]
    p = torch.cat([p, p])
    s, g, k = cand.shape
    c = torch.stack([cand, cand + nb_], -1).reshape(s, g, 2 * k)[..., :k]
    n = (counts * 2).clamp(max=k)
    n[0, 0] = 0
    n[1] = k
    c[1] = torch.arange(k, device=c.device).remainder(2 * nb_)
    out = [p, c.to(torch.int32).contiguous(), n.to(torch.int32)]
    if nearb is not None:
        nbd = torch.stack([nearb, nearb], -1).reshape(s, g, 2 * k)[..., :k]
        nbd[1] = 0.0
        out.append(nbd.contiguous())
    return out


# Candidate blocks evaluated per step of the block mirrors (bounds the
# (T, TR, chunk, block) intermediates).
_MIRROR_CHUNK = 16


def tri_blocks_closest(packed, o_t, d_t, cand, counts, t_min,
                       prim: str = "tri"):
    """Closest hit of every ray against its tile's candidate blocks.

    packed (B, 16, block) rows of kind ``prim``; o_t/d_t (T, TR, 3);
    cand (T, K) block ids; counts (T,).  Returns (t (T, TR), prim idx
    (T, TR), -1 on a miss).
    Ties go to the earliest candidate, then the lowest lane, as in the
    reference's sequential scan: the first minimum of each flattened
    (candidate, lane) chunk is exactly that order.
    """
    block = packed.shape[2]
    k_max = cand.shape[1]
    best_t = torch.full(o_t.shape[:2], T_FAR, dtype=o_t.dtype, device=o_t.device)
    best_i = torch.full(o_t.shape[:2], -1, dtype=torch.int32, device=o_t.device)
    ks = torch.arange(k_max, device=o_t.device)
    for k0 in range(0, k_max, _MIRROR_CHUNK):
        kc = cand[:, k0:k0 + _MIRROR_CHUNK].long()  # (T, C)
        w = packed[kc]  # (T, C, 16, block)
        t = PRIM_T[prim](o_t[:, None], d_t[:, None], w, t_min)  # (T, C, TR, block)
        ok = ks[k0:k0 + kc.shape[1]][None] < counts[:, None]  # (T, C)
        t = torch.where(ok[:, :, None, None], t, torch.full_like(t, T_FAR))
        t = t.permute(0, 2, 1, 3).reshape(t.shape[0], t.shape[2], -1)
        c_min, flat = t.min(-1)
        blk = torch.gather(kc, 1, flat // block)
        c_idx = (blk * block + flat % block).to(torch.int32)
        better = c_min < best_t
        best_t = torch.where(better, c_min, best_t)
        best_i = torch.where(better, c_idx, best_i)
    return best_t, best_i


def tri_blocks_transmittance(packed, o_t, d_t, t_max_t, cand, counts, t_min,
                             prim: str = "tri"):
    """Shadow transmittance of every ray through its tile's candidate
    blocks: the product of the row-15 factor of every primitive hit with
    t < t_max.  (T, TR) in [0, 1]."""
    k_max = cand.shape[1]
    trans = torch.ones(o_t.shape[:2], dtype=o_t.dtype, device=o_t.device)
    ks = torch.arange(k_max, device=o_t.device)
    for k0 in range(0, k_max, _MIRROR_CHUNK):
        kc = cand[:, k0:k0 + _MIRROR_CHUNK].long()
        w = packed[kc]  # (T, C, 16, block)
        t = PRIM_T[prim](o_t[:, None], d_t[:, None], w, t_min)
        ok = ks[k0:k0 + kc.shape[1]][None] < counts[:, None]
        occ = (t < t_max_t[:, None, :, None]) & ok[:, :, None, None]
        f = torch.where(occ, w[:, :, None, 15, :], torch.ones_like(t))
        trans = trans * f.prod(-1).prod(1)
    return trans
