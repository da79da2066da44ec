// Per-strip interval sweeps over candidate triangle blocks, for Hopper
// (sm_90a).  Built by nvcc into a shared library with a plain C
// interface and bound with ctypes (solr_tpu_torch/ops/sweep.py).
//
// Replaces the Pallas TPU kernels of solr_tpu/ops/pallas_kernels.py:
//   solr_sweep_closest       <- sweep_closest / _closest_kernel + _woop_rows
//   solr_sweep_transmittance <- sweep_transmittance / _trans_kernel + _woop_rows
// (prim="tri").  They compute what those compute; they are not the
// Pallas grid carried over.
//
// Mapping: one warp per 32-ray strip, one thread per ray.  The warp
// walks its strip's candidate list; every thread scans the block's
// `block` triangles in ascending lane order.  The block's packed rows
// are read at warp-uniform addresses, so each load is one broadcast
// transaction served from L1 (a block's 12 Woop rows are 24 KB at
// block=512).  What bounds the kernel on this card: the Woop
// arithmetic, about 40 instructions per (ray, triangle) pair, issued
// by one thread per ray; the slab bytes are small next to it.  A strip
// whose list is empty returns at once, which is what makes the parked
// tiles of later bounces cost nothing.
//
// Exactness with the plain PyTorch version (sweep.py):
//   * build with --fmad=false and without fast math: the Woop chains
//     keep the association ((ox*r0 + oy*r1) + oz*r2) + r3 and every
//     product rounds on its own, as PyTorch's separate elementwise ops
//     do; 1/dpz is the IEEE quotient;
//   * closest hit: strict `<` in ascending lane order gives the lowest
//     lane among equal t; across blocks a hit replaces the best only
//     when strictly smaller, so the earlier candidate wins a tie;
//   * transmittance: the block's factors multiply in ascending lane
//     order, then the strip's running product takes the block product;
//     the <= 1e-6 stop is checked between blocks only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 32;
constexpr int kWarpsPerBlock = 4;
constexpr float kTFar = 3.0e38f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Woop test of one ray against lane `l` of a packed block (rows of
// length `block`, row-major).  Mirrors packet._woop_t operation for
// operation.
__device__ __forceinline__ float woop_t(const Ray& r,
                                        const float* __restrict__ w,
                                        int block, int l, float t_min) {
  const float r0 = __ldg(w + 0 * block + l), r1 = __ldg(w + 1 * block + l);
  const float r2 = __ldg(w + 2 * block + l), r3 = __ldg(w + 3 * block + l);
  const float r4 = __ldg(w + 4 * block + l), r5 = __ldg(w + 5 * block + l);
  const float r6 = __ldg(w + 6 * block + l), r7 = __ldg(w + 7 * block + l);
  const float r8 = __ldg(w + 8 * block + l), r9 = __ldg(w + 9 * block + l);
  const float r10 = __ldg(w + 10 * block + l);
  const float r11 = __ldg(w + 11 * block + l);
  const float opx = ((r.ox * r0 + r.oy * r1) + r.oz * r2) + r3;
  const float opy = ((r.ox * r4 + r.oy * r5) + r.oz * r6) + r7;
  const float opz = ((r.ox * r8 + r.oy * r9) + r.oz * r10) + r11;
  const float dpx = (r.dx * r0 + r.dy * r1) + r.dz * r2;
  const float dpy = (r.dx * r4 + r.dy * r5) + r.dz * r6;
  const float dpz = (r.dx * r8 + r.dy * r9) + r.dz * r10;
  const bool safe = fabsf(dpz) > 1e-12f;
  const float inv = safe ? 1.0f / dpz : 0.0f;
  const float t = (-opz) * inv;
  const float u = opx + t * dpx;
  const float v = opy + t * dpy;
  const bool valid =
      safe && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > t_min);
  return valid ? t : kTFar;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        int64_t ray) {
  Ray r;
  r.ox = o[3 * ray + 0]; r.oy = o[3 * ray + 1]; r.oz = o[3 * ray + 2];
  r.dx = d[3 * ray + 0]; r.dy = d[3 * ray + 1]; r.dz = d[3 * ray + 2];
  return r;
}

__global__ void __launch_bounds__(kStrip * kWarpsPerBlock)
closest_kernel(const float* __restrict__ packed, int block,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_cap,
               const uint8_t* __restrict__ live,
               const int32_t* __restrict__ cand,
               const int32_t* __restrict__ counts,
               const float* __restrict__ nearb, int64_t n_strips, int k_max,
               float t_min, float* __restrict__ out_t,
               int32_t* __restrict__ out_idx,
               int32_t* __restrict__ out_visits) {
  const int lane = threadIdx.x & (kStrip - 1);
  const int64_t sg =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (sg >= n_strips) return;  // whole warps only
  const int64_t ray = sg * kStrip + lane;
  const int cnt = counts[sg];
  float best_t = kTFar;
  int32_t best_i = -1;
  int visits = 0;
  if (cnt > 0) {
    const Ray r = load_ray(o, d, ray);
    const float cap = t_cap[ray];
    const bool lv = live[ray] != 0;
    // Early-out bound: max over the strip's live rays of
    // min(best_t, box exit); a strip with no live ray gets 0.
    float done = warp_max(lv ? cap : 0.0f);
    const int32_t* c = cand + sg * k_max;
    const float* nb = nearb + sg * k_max;
    for (int k = 0; k < cnt; ++k) {
      if (!(nb[k] < done)) continue;  // warp-uniform
      const int32_t blk = c[k];
      const float* w = packed + static_cast<int64_t>(blk) * 16 * block;
      float c_min = kTFar;
      int c_lane = 0;
      for (int l = 0; l < block; ++l) {
        const float t = woop_t(r, w, block, l, t_min);
        if (t < c_min) { c_min = t; c_lane = l; }
      }
      if (c_min < best_t) { best_t = c_min; best_i = blk * block + c_lane; }
      done = warp_max(lv ? fminf(best_t, cap) : 0.0f);
      ++visits;
    }
  }
  out_t[ray] = best_t;
  out_idx[ray] = best_i;
  if (lane == 0) out_visits[sg] = visits;
}

__global__ void __launch_bounds__(kStrip * kWarpsPerBlock)
trans_kernel(const float* __restrict__ packed, int block,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_max,
             const uint8_t* __restrict__ live,
             const int32_t* __restrict__ cand,
             const int32_t* __restrict__ counts, int64_t n_strips, int k_max,
             float t_min, float* __restrict__ out_tr,
             int32_t* __restrict__ out_visits) {
  const int lane = threadIdx.x & (kStrip - 1);
  const int64_t sg =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (sg >= n_strips) return;
  const int64_t ray = sg * kStrip + lane;
  const int cnt = counts[sg];
  float tr = 1.0f;
  int visits = 0;
  if (cnt > 0) {
    const Ray r = load_ray(o, d, ray);
    const float tm = t_max[ray];
    const bool lv = live[ray] != 0;
    // Max live transmittance of the strip; the strip stops, at block
    // boundaries only, once it is <= 1e-6.
    float lit = warp_max(lv ? 1.0f : 0.0f);
    const int32_t* c = cand + sg * k_max;
    for (int k = 0; k < cnt && lit > 1e-6f; ++k) {
      const float* w = packed + static_cast<int64_t>(c[k]) * 16 * block;
      const float* f = w + 15 * block;
      float p = 1.0f;
      for (int l = 0; l < block; ++l) {
        const float t = woop_t(r, w, block, l, t_min);
        if (t < tm) p = p * __ldg(f + l);
      }
      tr = tr * p;
      lit = warp_max(lv ? tr : 0.0f);
      ++visits;
    }
  }
  out_tr[ray] = tr;
  if (lane == 0) out_visits[sg] = visits;
}

inline unsigned grid_for(int64_t n_strips) {
  return static_cast<unsigned>((n_strips + kWarpsPerBlock - 1) /
                               kWarpsPerBlock);
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous arrays:
//   packed (NB, 16, block) f32; o, d (n_strips * 32, 3) f32; t_cap/t_max,
//   live (n_strips * 32) f32 / u8; cand, nearb (n_strips, k_max) i32 /
//   f32; counts (n_strips) i32.  Outputs: out_t/out_tr (n_strips * 32),
//   out_idx (n_strips * 32) i32, out_visits (n_strips) i32.
// Returns the cudaError_t of the launch (0 on success).
int solr_sweep_closest(const float* packed, int block, const float* o,
                       const float* d, const float* t_cap,
                       const uint8_t* live, const int32_t* cand,
                       const int32_t* counts, const float* nearb,
                       int64_t n_strips, int k_max, float t_min, float* out_t,
                       int32_t* out_idx, int32_t* out_visits, void* stream) {
  if (n_strips > 0) {
    closest_kernel<<<grid_for(n_strips), kStrip * kWarpsPerBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        packed, block, o, d, t_cap, live, cand, counts, nearb, n_strips,
        k_max, t_min, out_t, out_idx, out_visits);
  }
  return static_cast<int>(cudaGetLastError());
}

int solr_sweep_transmittance(const float* packed, int block, const float* o,
                             const float* d, const float* t_max,
                             const uint8_t* live, const int32_t* cand,
                             const int32_t* counts, int64_t n_strips,
                             int k_max, float t_min, float* out_tr,
                             int32_t* out_visits, void* stream) {
  if (n_strips > 0) {
    trans_kernel<<<grid_for(n_strips), kStrip * kWarpsPerBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        packed, block, o, d, t_max, live, cand, counts, n_strips, k_max,
        t_min, out_tr, out_visits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
