// Per-strip interval sweeps over candidate primitive blocks, for Hopper
// (sm_90a).  Built by nvcc into a shared library with a plain C
// interface and bound with ctypes (solr_tpu_torch/ops/sweep.py).
//
// Replaces the Pallas TPU kernels of solr_tpu/ops/pallas_kernels.py,
// each entry point for the three primitive bodies of _PRIM_ROWS (:171):
//   solr_sweep_closest(prim)       <- sweep_closest / _closest_kernel
//   solr_sweep_transmittance(prim) <- sweep_transmittance / _trans_kernel
//   prim 0 = tri    (B1, B2) <- _woop_rows   (:108), functor WoopT
//   prim 1 = sphere (B3, B4) <- _sphere_rows (:136), functor SphereT
//   prim 2 = cyl    (B5, B6) <- _cyl_rows    (:158) -> packet.cyl_core,
//                                                     functor CylT
// They compute what those compute; they are not the Pallas grid carried
// over.
//
// Mapping: one warp per 32-ray strip, one thread per ray.  The warp
// walks its strip's candidate list; every thread scans the block's
// `block` primitives in ascending lane order.  The block's packed rows
// are read at warp-uniform addresses, so each load is one broadcast
// transaction served from L1 (a block's 12 Woop rows are 24 KB at
// block=512; a sphere reads 4 rows, a cylinder 8).  What bounds the
// kernels on this card: the per-pair arithmetic (about 40 instructions
// for a Woop test, 20 for a sphere, 90 for a capped cylinder), issued by
// one thread per ray; the row bytes are small next to it.  A strip
// whose list is empty returns at once, which is what makes the parked
// tiles of later bounces cost nothing.
//
// Exactness with the plain PyTorch versions (ops/packet.py PRIM_T):
//   * build with --fmad=false and without fast math: every chain keeps
//     the plain version's association (((a*b + c*d) + e*f) + g) and
//     every product rounds on its own, as PyTorch's separate
//     elementwise ops do; sqrtf and every division are IEEE;
//   * the clamps of the plain version (torch.clamp(x, min=eps)) are
//     `x < eps ? eps : x`, which keeps a NaN as torch does;
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

constexpr float kIntersectEps = 1.0e-8f;  // constants.INTERSECT_EPS

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// Woop test of one ray against lane `l` of a packed block (rows of
// length `block`, row-major).  Mirrors packet._woop_t.
struct WoopT {
  __device__ __forceinline__ static float t(const Ray& r,
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
};

// Sphere rows [cx cy cz r]: the nearest root > t_min (the exit root for
// a ray that starts inside); r <= 0 never hits.  Mirrors packet._sphere_t.
struct SphereT {
  __device__ __forceinline__ static float t(const Ray& r,
                                            const float* __restrict__ w,
                                            int block, int l, float t_min) {
    const float ocx = r.ox - __ldg(w + 0 * block + l);
    const float ocy = r.oy - __ldg(w + 1 * block + l);
    const float ocz = r.oz - __ldg(w + 2 * block + l);
    const float rad = __ldg(w + 3 * block + l);
    const float b = (ocx * r.dx + ocy * r.dy) + ocz * r.dz;
    const float c0 = ((ocx * ocx + ocy * ocy) + ocz * ocz) - rad * rad;
    const float disc = b * b - c0;
    const bool valid = (disc > 0.0f) && (rad > 0.0f);
    const float sq = sqrtf(valid ? disc : 1.0f);
    const float lo = -b - sq, hi = -b + sq;
    const float t1 = (valid && lo > t_min) ? lo : kTFar;
    const float t2 = (valid && hi > t_min) ? hi : kTFar;
    return fminf(t1, t2);
  }
};

// Capped cylinder rows [p0 r axis |axis|^2]: the side surface plus the
// two end disks, two-sided; r <= 0 never hits.  Mirrors packet.cyl_core.
struct CylT {
  __device__ __forceinline__ static float t(const Ray& r,
                                            const float* __restrict__ w,
                                            int block, int l, float t_min) {
    const float ocx = r.ox - __ldg(w + 0 * block + l);
    const float ocy = r.oy - __ldg(w + 1 * block + l);
    const float ocz = r.oz - __ldg(w + 2 * block + l);
    const float rad = __ldg(w + 3 * block + l);
    const float ax = __ldg(w + 4 * block + l), ay = __ldg(w + 5 * block + l);
    const float az = __ldg(w + 6 * block + l), h2 = __ldg(w + 7 * block + l);
    const float inv_h2 = 1.0f / clamp_min(h2, kIntersectEps);
    const float d_a = (r.dx * ax + r.dy * ay) + r.dz * az;
    const float oc_a = (ocx * ax + ocy * ay) + ocz * az;
    const float a = 1.0f - (d_a * d_a) * inv_h2;
    const float b =
        ((ocx * r.dx + ocy * r.dy) + ocz * r.dz) - (d_a * oc_a) * inv_h2;
    const float cq = (((ocx * ocx + ocy * ocy) + ocz * ocz) -
                      (oc_a * oc_a) * inv_h2) - rad * rad;
    const float safe_a = clamp_min(a, kIntersectEps);
    const float disc = b * b - safe_a * cq;
    const bool base = (disc > 0.0f) && (a > kIntersectEps) && (rad > 0.0f);
    const float sq = sqrtf(base ? disc : 1.0f);
    float t1 = (-b - sq) / safe_a;
    float t2 = (-b + sq) / safe_a;
    const float s1 = oc_a + t1 * d_a;
    const float s2 = oc_a + t2 * d_a;
    t1 = (base && s1 >= 0.0f && s1 <= h2 && t1 > t_min) ? t1 : kTFar;
    t2 = (base && s2 >= 0.0f && s2 <= h2 && t2 > t_min) ? t2 : kTFar;
    const float t_side = fminf(t1, t2);

    const bool ax_safe = fabsf(d_a) > kIntersectEps;
    const float inv_da = (ax_safe ? 1.0f : 0.0f) / (ax_safe ? d_a : 1.0f);
    // The disk in the plane s = plane_s, centred at p0 + off * axis.
    auto cap = [&](float plane_s, float off) {
      const float tc = (plane_s - oc_a) * inv_da;
      const float qx = (ocx + tc * r.dx) - off * ax;
      const float qy = (ocy + tc * r.dy) - off * ay;
      const float qz = (ocz + tc * r.dz) - off * az;
      const float rad2 = (qx * qx + qy * qy) + qz * qz;
      const bool ok =
          ax_safe && (rad > 0.0f) && (rad2 <= rad * rad) && (tc > t_min);
      return ok ? tc : kTFar;
    };
    return fminf(t_side, fminf(cap(0.0f, 0.0f), cap(h2, 1.0f)));
  }
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        int64_t ray) {
  Ray r;
  r.ox = o[3 * ray + 0]; r.oy = o[3 * ray + 1]; r.oz = o[3 * ray + 2];
  r.dx = d[3 * ray + 0]; r.dy = d[3 * ray + 1]; r.dz = d[3 * ray + 2];
  return r;
}

template <class Prim>
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
        const float t = Prim::t(r, w, block, l, t_min);
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

template <class Prim>
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
        const float t = Prim::t(r, w, block, l, t_min);
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

template <class Prim>
void launch_closest(const float* packed, int block, const float* o,
                    const float* d, const float* t_cap, const uint8_t* live,
                    const int32_t* cand, const int32_t* counts,
                    const float* nearb, int64_t n_strips, int k_max,
                    float t_min, float* out_t, int32_t* out_idx,
                    int32_t* out_visits, cudaStream_t stream) {
  closest_kernel<Prim><<<grid_for(n_strips), kStrip * kWarpsPerBlock, 0,
                         stream>>>(packed, block, o, d, t_cap, live, cand,
                                   counts, nearb, n_strips, k_max, t_min,
                                   out_t, out_idx, out_visits);
}

template <class Prim>
void launch_trans(const float* packed, int block, const float* o,
                  const float* d, const float* t_max, const uint8_t* live,
                  const int32_t* cand, const int32_t* counts,
                  int64_t n_strips, int k_max, float t_min, float* out_tr,
                  int32_t* out_visits, cudaStream_t stream) {
  trans_kernel<Prim><<<grid_for(n_strips), kStrip * kWarpsPerBlock, 0,
                       stream>>>(packed, block, o, d, t_max, live, cand,
                                 counts, n_strips, k_max, t_min, out_tr,
                                 out_visits);
}

}  // namespace

extern "C" {

// prim: 0 = tri (Woop rows), 1 = sphere, 2 = cyl (packet.py layouts).
// All pointers are device pointers to contiguous arrays:
//   packed (NB, 16, block) f32; o, d (n_strips * 32, 3) f32; t_cap/t_max,
//   live (n_strips * 32) f32 / u8; cand, nearb (n_strips, k_max) i32 /
//   f32; counts (n_strips) i32.  Outputs: out_t/out_tr (n_strips * 32),
//   out_idx (n_strips * 32) i32, out_visits (n_strips) i32.
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for an unknown prim.
int solr_sweep_closest(int prim, const float* packed, int block,
                       const float* o, const float* d, const float* t_cap,
                       const uint8_t* live, const int32_t* cand,
                       const int32_t* counts, const float* nearb,
                       int64_t n_strips, int k_max, float t_min, float* out_t,
                       int32_t* out_idx, int32_t* out_visits, void* stream) {
  if (prim < 0 || prim > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_strips > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    auto fn = prim == 0 ? launch_closest<WoopT>
              : prim == 1 ? launch_closest<SphereT> : launch_closest<CylT>;
    fn(packed, block, o, d, t_cap, live, cand, counts, nearb, n_strips,
       k_max, t_min, out_t, out_idx, out_visits, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int solr_sweep_transmittance(int prim, const float* packed, int block,
                             const float* o, const float* d,
                             const float* t_max, const uint8_t* live,
                             const int32_t* cand, const int32_t* counts,
                             int64_t n_strips, int k_max, float t_min,
                             float* out_tr, int32_t* out_visits,
                             void* stream) {
  if (prim < 0 || prim > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_strips > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    auto fn = prim == 0 ? launch_trans<WoopT>
              : prim == 1 ? launch_trans<SphereT> : launch_trans<CylT>;
    fn(packed, block, o, d, t_max, live, cand, counts, n_strips, k_max,
       t_min, out_tr, out_visits, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
