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
// over.  One design, staged (closest_staged, trans_staged), runs all six
// on the functors.  One CTA per 32-ray strip.  Every warp holds the
// strip's 32 rays, one per thread, and tests them against its own
// contiguous, ascending slice of the block's lanes.  Each visited
// block's rows are copied into shared memory with 16-byte cp.async
// (4-byte when BLOCK is not a multiple of 4), double-buffered: the next
// listed block's rows arrive while the current one is tested.  The
// thread that copied a lane's rows also computes that lane's
// per-primitive terms (CylT: 1/max(h2, 1e-8) and r*r) once, beside
// them.  The tests read 2 or 4 lanes of a row per shared load, a
// broadcast to the warp.
//   * closest: each warp keeps, per ray, its slice's minimum with a
//     strict `<` in ascending lane order; then every warp combines the
//     slices in ascending order with a strict `<` (the serial scan's
//     (t, lane)) and keeps the same best and `done` bound;
//   * transmittance: each warp writes, per ray, the occlusion bits
//     (t < t_max) of its slice to shared memory; then every warp
//     multiplies the factors of the set bits in ascending lane order
//     (__ffs), the serial product, and keeps the same `lit` bound.
// `done` and `lit` are uniform over the CTA and change between blocks
// only; two CTA barriers per visited block.  A prefetched block that the
// early-out then skips is read and dropped.  A launch runs order_kernel
// first, a stable sort of the strips by descending list length, and CTA
// i sweeps strip order[i]: the strips with the longest lists start
// first instead of setting the end of the launch alone.  A strip whose
// list is empty returns at once, which is what makes the parked tiles
// of later bounces cost nothing.
//
// What bounds them.  One warp per strip, the port's first design, spent
// each test waiting on 4-12 dependent global loads, and one warp walked
// a whole list.  Spread over warps, with rows in shared memory ahead of
// use, B1 went from 6.8 to 2.9 ms, B6 from 7.8 to 3.6, B2 from 5.9 to
// 2.7 and B5 from 4.6 to 2.8 on an H100 (700 W).  The launch order took
// another 20% off B6 and 3-7% off the others; the order kernel takes
// 0.02 ms alone (torch.argsort 0.07-0.11 ms) and costs B1's smallest
// launch (0.52 ms) nothing measurable (solr_tpu_torch/sweep_steps.py,
// PERF.md).  What is left is instruction issue: the counted f32
// operations are 35-58% of the single-issue ceiling of a --fmad=false
// build, the rest being the compares, selects and IEEE division and
// square-root sequences around them.  So each kernel takes the shape
// (StagedShape: warps per CTA, occupancy hint, lanes per load) that
// keeps the most warps of it on an SM without spilling:
//   * B1 8 / 3 / 4 and B6 4 / 4 / 4: 80 and 94 registers;
//   * B2 8 / 3 / 2: at BLOCK=512 a CTA stages 13 rows of 512 lanes twice
//     plus 2 KB of occlusion bits, 54 KB, so shared memory holds 4 CTAs
//     of an SM; 8 warps under the hint's 85 registers give 24 warps
//     where 4 warps per CTA gave 16 (10% slower).  4 lanes per load
//     need 88 registers and spill under the hint; 2 lanes take 80;
//   * B5 4 / 4 / 2: CylT needs 91-94 registers at 4 lanes per load, which
//     spill under 8 warps / 3 CTAs; 2 lanes take 72, and the SM holds 7
//     of its 21 KB CTAs;
//   * B3 4 / 4 / 4 and B4 4 / 6 / 4: SphereT's 4 rows (5 with the
//     factor) take 4-5 KB a stage at BLOCK=256, so registers set the
//     shape: 56 at 4 lanes per load, 9 CTAs of 4 warps per SM.  8 warps
//     per CTA took 6-12% longer, 2 lanes per load 7-9%, and 8 warps
//     under a hint of 6 or 8 CTAs mostly spill.
// CylT skips its side roots when no ray of the warp reaches the side
// (15% of B6's time), and SphereT its square root and roots when no ray
// of the warp meets the sphere (29-30% of B3's time, 20-25% of B4's;
// about 0.1% of the (ray, sphere) pairs of the molecule frame need
// them).
//
// Exactness with the plain PyTorch versions (ops/packet.py PRIM_T):
//   * build with --fmad=false and without fast math: every chain keeps
//     the plain version's association (((a*b + c*d) + e*f) + g) and
//     every product rounds on its own, as PyTorch's separate
//     elementwise ops do; sqrtf and every division are IEEE; tensor
//     cores are not used (a TF32 transform rounds the inputs);
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
constexpr float kTFar = 3.0e38f;

// The staged design's shape.  Per kernel (StagedShape below): warps per
// strip (one CTA), the __launch_bounds__ occupancy hint, and lanes of a
// row per shared load in the tests.  For all of them: row buffers (one
// tested, one in flight), and whether the CTAs take the strips with the
// longest lists first.
constexpr int kB1Warps = 8;    // closest_staged<WoopT>
constexpr int kB1MinCtas = 3;
constexpr int kB1LaneVec = 4;
constexpr int kB2Warps = 8;    // trans_staged<WoopT>
constexpr int kB2MinCtas = 3;
constexpr int kB2LaneVec = 2;
constexpr int kB5Warps = 4;    // closest_staged<CylT>
constexpr int kB5MinCtas = 4;
constexpr int kB5LaneVec = 2;
constexpr int kB6Warps = 4;    // trans_staged<CylT>
constexpr int kB6MinCtas = 4;
constexpr int kB6LaneVec = 4;
constexpr int kB3Warps = 4;    // closest_staged<SphereT>
constexpr int kB3MinCtas = 4;
constexpr int kB3LaneVec = 4;
constexpr int kB4Warps = 4;    // trans_staged<SphereT>
constexpr int kB4MinCtas = 6;
constexpr int kB4LaneVec = 4;
constexpr int kStages = 2;
constexpr bool kLongestFirst = true;
constexpr int kMaxSmem = 232448;  // the H100's opt-in shared memory per CTA

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

// A functor tests one ray against one primitive given its values `v`:
// the kRaw packed rows of its lane, then the kVals - kRaw per-primitive
// terms that derive() computes from them.

// Woop rows 0-11.  Mirrors packet._woop_t.
struct WoopT {
  static constexpr int kRaw = 12, kVals = 12;
  __device__ __forceinline__ static void derive(float*) {}
  __device__ __forceinline__ static float hit(const Ray& r, const float* v,
                                              float t_min) {
    const float opx = ((r.ox * v[0] + r.oy * v[1]) + r.oz * v[2]) + v[3];
    const float opy = ((r.ox * v[4] + r.oy * v[5]) + r.oz * v[6]) + v[7];
    const float opz = ((r.ox * v[8] + r.oy * v[9]) + r.oz * v[10]) + v[11];
    const float dpx = (r.dx * v[0] + r.dy * v[1]) + r.dz * v[2];
    const float dpy = (r.dx * v[4] + r.dy * v[5]) + r.dz * v[6];
    const float dpz = (r.dx * v[8] + r.dy * v[9]) + r.dz * v[10];
    const bool safe = fabsf(dpz) > 1e-12f;
    const float inv = safe ? 1.0f / dpz : 0.0f;
    const float t = (-opz) * inv;
    const float u = opx + t * dpx;
    const float w = opy + t * dpy;
    const bool valid =
        safe && (u >= 0.0f) && (w >= 0.0f) && (u + w <= 1.0f) && (t > t_min);
    return valid ? t : kTFar;
  }
};

// Sphere rows [cx cy cz r]: the nearest root > t_min (the exit root for
// a ray that starts inside); r <= 0 never hits.  Mirrors packet._sphere_t.
struct SphereT {
  static constexpr int kRaw = 4, kVals = 4;
  __device__ __forceinline__ static void derive(float*) {}
  __device__ __forceinline__ static float hit(const Ray& r, const float* v,
                                              float t_min) {
    const float ocx = r.ox - v[0];
    const float ocy = r.oy - v[1];
    const float ocz = r.oz - v[2];
    const float rad = v[3];
    const float b = (ocx * r.dx + ocy * r.dy) + ocz * r.dz;
    const float c0 = ((ocx * ocx + ocy * ocy) + ocz * ocz) - rad * rad;
    const float disc = b * b - c0;
    const bool valid = (disc > 0.0f) && (rad > 0.0f);
    // Without `valid` both roots are kTFar: the square root runs only
    // when a thread of the warp needs it.
    float t = kTFar;
    if (valid) {
      const float sq = sqrtf(disc);
      const float lo = -b - sq, hi = -b + sq;
      t = fminf(lo > t_min ? lo : kTFar, hi > t_min ? hi : kTFar);
    }
    return t;
  }
};

// Capped cylinder rows [p0 r axis |axis|^2], then 1/max(|axis|^2, 1e-8)
// and r*r: the side surface plus the two end disks, two-sided; r <= 0
// never hits.  Mirrors packet.cyl_core.
struct CylT {
  static constexpr int kRaw = 8, kVals = 10;
  __device__ __forceinline__ static void derive(float* v) {
    v[8] = 1.0f / clamp_min(v[7], kIntersectEps);
    v[9] = v[3] * v[3];
  }
  __device__ __forceinline__ static float hit(const Ray& r, const float* v,
                                              float t_min) {
    const float ocx = r.ox - v[0];
    const float ocy = r.oy - v[1];
    const float ocz = r.oz - v[2];
    const float rad = v[3];
    const float ax = v[4], ay = v[5], az = v[6], h2 = v[7];
    const float inv_h2 = v[8], rad_sq = v[9];
    const float d_a = (r.dx * ax + r.dy * ay) + r.dz * az;
    const float oc_a = (ocx * ax + ocy * ay) + ocz * az;
    const float a = 1.0f - (d_a * d_a) * inv_h2;
    const float b =
        ((ocx * r.dx + ocy * r.dy) + ocz * r.dz) - (d_a * oc_a) * inv_h2;
    const float cq = (((ocx * ocx + ocy * ocy) + ocz * ocz) -
                      (oc_a * oc_a) * inv_h2) - rad_sq;
    const float safe_a = clamp_min(a, kIntersectEps);
    const float disc = b * b - safe_a * cq;
    const bool base = (disc > 0.0f) && (a > kIntersectEps) && (rad > 0.0f);
    // Without `base` both side roots are kTFar: their square root and
    // two divisions run only when a thread of the warp needs them.
    float t_side = kTFar;
    if (base) {
      const float sq = sqrtf(disc);
      float t1 = (-b - sq) / safe_a;
      float t2 = (-b + sq) / safe_a;
      const float s1 = oc_a + t1 * d_a;
      const float s2 = oc_a + t2 * d_a;
      t1 = (s1 >= 0.0f && s1 <= h2 && t1 > t_min) ? t1 : kTFar;
      t2 = (s2 >= 0.0f && s2 <= h2 && t2 > t_min) ? t2 : kTFar;
      t_side = fminf(t1, t2);
    }

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
          ax_safe && (rad > 0.0f) && (rad2 <= rad_sq) && (tc > t_min);
      return ok ? tc : kTFar;
    };
    return fminf(t_side, fminf(cap(0.0f, 0.0f), cap(h2, 1.0f)));
  }
};

// The shape of each staged kernel (closest: kTrans false).
template <class Prim, bool kTrans>
struct StagedShape;
template <>
struct StagedShape<WoopT, false> {
  static constexpr int kWarps = kB1Warps, kMinCtas = kB1MinCtas,
                       kLaneVec = kB1LaneVec;
};
template <>
struct StagedShape<WoopT, true> {
  static constexpr int kWarps = kB2Warps, kMinCtas = kB2MinCtas,
                       kLaneVec = kB2LaneVec;
};
template <>
struct StagedShape<CylT, false> {
  static constexpr int kWarps = kB5Warps, kMinCtas = kB5MinCtas,
                       kLaneVec = kB5LaneVec;
};
template <>
struct StagedShape<CylT, true> {
  static constexpr int kWarps = kB6Warps, kMinCtas = kB6MinCtas,
                       kLaneVec = kB6LaneVec;
};
template <>
struct StagedShape<SphereT, false> {
  static constexpr int kWarps = kB3Warps, kMinCtas = kB3MinCtas,
                       kLaneVec = kB3LaneVec;
};
template <>
struct StagedShape<SphereT, true> {
  static constexpr int kWarps = kB4Warps, kMinCtas = kB4MinCtas,
                       kLaneVec = kB4LaneVec;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        int64_t ray) {
  Ray r;
  r.ox = o[3 * ray + 0]; r.oy = o[3 * ray + 1]; r.oz = o[3 * ray + 2];
  r.dx = d[3 * ray + 0]; r.dy = d[3 * ray + 1]; r.dz = d[3 * ray + 2];
  return r;
}

// ---------------------------------------------------------------------
// Staged (B1-B6)
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory rows of one stage: the functor's kRaw packed rows, its
// derived rows, then (transmittance) the factor row 15.  Rows are
// `stride` floats apart, stride = BLOCK rounded up to a multiple of 4.
template <class Prim, bool kTrans>
struct Stage {
  static constexpr int kCopied = Prim::kRaw + (kTrans ? 1 : 0);
  static constexpr int kRows = Prim::kVals + (kTrans ? 1 : 0);
  static constexpr int kFactorRow = Prim::kVals;

  __device__ __forceinline__ static int src_row(int i) {
    return i < Prim::kRaw ? i : 15;
  }
  __device__ __forceinline__ static int dst_row(int i) {
    return i < Prim::kRaw ? i : kFactorRow;
  }

  // Issue the copies of one block's rows.  Thread t owns lanes
  // [u * unit, (u + 1) * unit) for u = t, t + nthreads, ...; unit 4 (16
  // bytes) when BLOCK % 4 == 0, else 1.
  __device__ __forceinline__ static void issue(float* st,
                                               const float* __restrict__ w,
                                               int block, int stride) {
    if ((block & 3) == 0) {
      for (int l = 4 * threadIdx.x; l < block; l += 4 * blockDim.x) {
#pragma unroll
        for (int i = 0; i < kCopied; ++i)
          cp_async16(st + dst_row(i) * stride + l, w + src_row(i) * block + l);
      }
    } else {
      for (int l = threadIdx.x; l < block; l += blockDim.x) {
#pragma unroll
        for (int i = 0; i < kCopied; ++i)
          cp_async4(st + dst_row(i) * stride + l, w + src_row(i) * block + l);
      }
    }
  }

  // The per-primitive terms of the lanes this thread copied; its own
  // copies are complete (cp.async.wait_group) and visible to it.
  __device__ __forceinline__ static void derive(float* st, int block,
                                                int stride) {
    if constexpr (Prim::kVals > Prim::kRaw) {
      const int unit = (block & 3) == 0 ? 4 : 1;
      for (int l0 = unit * threadIdx.x; l0 < block; l0 += unit * blockDim.x) {
        for (int l = l0; l < l0 + unit && l < block; ++l) {
          float v[Prim::kVals];
#pragma unroll
          for (int i = 0; i < Prim::kRaw; ++i) v[i] = st[i * stride + l];
          Prim::derive(v);
#pragma unroll
          for (int i = Prim::kRaw; i < Prim::kVals; ++i)
            st[i * stride + l] = v[i];
        }
      }
    }
  }

  __host__ __device__ static constexpr int64_t floats(int stride) {
    return static_cast<int64_t>(kRows) * stride;
  }
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Lanes [lo, hi) of slice `s` of `slices`: contiguous, ascending, cut at
// multiples of `vec` (the last slice ends at BLOCK).
__device__ __forceinline__ void slice_of(int s, int slices, int vec,
                                         int block, int& lo, int& hi) {
  const int units = (block + vec - 1) / vec;
  lo = min(block, vec * (units * s / slices));
  hi = min(block, vec * (units * (s + 1) / slices));
}

// Call f(l, t) for each lane l of [lo, hi) in ascending order, with t
// the test of ray r against lane l of stage `st`.  kVec (1, 2 or 4)
// lanes of each row per shared load; `lo` is a multiple of kVec.
template <class Prim, int kVec, class F>
__device__ __forceinline__ void sweep_slice(const Ray& r, const float* st,
                                            int stride, int lo, int hi,
                                            float t_min, F&& f) {
  for (int l0 = lo; l0 < hi; l0 += kVec) {
    float v[Prim::kVals][kVec];
#pragma unroll
    for (int i = 0; i < Prim::kVals; ++i) {
      const float* p = st + i * stride + l0;
      if constexpr (kVec == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[i][0] = q.x; v[i][1] = q.y; v[i][2] = q.z; v[i][3] = q.w;
      } else if constexpr (kVec == 2) {
        const float2 q = *reinterpret_cast<const float2*>(p);
        v[i][0] = q.x; v[i][1] = q.y;
      } else {
        v[i][0] = p[0];
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float u[Prim::kVals];
#pragma unroll
      for (int i = 0; i < Prim::kVals; ++i) u[i] = v[i][j];
      const int l = l0 + j;
      if (l < hi) f(l, Prim::hit(r, u, t_min));
    }
  }
}

// The candidate schedule shared by both staged kernels: candidate k is
// tested from one buffer while candidate k + 1 is copied into the other.
template <class S>
struct Pipeline {
  float* stages;
  int64_t stage_floats;
  const float* packed;
  const int32_t* cand;
  int block, stride;
  int buf = 0;     // buffer of the candidate last tested
  int ahead = -1;  // candidate in flight into buffer buf ^ 1, or -1

  __device__ __forceinline__ float* stage(int b) const {
    return stages + b * stage_floats;
  }
  __device__ __forceinline__ const float* rows(int k) const {
    return packed + static_cast<int64_t>(cand[k]) * 16 * block;
  }

  // Make candidate k's rows ready in shared memory (all threads), then
  // start the copy of candidate `next` (-1: none) into the other buffer
  // when there is one.  The CTA barrier between the two is where every
  // warp is done with the previous visit, the other buffer included.
  __device__ __forceinline__ const float* acquire(int k, int next) {
    if (ahead == k) {
      buf ^= 1;
    } else {
      if (ahead >= 0) cp_async_wait<0>();  // drop a skipped prefetch
      S::issue(stage(buf), rows(k), block, stride);
      cp_async_commit();
    }
    cp_async_wait<0>();
    S::derive(stage(buf), block, stride);
    __syncthreads();
    ahead = -1;
    if (next >= 0) {
      S::issue(stage(buf ^ 1), rows(next), block, stride);
      cp_async_commit();
      ahead = next;
    }
    return stage(buf);
  }

  __device__ __forceinline__ void drain() const {
    if (ahead >= 0) cp_async_wait<0>();
  }
};

// The strip that CTA blockIdx.x sweeps.
__device__ __forceinline__ int64_t strip_of(
    const int32_t* __restrict__ order) {
  return kLongestFirst ? order[blockIdx.x] : blockIdx.x;
}

template <class Prim>
__global__ void __launch_bounds__(kStrip * StagedShape<Prim, false>::kWarps,
                                  StagedShape<Prim, false>::kMinCtas)
closest_staged(const float* __restrict__ packed, int block,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_cap,
               const uint8_t* __restrict__ live,
               const int32_t* __restrict__ cand,
               const int32_t* __restrict__ counts,
               const float* __restrict__ nearb,
               const int32_t* __restrict__ order, int k_max, float t_min,
               float* __restrict__ out_t, int32_t* __restrict__ out_idx,
               int32_t* __restrict__ out_visits) {
  using S = Stage<Prim, false>;
  constexpr int kWarps = StagedShape<Prim, false>::kWarps;
  constexpr int kVec = StagedShape<Prim, false>::kLaneVec;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & (kStrip - 1);
  const int warp = threadIdx.x >> 5;
  const int64_t sg = strip_of(order);
  const int64_t ray = sg * kStrip + lane;
  const int cnt = counts[sg];
  if (cnt <= 0) {
    if (warp == 0) {
      out_t[ray] = kTFar;
      out_idx[ray] = -1;
      if (lane == 0) out_visits[sg] = 0;
    }
    return;
  }
  const int stride = round4(block);
  const int64_t stage_floats = S::floats(stride);
  float* s_t = smem + kStages * stage_floats;  // [kWarps][32]
  int* s_l = reinterpret_cast<int*>(s_t + kWarps * kStrip);

  const Ray r = load_ray(o, d, ray);
  const float cap = t_cap[ray];
  const bool lv = live[ray] != 0;
  float best_t = kTFar;
  int32_t best_i = -1;
  // Early-out bound: max over the strip's live rays of min(best_t, box
  // exit); a strip with no live ray gets 0.  Uniform over the CTA.
  float done = warp_max(lv ? cap : 0.0f);
  const int32_t* c = cand + sg * k_max;
  const float* nb = nearb + sg * k_max;
  int lo, hi;
  slice_of(warp, kWarps, kVec, block, lo, hi);
  Pipeline<S> pipe{smem, stage_floats, packed, c, block, stride};
  int visits = 0;
  int k = 0;
  while (k < cnt && !(nb[k] < done)) ++k;
  while (k < cnt) {
    const int32_t blk = c[k];
    const float* st = pipe.acquire(k, k + 1 < cnt ? k + 1 : -1);
    float c_min = kTFar;
    int c_lane = 0;
    sweep_slice<Prim, kVec>(r, st, stride, lo, hi, t_min,
                            [&](int l, float t) {
      if (t < c_min) { c_min = t; c_lane = l; }
    });
    s_t[warp * kStrip + lane] = c_min;
    s_l[warp * kStrip + lane] = c_lane;
    __syncthreads();
    // Every warp combines the slices in ascending order, the serial
    // scan's (t, lane), and keeps the same best and `done`.
    c_min = kTFar;
    c_lane = 0;
#pragma unroll
    for (int s = 0; s < kWarps; ++s) {
      const float t = s_t[s * kStrip + lane];
      if (t < c_min) { c_min = t; c_lane = s_l[s * kStrip + lane]; }
    }
    if (c_min < best_t) { best_t = c_min; best_i = blk * block + c_lane; }
    done = warp_max(lv ? fminf(best_t, cap) : 0.0f);
    ++visits;
    ++k;
    while (k < cnt && !(nb[k] < done)) ++k;
  }
  pipe.drain();
  if (warp == 0) {
    out_t[ray] = best_t;
    out_idx[ray] = best_i;
    if (lane == 0) out_visits[sg] = visits;
  }
}

template <class Prim>
__global__ void __launch_bounds__(kStrip * StagedShape<Prim, true>::kWarps,
                                  StagedShape<Prim, true>::kMinCtas)
trans_staged(const float* __restrict__ packed, int block,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_max,
             const uint8_t* __restrict__ live,
             const int32_t* __restrict__ cand,
             const int32_t* __restrict__ counts,
             const int32_t* __restrict__ order, int k_max, float t_min,
             int words, float* __restrict__ out_tr,
             int32_t* __restrict__ out_visits) {
  using S = Stage<Prim, true>;
  constexpr int kWarps = StagedShape<Prim, true>::kWarps;
  constexpr int kVec = StagedShape<Prim, true>::kLaneVec;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & (kStrip - 1);
  const int warp = threadIdx.x >> 5;
  const int64_t sg = strip_of(order);
  const int64_t ray = sg * kStrip + lane;
  const int cnt = counts[sg];
  if (cnt <= 0) {
    if (warp == 0) {
      out_tr[ray] = 1.0f;
      if (lane == 0) out_visits[sg] = 0;
    }
    return;
  }
  const int stride = round4(block);
  const int64_t stage_floats = S::floats(stride);
  // Occlusion bits [kWarps][words][32 rays]: bit b of word j of
  // slice s is lane lo_s + 32 j + b.
  uint32_t* s_occ =
      reinterpret_cast<uint32_t*>(smem + kStages * stage_floats);

  const Ray r = load_ray(o, d, ray);
  const float tm = t_max[ray];
  const bool lv = live[ray] != 0;
  float tr = 1.0f;
  // Max live transmittance of the strip; the strip stops, at block
  // boundaries only, once it is <= 1e-6.  Uniform over the CTA.
  float lit = warp_max(lv ? 1.0f : 0.0f);
  const int32_t* c = cand + sg * k_max;
  int lo, hi;
  slice_of(warp, kWarps, kVec, block, lo, hi);
  Pipeline<S> pipe{smem, stage_floats, packed, c, block, stride};
  int visits = 0;
  for (int k = 0; k < cnt && lit > 1e-6f; ++k) {
    const float* st = pipe.acquire(k, k + 1 < cnt ? k + 1 : -1);
    uint32_t* occ = s_occ + warp * words * kStrip + lane;
    uint32_t m = 0;
    int word = 0;
    sweep_slice<Prim, kVec>(r, st, stride, lo, hi, t_min,
                            [&](int l, float t) {
      const int b = (l - lo) & 31;
      if (t < tm) m |= 1u << b;
      if (b == 31) { occ[word * kStrip] = m; m = 0; ++word; }
    });
    if (word < words) occ[word * kStrip] = m;  // a last, partial word
    __syncthreads();
    // Every warp multiplies the factors of the occluding lanes in
    // ascending lane order and keeps the same transmittance and `lit`.
    const float* f = st + S::kFactorRow * stride;
    float p = 1.0f;
    for (int s = 0; s < kWarps; ++s) {
      int s_lo, s_hi;
      slice_of(s, kWarps, kVec, block, s_lo, s_hi);
      const int n_words = (s_hi - s_lo + 31) >> 5;
      for (int j = 0; j < n_words; ++j) {
        uint32_t bits = s_occ[(s * words + j) * kStrip + lane];
        while (bits) {
          const int b = __ffs(bits) - 1;
          p = p * f[s_lo + 32 * j + b];
          bits &= bits - 1;
        }
      }
    }
    tr = tr * p;
    lit = warp_max(lv ? tr : 0.0f);
    ++visits;
  }
  pipe.drain();
  if (warp == 0) {
    out_tr[ray] = tr;
    if (lane == 0) out_visits[sg] = visits;
  }
}

template <class K>
cudaError_t allow_smem(K kernel, int64_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The launch order of the staged kernels: `order` = the strips by
// descending list length, equal lengths in ascending id (a stable sort
// of `counts`, the plain version being ops/sweep.py longest_first).
// One CTA.  Warp w takes a contiguous range of the strips, 32 at a time;
// the lanes of equal length find each other with __match_any_sync.
// cnt[b * kOrderWarps + w] counts warp w's strips of length b, then
// holds the position of its next one: the strips of greater length, and
// of length b in earlier warps, come before it.
constexpr int kOrderWarps = 32;

__global__ void __launch_bounds__(kStrip * kOrderWarps)
order_kernel(const int32_t* __restrict__ counts, int64_t n, int k_max,
             int32_t* __restrict__ order) {
  extern __shared__ __align__(16) float smem[];
  int* cnt = reinterpret_cast<int*>(smem);  // [k_max + 1][kOrderWarps]
  int* total = cnt + (k_max + 1) * kOrderWarps;  // [k_max + 1]
  const int lane = threadIdx.x & (kStrip - 1);
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  for (int i = threadIdx.x; i < (k_max + 1) * kOrderWarps; i += blockDim.x)
    cnt[i] = 0;
  __syncthreads();
  const int64_t per = (n + kOrderWarps - 1) / kOrderWarps;
  const int64_t lo = warp * per < n ? warp * per : n;
  const int64_t hi = lo + per < n ? lo + per : n;
  for (int64_t i = lo + lane; i - lane < hi; i += kStrip) {
    const int b = i < hi ? max(0, min(counts[i], k_max)) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && (peers & below) == 0)
      cnt[b * kOrderWarps + warp] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int b = threadIdx.x; b <= k_max; b += blockDim.x) {
    int s = 0;
    for (int w = 0; w < kOrderWarps; ++w) {
      const int c = cnt[b * kOrderWarps + w];
      cnt[b * kOrderWarps + w] = s;
      s += c;
    }
    total[b] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int b = k_max; b >= 0; --b) {
      const int c = total[b];
      total[b] = s;
      s += c;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (k_max + 1) * kOrderWarps; i += blockDim.x)
    cnt[i] += total[i / kOrderWarps];
  __syncthreads();
  for (int64_t i = lo + lane; i - lane < hi; i += kStrip) {
    const int b = i < hi ? max(0, min(counts[i], k_max)) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    int* next = cnt + max(b, 0) * kOrderWarps + warp;
    const int pos = *next + __popc(peers & below);
    __syncwarp();
    if (b >= 0) {
      order[pos] = static_cast<int32_t>(i);
      if ((peers & below) == 0) *next += __popc(peers);
    }
    __syncwarp();
  }
}

int64_t order_smem(int k_max) {
  return 4 * int64_t{k_max + 1} * (kOrderWarps + 1);
}

cudaError_t launch_order(const int32_t* counts, int64_t n, int k_max,
                         int32_t* order, cudaStream_t stream) {
  const int64_t bytes = order_smem(k_max);
  const cudaError_t err = allow_smem(order_kernel, bytes);
  if (err != cudaSuccess) return err;
  order_kernel<<<1, kStrip * kOrderWarps, bytes, stream>>>(counts, n, k_max,
                                                           order);
  return cudaSuccess;
}

// Dynamic shared memory of a staged launch, in bytes.
template <class Prim, bool kTrans>
int64_t staged_smem(int block, int* words) {
  constexpr int warps = StagedShape<Prim, kTrans>::kWarps;
  constexpr int vec = StagedShape<Prim, kTrans>::kLaneVec;
  const int units = (block + vec - 1) / vec;
  const int max_slice = vec * ((units + warps - 1) / warps);
  *words = (max_slice + 31) / 32;
  const int64_t scratch = kTrans ? int64_t{*words} * warps * kStrip
                                 : int64_t{2} * warps * kStrip;
  return 4 * (kStages * Stage<Prim, kTrans>::floats(round4(block)) + scratch);
}

// ---------------------------------------------------------------------
// Launchers.  Each first writes its launch order into the scratch
// `order`.
// ---------------------------------------------------------------------

template <class Prim>
cudaError_t launch_closest_staged(const float* packed, int block, const float* o,
                           const float* d, const float* t_cap,
                           const uint8_t* live, const int32_t* cand,
                           const int32_t* counts, const float* nearb,
                           int32_t* order, int64_t n_strips, int k_max,
                           float t_min, float* out_t, int32_t* out_idx,
                           int32_t* out_visits, cudaStream_t stream) {
  constexpr int threads = kStrip * StagedShape<Prim, false>::kWarps;
  int words;
  const int64_t bytes = staged_smem<Prim, false>(block, &words);
  cudaError_t err = allow_smem(closest_staged<Prim>, bytes);
  if (err == cudaSuccess && kLongestFirst)
    err = launch_order(counts, n_strips, k_max, order, stream);
  if (err != cudaSuccess) return err;
  closest_staged<Prim><<<static_cast<unsigned>(n_strips), threads, bytes,
                         stream>>>(
      packed, block, o, d, t_cap, live, cand, counts, nearb, order, k_max,
      t_min, out_t, out_idx, out_visits);
  return cudaSuccess;
}

template <class Prim>
cudaError_t launch_trans_staged(const float* packed, int block, const float* o,
                         const float* d, const float* t_max,
                         const uint8_t* live, const int32_t* cand,
                         const int32_t* counts, int32_t* order,
                         int64_t n_strips, int k_max, float t_min,
                         float* out_tr, int32_t* out_visits,
                         cudaStream_t stream) {
  constexpr int threads = kStrip * StagedShape<Prim, true>::kWarps;
  int words;
  const int64_t bytes = staged_smem<Prim, true>(block, &words);
  cudaError_t err = allow_smem(trans_staged<Prim>, bytes);
  if (err == cudaSuccess && kLongestFirst)
    err = launch_order(counts, n_strips, k_max, order, stream);
  if (err != cudaSuccess) return err;
  trans_staged<Prim><<<static_cast<unsigned>(n_strips), threads, bytes,
                       stream>>>(
      packed, block, o, d, t_max, live, cand, counts, order, k_max, t_min,
      words, out_tr, out_visits);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// prim: 0 = tri (Woop rows), 1 = sphere, 2 = cyl (packet.py layouts).
// All pointers are device pointers to contiguous arrays:
//   packed (NB, 16, block) f32; o, d (n_strips * 32, 3) f32; t_cap/t_max,
//   live (n_strips * 32) f32 / u8; cand, nearb (n_strips, k_max) i32 /
//   f32; counts (n_strips) i32.  Scratch: order (n_strips) i32, where
//   the entry writes its launch order (solr_sweep_order) before CTA i
//   sweeps strip order[i].  Outputs: out_t/out_tr (n_strips * 32),
//   out_idx (n_strips * 32) i32, out_visits (n_strips) i32.
// Returns the cudaError_t of the launches (0 on success), or
// cudaErrorInvalidValue for an unknown prim or a block whose staged rows
// do not fit in shared memory (solr_sweep_smem_bytes).
int solr_sweep_closest(int prim, const float* packed, int block,
                       const float* o, const float* d, const float* t_cap,
                       const uint8_t* live, const int32_t* cand,
                       const int32_t* counts, const float* nearb,
                       int32_t* order, int64_t n_strips, int k_max,
                       float t_min, float* out_t, int32_t* out_idx,
                       int32_t* out_visits, void* stream) {
  if (prim < 0 || prim > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_strips > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    auto fn = prim == 0   ? launch_closest_staged<WoopT>
              : prim == 1 ? launch_closest_staged<SphereT>
                          : launch_closest_staged<CylT>;
    const cudaError_t err =
        fn(packed, block, o, d, t_cap, live, cand, counts, nearb, order,
           n_strips, k_max, t_min, out_t, out_idx, out_visits, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

int solr_sweep_transmittance(int prim, const float* packed, int block,
                             const float* o, const float* d,
                             const float* t_max, const uint8_t* live,
                             const int32_t* cand, const int32_t* counts,
                             int32_t* order, int64_t n_strips,
                             int k_max, float t_min, float* out_tr,
                             int32_t* out_visits, void* stream) {
  if (prim < 0 || prim > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_strips > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    auto fn = prim == 0   ? launch_trans_staged<WoopT>
              : prim == 1 ? launch_trans_staged<SphereT>
                          : launch_trans_staged<CylT>;
    const cudaError_t err =
        fn(packed, block, o, d, t_max, live, cand, counts, order, n_strips,
           k_max, t_min, out_tr, out_visits, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The staged kernels' launch order into order (n) i32: the strips by
// descending counts (n) i32, clamped to [0, k_max], equal counts in
// ascending id.  Returns the cudaError_t of the launch (0 on success),
// or cudaErrorInvalidValue when k_max is too large for shared memory.
int solr_sweep_order(const int32_t* counts, int64_t n, int k_max,
                     int32_t* order, void* stream) {
  if (n > 0 && k_max >= 0) {
    auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = launch_order(counts, n, k_max, order, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Warps per CTA (one CTA per strip) of the kernel that the entry
// (closest 1: solr_sweep_closest, 0: solr_sweep_transmittance) runs for
// prim; -1 for an unknown prim.
int solr_sweep_warps(int closest, int prim) {
  if (prim < 0 || prim > 2) return -1;
  if (closest)
    return prim == 0   ? StagedShape<WoopT, false>::kWarps
           : prim == 1 ? StagedShape<SphereT, false>::kWarps
                       : StagedShape<CylT, false>::kWarps;
  return prim == 0   ? StagedShape<WoopT, true>::kWarps
         : prim == 1 ? StagedShape<SphereT, true>::kWarps
                     : StagedShape<CylT, true>::kWarps;
}

// The dynamic shared memory, in bytes, that a launch of the entry for
// prim at this block takes; -1 for an unknown prim.  Above
// solr_sweep_smem_limit() the launch is refused.
int64_t solr_sweep_smem_bytes(int closest, int prim, int block) {
  int words;
  if (prim < 0 || prim > 2 || block <= 0) return -1;
  if (closest)
    return prim == 0   ? staged_smem<WoopT, false>(block, &words)
           : prim == 1 ? staged_smem<SphereT, false>(block, &words)
                       : staged_smem<CylT, false>(block, &words);
  return prim == 0   ? staged_smem<WoopT, true>(block, &words)
         : prim == 1 ? staged_smem<SphereT, true>(block, &words)
                     : staged_smem<CylT, true>(block, &words);
}

int64_t solr_sweep_smem_limit() { return kMaxSmem; }

}  // extern "C"
