// The per-ray stackless BVH walk, for Hopper (sm_90a).  Built by nvcc
// into a shared library with a plain C interface and bound with ctypes
// (solr_tpu_torch/ops/bvh.py).
//
// Replaces the per-ray walks of solr_tpu/ops/bvh.py, which are
// lax.while_loops, not Pallas kernels:
//   solr_bvh_closest(prim)       <- bvh_closest_hit   (bvh.py:333)
//   solr_bvh_transmittance(prim) <- bvh_transmittance (bvh.py:397)
//   prim 0 = tri    (two-sided Moller-Trumbore, functor TriP)
//   prim 1 = sphere (functor SphereP)
//   prim 2 = cyl    (capped cylinder, functor CylP)
// each with the pool test of ops/intersect.py (triangle_t_p,
// sphere_t_p, cylinder_t_p -> packet.cyl_core), as the plain walks in
// ops/bvh.py run it.
//
// Design: one thread per ray, as in Sol-R's own CUDA walk
// (intersectionWithPrimitives).  Each ray carries its node pointer: a
// box it hits sends it to i + 1, a box it misses to skip[i], and the
// walk ends at n_nodes.  Node and primitive arrays are read through
// __ldg; the nodes of a 1M-triangle pool take 9.4 MB and stay in the
// 50 MB L2.  No state crosses threads: the walk is a data-dependent
// loop of gathers with no tile to share, which is why this is CUDA and
// not a block-structured Triton kernel.  What bounds it is the latency
// of those dependent node and primitive loads and the divergence of
// rays whose walks differ in length (rays arrive in pixel order); the
// counted f32 operations take 1-3% of the kernel's time at the card's
// rate (an H100 at 700 W, PERF.md).  This first design does nothing
// about either: a faster one is later work.
//
// Exactness with the plain PyTorch versions (ops/bvh.py):
//   * build with --fmad=false and without fast math: every chain keeps
//     the plain version's association ((x + y) + z for a dot product)
//     and every product rounds on its own; sqrtf and division are IEEE;
//   * inv_d = 1 / (|d| > 1e-12 ? d : 1e-12), which loses the sign of a
//     tiny negative component, as the reference does;
//   * the slab's min and max keep a NaN, as torch.minimum and maximum
//     do (fminf would drop it), so a NaN slab never hits;
//   * a box is hit when tn <= tf, tf >= t_min and tn <= limit, with
//     limit = min(best, t_max) for the closest hit and t_max for the
//     shadow walk;
//   * closest hit: in a leaf, the lanes with t <= limit compete in
//     ascending order with a strict <, so the lowest lane wins a tie;
//     across leaves a hit replaces the best only when strictly smaller,
//     so the earlier leaf in DFS order wins a tie;
//   * transmittance: a leaf's occluders (t < t_max; an emissive
//     material's factor is 1) multiply in ascending lane order into a
//     leaf product, which then multiplies into the ray's; the walk stops
//     once that is <= 1e-6.
// Each thread also counts the nodes it visited and the leaf lanes it
// tested; the plain versions count the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kTFar = 3.0e38f;
constexpr float kIntersectEps = 1.0e-8f;  // constants.INTERSECT_EPS

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.minimum / torch.maximum: a NaN in either operand gives NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float ld(const float* p, int64_t i) {
  return __ldg(p + i);
}

// The pools' arrays: p0/p1/p2 are (v0, v1, v2) for triangles, (center,
// radius, -) for spheres and (p0, p1, radius) for cylinders.
struct Pool {
  const float* p0;
  const float* p1;
  const float* p2;
  const int32_t* material;
};

// Two-sided Moller-Trumbore.  Mirrors intersect.triangle_t_p.
struct TriP {
  __device__ __forceinline__ static float hit(const Ray& r, const Pool& p,
                                              int64_t j, float t_min) {
    const float ax = ld(p.p0, 3 * j), ay = ld(p.p0, 3 * j + 1),
                az = ld(p.p0, 3 * j + 2);
    const float e1x = ld(p.p1, 3 * j) - ax, e1y = ld(p.p1, 3 * j + 1) - ay,
                e1z = ld(p.p1, 3 * j + 2) - az;
    const float e2x = ld(p.p2, 3 * j) - ax, e2y = ld(p.p2, 3 * j + 1) - ay,
                e2z = ld(p.p2, 3 * j + 2) - az;
    const float px = r.dy * e2z - r.dz * e2y;  // cross(d, e2)
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = (px * e1x + py * e1y) + pz * e1z;
    const bool safe = fabsf(det) > kIntersectEps;
    const float inv_det = (safe ? 1.0f : 0.0f) / (safe ? det : 1.0f);
    const float tx = r.ox - ax, ty = r.oy - ay, tz = r.oz - az;
    const float u = ((tx * px + ty * py) + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;  // cross(tvec, e1)
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = ((qx * r.dx + qy * r.dy) + qz * r.dz) * inv_det;
    const float t = ((qx * e2x + qy * e2y) + qz * e2z) * inv_det;
    const bool valid = safe && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
    return (valid && t > t_min) ? t : kTFar;
  }
};

// The nearest root > t_min (the exit root for a ray that starts
// inside); radius <= 0 never hits.  Mirrors intersect.sphere_t_p.
struct SphereP {
  __device__ __forceinline__ static float hit(const Ray& r, const Pool& p,
                                              int64_t j, float t_min) {
    const float ocx = r.ox - ld(p.p0, 3 * j);
    const float ocy = r.oy - ld(p.p0, 3 * j + 1);
    const float ocz = r.oz - ld(p.p0, 3 * j + 2);
    const float rad = ld(p.p1, j);
    const float b = (ocx * r.dx + ocy * r.dy) + ocz * r.dz;
    const float c0 = ((ocx * ocx + ocy * ocy) + ocz * ocz) - rad * rad;
    const float disc = b * b - c0;
    if (!((disc > 0.0f) && (rad > 0.0f))) return kTFar;
    const float sq = sqrtf(disc);
    const float lo = -b - sq, hi = -b + sq;
    return fminf(lo > t_min ? lo : kTFar, hi > t_min ? hi : kTFar);
  }
};

// Capped cylinder p0 -> p1: the side surface plus the two end disks,
// two-sided; radius <= 0 never hits.  Mirrors intersect.cylinder_t_p,
// which runs packet.cyl_core on (p0, r, axis = p1 - p0, |axis|^2).
struct CylP {
  __device__ __forceinline__ static float hit(const Ray& r, const Pool& p,
                                              int64_t j, float t_min) {
    const float p0x = ld(p.p0, 3 * j), p0y = ld(p.p0, 3 * j + 1),
                p0z = ld(p.p0, 3 * j + 2);
    const float ax = ld(p.p1, 3 * j) - p0x, ay = ld(p.p1, 3 * j + 1) - p0y,
                az = ld(p.p1, 3 * j + 2) - p0z;
    const float rad = ld(p.p2, j);
    const float h2 = (ax * ax + ay * ay) + az * az;
    const float inv_h2 = 1.0f / clamp_min(h2, kIntersectEps);
    const float rad_sq = rad * rad;
    const float ocx = r.ox - p0x, ocy = r.oy - p0y, ocz = r.oz - p0z;
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

struct Nodes {
  const float* aabb_min;  // (K, 3)
  const float* aabb_max;  // (K, 3)
  const int32_t* skip;
  const int32_t* first;  // -1 for inner nodes
  const int32_t* count;  // 0 for inner nodes
  int32_t n;
};

struct Walker {
  Ray r;
  float ix, iy, iz;  // 1 / d, guarded

  __device__ __forceinline__ void init(const float* o, const float* d,
                                       int64_t ray) {
    r.ox = o[3 * ray]; r.oy = o[3 * ray + 1]; r.oz = o[3 * ray + 2];
    r.dx = d[3 * ray]; r.dy = d[3 * ray + 1]; r.dz = d[3 * ray + 2];
    ix = 1.0f / (fabsf(r.dx) > 1e-12f ? r.dx : 1e-12f);
    iy = 1.0f / (fabsf(r.dy) > 1e-12f ? r.dy : 1e-12f);
    iz = 1.0f / (fabsf(r.dz) > 1e-12f ? r.dz : 1e-12f);
  }

  // intersect.aabb_hit of node i: [tn, tf] meets [t_min, limit].
  __device__ __forceinline__ bool box(const Nodes& nd, int32_t i, float t_min,
                                      float limit) const {
    const float* lo = nd.aabb_min + 3 * i;
    const float* hi = nd.aabb_max + 3 * i;
    const float x0 = (__ldg(lo) - r.ox) * ix, x1 = (__ldg(hi) - r.ox) * ix;
    const float y0 = (__ldg(lo + 1) - r.oy) * iy,
                y1 = (__ldg(hi + 1) - r.oy) * iy;
    const float z0 = (__ldg(lo + 2) - r.oz) * iz,
                z1 = (__ldg(hi + 2) - r.oz) * iz;
    const float tn =
        nan_max(nan_max(nan_min(x0, x1), nan_min(y0, y1)), nan_min(z0, z1));
    const float tf =
        nan_min(nan_min(nan_max(x0, x1), nan_max(y0, y1)), nan_max(z0, z1));
    return (tn <= tf) && (tf >= t_min) && (tn <= limit);
  }
};

template <class Prim>
__global__ void __launch_bounds__(kThreads)
    closest_walk(Nodes nd, Pool pool, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ t_max,
                 int64_t n_rays, float t_min, float* __restrict__ out_t,
                 int32_t* __restrict__ out_idx, int32_t* __restrict__ out_visits,
                 int32_t* __restrict__ out_tests) {
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (ray >= n_rays) return;
  Walker w;
  w.init(o, d, ray);
  const float tm = t_max[ray];
  float best = kTFar;
  int32_t best_i = 0, visits = 0, tests = 0;
  int32_t ptr = 0;
  while (ptr < nd.n) {
    ++visits;
    const float limit = nan_min(best, tm);
    const bool hit = w.box(nd, ptr, t_min, limit);
    const int32_t first = __ldg(nd.first + ptr);
    if (hit && first >= 0) {
      const int32_t cnt = __ldg(nd.count + ptr);
      tests += cnt;
      float lm = kTFar;
      int32_t la = 0;
      for (int32_t j = 0; j < cnt; ++j) {
        const float t = Prim::hit(w.r, pool, first + j, t_min);
        if (t <= limit && t < lm) {
          lm = t;
          la = j;
        }
      }
      if (lm < best) {
        best = lm;
        best_i = first + la;
      }
    }
    ptr = (hit && first < 0) ? ptr + 1 : __ldg(nd.skip + ptr);
  }
  out_t[ray] = best;
  out_idx[ray] = best_i;
  out_visits[ray] = visits;
  out_tests[ray] = tests;
}

template <class Prim>
__global__ void __launch_bounds__(kThreads)
    trans_walk(Nodes nd, Pool pool, const float* __restrict__ emission,
               const float* __restrict__ transparency,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, int64_t n_rays, float t_min,
               float* __restrict__ out_tr, int32_t* __restrict__ out_visits,
               int32_t* __restrict__ out_tests) {
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (ray >= n_rays) return;
  Walker w;
  w.init(o, d, ray);
  const float tm = t_max[ray];
  float tr = 1.0f;
  int32_t visits = 0, tests = 0;
  int32_t ptr = 0;
  while (ptr < nd.n) {
    ++visits;
    const bool hit = w.box(nd, ptr, t_min, tm);
    const int32_t first = __ldg(nd.first + ptr);
    if (hit && first >= 0) {
      const int32_t cnt = __ldg(nd.count + ptr);
      tests += cnt;
      float prod = 1.0f;
      for (int32_t j = 0; j < cnt; ++j) {
        const float t = Prim::hit(w.r, pool, first + j, t_min);
        if (t < tm) {
          const int32_t m = __ldg(pool.material + first + j);
          prod = prod *
                 (__ldg(emission + m) > 0.0f ? 1.0f : __ldg(transparency + m));
        }
      }
      tr = tr * prod;
    }
    ptr = (hit && first < 0) ? ptr + 1 : __ldg(nd.skip + ptr);
    if (tr <= 1e-6f) break;
  }
  out_tr[ray] = tr;
  out_visits[ray] = visits;
  out_tests[ray] = tests;
}

unsigned grid_for(int64_t n_rays) {
  return static_cast<unsigned>((n_rays + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// prim: 0 = tri, 1 = sphere, 2 = cyl.  All pointers are device pointers
// to contiguous arrays: the BVH's aabb_min, aabb_max (n_nodes, 3) f32
// and skip, first_prim, prim_count (n_nodes) i32; the pool's arrays
// p0, p1, p2 (v0, v1, v2 for tri; center, radius, unused for sphere;
// p0, p1, radius for cyl) f32 and material (i32, read by the shadow
// walk with the materials' emission and transparency f32); the rays'
// o, d (n_rays, 3) and t_max (n_rays) f32.  Outputs (n_rays): out_t /
// out_tr f32, out_idx i32 (closest hit), out_visits and out_tests i32.
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for an unknown prim.
int solr_bvh_closest(int prim, const float* aabb_min, const float* aabb_max,
                     const int32_t* skip, const int32_t* first,
                     const int32_t* count, int n_nodes, const float* p0,
                     const float* p1, const float* p2, const int32_t* material,
                     const float* o, const float* d, const float* t_max,
                     int64_t n_rays, float t_min, float* out_t,
                     int32_t* out_idx, int32_t* out_visits, int32_t* out_tests,
                     void* stream) {
  if (prim < 0 || prim > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const Nodes nd{aabb_min, aabb_max, skip, first, count, n_nodes};
  const Pool pool{p0, p1, p2, material};
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n_rays);
  if (prim == 0)
    closest_walk<TriP><<<grid, kThreads, 0, s>>>(
        nd, pool, o, d, t_max, n_rays, t_min, out_t, out_idx, out_visits,
        out_tests);
  else if (prim == 1)
    closest_walk<SphereP><<<grid, kThreads, 0, s>>>(
        nd, pool, o, d, t_max, n_rays, t_min, out_t, out_idx, out_visits,
        out_tests);
  else
    closest_walk<CylP><<<grid, kThreads, 0, s>>>(
        nd, pool, o, d, t_max, n_rays, t_min, out_t, out_idx, out_visits,
        out_tests);
  return static_cast<int>(cudaGetLastError());
}

int solr_bvh_transmittance(int prim, const float* aabb_min,
                           const float* aabb_max, const int32_t* skip,
                           const int32_t* first, const int32_t* count,
                           int n_nodes, const float* p0, const float* p1,
                           const float* p2, const int32_t* material,
                           const float* emission, const float* transparency,
                           const float* o, const float* d, const float* t_max,
                           int64_t n_rays, float t_min, float* out_tr,
                           int32_t* out_visits, int32_t* out_tests,
                           void* stream) {
  if (prim < 0 || prim > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const Nodes nd{aabb_min, aabb_max, skip, first, count, n_nodes};
  const Pool pool{p0, p1, p2, material};
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n_rays);
  if (prim == 0)
    trans_walk<TriP><<<grid, kThreads, 0, s>>>(
        nd, pool, emission, transparency, o, d, t_max, n_rays, t_min, out_tr,
        out_visits, out_tests);
  else if (prim == 1)
    trans_walk<SphereP><<<grid, kThreads, 0, s>>>(
        nd, pool, emission, transparency, o, d, t_max, n_rays, t_min, out_tr,
        out_visits, out_tests);
  else
    trans_walk<CylP><<<grid, kThreads, 0, s>>>(
        nd, pool, emission, transparency, o, d, t_max, n_rays, t_min, out_tr,
        out_visits, out_tests);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
