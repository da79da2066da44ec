// The per-ray BVH walks, for Hopper (sm_90a).  Built by nvcc into a
// shared library with a plain C interface and bound with ctypes
// (solr_tpu_torch/ops/bvh.py).
//
// Replaces the per-ray walks of solr_tpu/ops/bvh.py, which are
// lax.while_loops, not Pallas kernels:
//   solr_bvh_closest_packed        <- bvh_closest_hit   (bvh.py:333)
//   solr_bvh_transmittance_packed  <- bvh_transmittance (bvh.py:397)
// for prim 0 = triangle, 1 = sphere, 2 = cylinder (bvh.PRIMS), each
// with the pool test of ops/intersect.py (triangle_t_p, sphere_t_p,
// cylinder_t_p -> packet.cyl_core), as the plain walks in ops/bvh.py
// run it.
//
// What bounds a walk is the latency of its dependent node and
// primitive loads and the divergence of rays whose walks differ in
// length; the counted f32 operations take 1-7% of the kernel's time at
// the card's rate (an H100 at 700 W, PERF.md).
//
// One walk design over three leaf tests (closest_pairs and trans_pairs
// over TriRow, SphereRow or CylRow), after Aila & Laine (2009),
// "Understanding the efficiency of ray traversal on GPUs":
//   * one inner node is one 64-byte row of four float4s holding both
//     children's boxes and references (bvh.pack_nodes): a visit is four
//     16-byte loads from one cache line and slab-tests both children;
//     row 0 holds the root's box and reference;
//   * a primitive is one row of float4s in the pool's order, which is
//     leaf order (a leaf's lanes are contiguous rows), with what its
//     test derives from the primitive alone already computed and its
//     shadow factor: a triangle's v0, e1 = v1 - v0, e2 = v2 - v0
//     (bvh.pack_triangles, 48 bytes); a sphere's centre, radius and
//     radius^2 (bvh.pack_spheres, 32 bytes); a cylinder's p0, radius,
//     axis = p1 - p0, |axis|^2, 1 / max(|axis|^2, 1e-8) and radius^2
//     (bvh.pack_cylinders, 48 bytes);
//   * the closest hit enters, of two hit children, the left one first
//     (kNearFirst false: the DFS walk's order) or the one with the
//     smaller entry distance tn (kNearFirst true), and pushes the other
//     with its tn onto a per-thread stack (bvh.max_depth + 1 deep, in
//     local memory); a popped entry is dropped when its tn > min(best,
//     t_max).  A leaf replaces the best when its hit is nearer, or
//     equally near with a lower pool row, so the result is the
//     lexicographic minimum (t, row) whatever order the leaves come in.
//     Left child first returns the DFS walk's t and idx on any tree,
//     whatever its leaf boxes hold: the leaves come in the DFS walk's
//     order, in ascending rows, and the limit only falls.  Near first
//     returns them only while every leaf box holds its primitives;
//   * the dispatch's order rule (bvh.bvh_closest_hit): triangles walk
//     near child first while their leaf boxes hold
//     (bvh.leaf_boxes_hold), else left child first; spheres and
//     cylinders always walk left child first;
//   * the shadow walk keeps the DFS order, left child first, with the
//     same stack: its leaf products multiply into tr in the DFS walk's
//     order and it stops at the same leaf.  It counts a node when the
//     DFS walk would reach it, so its visits are the DFS walk's.
// One thread per ray, rays in the caller's order.
//
// Exactness with the plain PyTorch versions (ops/bvh.py):
//   * build with --fmad=false and without fast math: every chain keeps
//     the plain version's association ((x + y) + z for a dot product)
//     and every product rounds on its own; sqrtf and division are IEEE;
//     the packed rows' derived terms are the plain test's own f32
//     operations, run by PyTorch;
//   * inv_d = 1 / (|d| > 1e-12 ? d : 1e-12), which loses the sign of a
//     tiny negative component, as the reference does;
//   * the slab's min and max keep a NaN, as torch.minimum and maximum
//     do (fminf would drop it), so a NaN slab never hits;
//   * a box is hit when tn <= tf, tf >= t_min and tn <= limit, with
//     limit = min(best, t_max) for the closest hit and t_max for the
//     shadow walk;
//   * closest hit: in a leaf, the lanes with t <= limit compete in
//     ascending order with a strict <, so the lowest lane wins a tie;
//     across leaves by the rule above;
//   * transmittance: a leaf's occluders (t < t_max; an emissive
//     material's factor is 1) multiply in ascending lane order into a
//     leaf product, which then multiplies into the ray's; the walk stops
//     once that is <= 1e-6.
// Each thread also counts the nodes it visited and the leaf lanes it
// tested; the plain versions count the same (the closest hits:
// bvh_closest_hit_ordered_plain in their order).

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

  // intersect.aabb_hit of the box lo..hi: [tn, tf] meets [t_min,
  // limit].  Also returns tn, the box's entry distance.
  __device__ __forceinline__ bool slab(float lox, float loy, float loz,
                                       float hix, float hiy, float hiz,
                                       float t_min, float limit,
                                       float& tn) const {
    const float x0 = (lox - r.ox) * ix, x1 = (hix - r.ox) * ix;
    const float y0 = (loy - r.oy) * iy, y1 = (hiy - r.oy) * iy;
    const float z0 = (loz - r.oz) * iz, z1 = (hiz - r.oz) * iz;
    tn = nan_max(nan_max(nan_min(x0, x1), nan_min(y0, y1)), nan_min(z0, z1));
    const float tf =
        nan_min(nan_min(nan_max(x0, x1), nan_max(y0, y1)), nan_max(z0, z1));
    return (tn <= tf) && (tf >= t_min) && (tn <= limit);
  }
};

// Deepest stack a walk keeps: bvh.max_depth + 1 entries, at
// most this many (the wrapper checks; a median-split tree over 2^31
// rows in leaves of 8 is 29 levels deep).
constexpr int kMaxStack = 32;

// Row r of the packed nodes (bvh.pack_nodes), four float4s:
//   q0 = (c0.lo.x, c0.lo.y, c0.lo.z, c0.hi.x)
//   q1 = (c0.hi.y, c0.hi.z, c1.lo.x, c1.lo.y)
//   q2 = (c1.lo.z, c1.hi.x, c1.hi.y, c1.hi.z)
//   q3 = (ref0, ref1, count0, count1) as int32 bits
// for the left child c0 and the right child c1.  A reference > 0 is
// the row of an inner child; a leaf's is ~first (< 0) with its count.
// Row 0 holds the root as its c0 (the rest unused).
struct Row {
  float4 q0, q1, q2, q3;
};

__device__ __forceinline__ Row load_row(const float4* nodes, int32_t r) {
  const float4* p = nodes + 4 * static_cast<int64_t>(r);
  return Row{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}

__device__ __forceinline__ bool hit0(const Walker& w, const Row& n,
                                     float t_min, float limit, float& tn) {
  return w.slab(n.q0.x, n.q0.y, n.q0.z, n.q0.w, n.q1.x, n.q1.y, t_min, limit,
                tn);
}

__device__ __forceinline__ bool hit1(const Walker& w, const Row& n,
                                     float t_min, float limit, float& tn) {
  return w.slab(n.q1.z, n.q1.w, n.q2.x, n.q2.y, n.q2.z, n.q2.w, t_min, limit,
                tn);
}

// Two-sided Moller-Trumbore on pool row j of the packed triangles
// (bvh.pack_triangles): (v0.xyz, e1.x), (e1.yz, e2.xy), (e2.z, factor,
// 0, 0), with e1 = v1 - v0 and e2 = v2 - v0 rounded as
// intersect.triangle_t_p rounds them.  Mirrors triangle_t_p; sets the
// row's shadow factor.
struct TriRow {
  __device__ __forceinline__ static float hit(const Ray& r,
                                              const float4* rows, int64_t j,
                                              float t_min, float& factor) {
    const float4 a = __ldg(rows + 3 * j), b = __ldg(rows + 3 * j + 1),
                 c = __ldg(rows + 3 * j + 2);
    const float ax = a.x, ay = a.y, az = a.z;
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = c.x;
    factor = c.y;
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

// The nearer root > t_min of the sphere on pool row j of the packed
// spheres (bvh.pack_spheres): (center.xyz, r), (r * r, factor, 0, 0),
// with r * r rounded as intersect.sphere_t_p rounds it; the exit root
// for a ray that starts inside; radius <= 0 never hits.  Mirrors
// sphere_t_p; sets the row's shadow factor.
struct SphereRow {
  __device__ __forceinline__ static float hit(const Ray& r,
                                              const float4* rows, int64_t j,
                                              float t_min, float& factor) {
    const float4 a = __ldg(rows + 2 * j), b = __ldg(rows + 2 * j + 1);
    const float rad = a.w, rad_sq = b.x;
    factor = b.y;
    const float ocx = r.ox - a.x, ocy = r.oy - a.y, ocz = r.oz - a.z;
    const float qb = (ocx * r.dx + ocy * r.dy) + ocz * r.dz;
    const float c0 = ((ocx * ocx + ocy * ocy) + ocz * ocz) - rad_sq;
    const float disc = qb * qb - c0;
    if (!((disc > 0.0f) && (rad > 0.0f))) return kTFar;
    const float sq = sqrtf(disc);
    const float lo = -qb - sq, hi = -qb + sq;
    return fminf(lo > t_min ? lo : kTFar, hi > t_min ? hi : kTFar);
  }
};

// Capped cylinder p0 -> p1 (the side surface plus the two end disks,
// two-sided; radius <= 0 never hits) on pool row j of the packed
// cylinders (bvh.pack_cylinders): (p0.xyz, r), (axis.xyz, h2),
// (1 / max(h2, 1e-8), r * r, factor, 0), with axis = p1 - p0 and h2 =
// (x * x + y * y) + z * z rounded as intersect.cylinder_t_p rounds
// them.  Mirrors packet.cyl_core on those terms; sets the row's shadow
// factor.
struct CylRow {
  __device__ __forceinline__ static float hit(const Ray& r,
                                              const float4* rows, int64_t j,
                                              float t_min, float& factor) {
    const float4 a = __ldg(rows + 3 * j), b = __ldg(rows + 3 * j + 1),
                 c = __ldg(rows + 3 * j + 2);
    const float rad = a.w;
    const float ax = b.x, ay = b.y, az = b.z, h2 = b.w;
    const float inv_h2 = c.x, rad_sq = c.y;
    factor = c.z;
    const float ocx = r.ox - a.x, ocy = r.oy - a.y, ocz = r.oz - a.z;
    const float d_a = (r.dx * ax + r.dy * ay) + r.dz * az;
    const float oc_a = (ocx * ax + ocy * ay) + ocz * az;
    const float qa = 1.0f - (d_a * d_a) * inv_h2;
    const float qb =
        ((ocx * r.dx + ocy * r.dy) + ocz * r.dz) - (d_a * oc_a) * inv_h2;
    const float qc = (((ocx * ocx + ocy * ocy) + ocz * ocz) -
                      (oc_a * oc_a) * inv_h2) - rad_sq;
    const float safe_a = clamp_min(qa, kIntersectEps);
    const float disc = qb * qb - safe_a * qc;
    const bool base = (disc > 0.0f) && (qa > kIntersectEps) && (rad > 0.0f);
    float t_side = kTFar;
    if (base) {
      const float sq = sqrtf(disc);
      float t1 = (-qb - sq) / safe_a;
      float t2 = (-qb + sq) / safe_a;
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

// The closest hit over packed nodes and the rows of Leaf: near child
// first when kNearFirst, else left child first (the DFS walk's order).
template <class Leaf, bool kNearFirst>
__global__ void __launch_bounds__(kThreads)
    closest_pairs(const float4* __restrict__ nodes,
                  const float4* __restrict__ rows, const float* __restrict__ o,
                  const float* __restrict__ d, const float* __restrict__ t_max,
                  int64_t n_rays, float t_min, float* __restrict__ out_t,
                  int32_t* __restrict__ out_idx,
                  int32_t* __restrict__ out_visits,
                  int32_t* __restrict__ out_tests) {
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (ray >= n_rays) return;
  Walker w;
  w.init(o, d, ray);
  const float tm = t_max[ray];
  float best = kTFar;
  int32_t best_i = 0, visits = 1, tests = 0;
  int32_t st_ref[kMaxStack], st_cnt[kMaxStack];
  float st_tn[kMaxStack];
  int sp = 0;
  const Row root = load_row(nodes, 0);
  int32_t ref = __float_as_int(root.q3.x), cnt = __float_as_int(root.q3.z);
  float tn;
  bool go = hit0(w, root, t_min, nan_min(best, tm), tn);
  while (true) {
    if (go) {
      if (ref < 0) {  // a leaf: its lanes, then the tie rule
        const int32_t first = ~ref;
        const float limit = nan_min(best, tm);
        tests += cnt;
        float lm = kTFar, f;
        int32_t la = 0;
        for (int32_t j = 0; j < cnt; ++j) {
          const float t = Leaf::hit(w.r, rows, first + j, t_min, f);
          if (t <= limit && t < lm) {
            lm = t;
            la = j;
          }
        }
        if (lm < best ||
            (lm == best && best < kTFar && first + la < best_i)) {
          best = lm;
          best_i = first + la;
        }
      } else {  // an inner node: both children, in the walk's order
        const Row n = load_row(nodes, ref);
        const float limit = nan_min(best, tm);
        float tn0, tn1;
        const bool h0 = hit0(w, n, t_min, limit, tn0);
        const bool h1 = hit1(w, n, t_min, limit, tn1);
        visits += 2;
        const int32_t r0 = __float_as_int(n.q3.x), r1 = __float_as_int(n.q3.y);
        const int32_t c0 = __float_as_int(n.q3.z), c1 = __float_as_int(n.q3.w);
        if (h0 && h1) {
          const bool right = kNearFirst && tn1 < tn0;  // the right is nearer
          st_ref[sp] = right ? r0 : r1;
          st_cnt[sp] = right ? c0 : c1;
          st_tn[sp] = right ? tn0 : tn1;
          ++sp;
          ref = right ? r1 : r0;
          cnt = right ? c1 : c0;
          continue;
        }
        if (h0 || h1) {
          ref = h0 ? r0 : r1;
          cnt = h0 ? c0 : c1;
          continue;
        }
      }
    }
    // The latest pending child that may still hold a hit <= the limit.
    const float limit = nan_min(best, tm);
    go = false;
    while (sp > 0) {
      --sp;
      if (st_tn[sp] <= limit) {
        ref = st_ref[sp];
        cnt = st_cnt[sp];
        go = true;
        break;
      }
    }
    if (!go) break;
  }
  out_t[ray] = best;
  out_idx[ray] = best_i;
  out_visits[ray] = visits;
  out_tests[ray] = tests;
}

// The shadow walk over packed nodes and the rows of Leaf, in DFS order.
template <class Leaf>
__global__ void __launch_bounds__(kThreads)
    trans_pairs(const float4* __restrict__ nodes,
                const float4* __restrict__ rows, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ t_max,
                int64_t n_rays, float t_min, float* __restrict__ out_tr,
                int32_t* __restrict__ out_visits,
                int32_t* __restrict__ out_tests) {
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (ray >= n_rays) return;
  Walker w;
  w.init(o, d, ray);
  const float tm = t_max[ray];
  float tr = 1.0f;
  int32_t visits = 1, tests = 0;
  // A pushed right child, and the missed right children the DFS walk
  // reaches between it and the entry below (pend, counted on the pop
  // or at the end; not after the stop).
  int32_t st_ref[kMaxStack], st_cnt[kMaxStack], st_pend[kMaxStack];
  int sp = 0, pend = 0;
  const Row root = load_row(nodes, 0);
  int32_t ref = __float_as_int(root.q3.x), cnt = __float_as_int(root.q3.z);
  float tn;
  bool go = hit0(w, root, t_min, tm, tn);
  while (true) {
    if (go) {
      if (ref < 0) {  // a leaf: its product, in lane order
        const int32_t first = ~ref;
        tests += cnt;
        float prod = 1.0f, f;
        for (int32_t j = 0; j < cnt; ++j) {
          const float t = Leaf::hit(w.r, rows, first + j, t_min, f);
          if (t < tm) prod = prod * f;
        }
        tr = tr * prod;
        if (tr <= 1e-6f) break;
      } else {  // an inner node: the left child's subtree first
        const Row n = load_row(nodes, ref);
        float tn0, tn1;
        const bool h0 = hit0(w, n, t_min, tm, tn0);
        const bool h1 = hit1(w, n, t_min, tm, tn1);
        const int32_t r0 = __float_as_int(n.q3.x), r1 = __float_as_int(n.q3.y);
        const int32_t c0 = __float_as_int(n.q3.z), c1 = __float_as_int(n.q3.w);
        ++visits;  // the left child
        if (h0) {
          if (h1) {
            st_ref[sp] = r1;
            st_cnt[sp] = c1;
            st_pend[sp] = pend;
            ++sp;
            pend = 0;
          } else {
            ++pend;
          }
          ref = r0;
          cnt = c0;
          continue;
        }
        ++visits;  // the right child, at once
        if (h1) {
          ref = r1;
          cnt = c1;
          continue;
        }
      }
    }
    if (sp == 0) {
      visits += pend;
      break;
    }
    --sp;
    visits += pend + 1;
    pend = st_pend[sp];
    ref = st_ref[sp];
    cnt = st_cnt[sp];
    go = true;
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

// The walks.  prim: 0 = triangle, 1 = sphere, 2 = cylinder
// (bvh.PRIMS); near_first: 1 for the closest hit near child first, 0
// for left child first.  nodes: the packed rows (bvh.pack_nodes, (rows,
// 4, 4) f32, 16-byte aligned); rows: the packed primitives
// (bvh.pack_triangles or bvh.pack_cylinders, (N, 3, 4) f32;
// bvh.pack_spheres, (N, 2, 4) f32; 16-byte aligned); the rays' o, d
// (n_rays, 3) and t_max (n_rays) f32.  Outputs (n_rays): out_t / out_tr
// f32, out_idx i32 (closest hit), out_visits and out_tests i32.  The
// tree must be at most kMaxStack - 1 levels deep (the wrapper checks).
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for another prim.
int solr_bvh_closest_packed(int prim, int near_first, const float* nodes,
                            const float* rows, const float* o, const float* d,
                            const float* t_max, int64_t n_rays, float t_min,
                            float* out_t, int32_t* out_idx,
                            int32_t* out_visits, int32_t* out_tests,
                            void* stream) {
  if (prim < 0 || prim > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  auto kernel =
      prim == 0   ? (near_first ? closest_pairs<TriRow, true>
                                : closest_pairs<TriRow, false>)
      : prim == 1 ? (near_first ? closest_pairs<SphereRow, true>
                                : closest_pairs<SphereRow, false>)
                  : (near_first ? closest_pairs<CylRow, true>
                                : closest_pairs<CylRow, false>);
  kernel<<<grid_for(n_rays), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(rows), o, d, t_max, n_rays, t_min,
      out_t, out_idx, out_visits, out_tests);
  return static_cast<int>(cudaGetLastError());
}

int solr_bvh_transmittance_packed(int prim, const float* nodes,
                                  const float* rows, const float* o,
                                  const float* d, const float* t_max,
                                  int64_t n_rays, float t_min, float* out_tr,
                                  int32_t* out_visits, int32_t* out_tests,
                                  void* stream) {
  if (prim < 0 || prim > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  auto kernel = prim == 0   ? trans_pairs<TriRow>
                : prim == 1 ? trans_pairs<SphereRow>
                            : trans_pairs<CylRow>;
  kernel<<<grid_for(n_rays), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(rows), o, d, t_max, n_rays, t_min,
      out_tr, out_visits, out_tests);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
