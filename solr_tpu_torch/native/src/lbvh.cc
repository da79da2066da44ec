// Native host-side LBVH builder (this package's copy of
// solr_tpu/native/src/lbvh.cc) -- the analog of the reference's C++
// CPU-side acceleration-structure build (solr/engines/GPUKernel.cpp:
// compactBoxes / processBoxes / processOutterBoxes).  It produces an
// N-level Morton-ordered median-split LBVH flattened in DFS preorder
// with skip ("rope") pointers, node for node the tree of the numpy
// builder in solr_tpu_torch/ops/bvh.py.
//
// Exposed as a C ABI for ctypes.  The Python wrapper
// (solr_tpu_torch/native/__init__.py) compiles this file at first use
// with g++ and raises when it cannot.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t expand_bits(uint64_t v) {
  // Spread the low 10 bits of v to every 3rd bit (Morton helper) —
  // bit-identical to solr_tpu_torch.ops.bvh._expand_bits.
  v = (v * 0x00010001ull) & 0xFF0000FFull;
  v = (v * 0x00000101ull) & 0x0F00F00Full;
  v = (v * 0x00000011ull) & 0xC30C30C3ull;
  v = (v * 0x00000005ull) & 0x49249249ull;
  return v;
}

struct Frame {
  int32_t start, end, depth;
  int32_t node;   // preorder index of this frame's node
  int phase;      // 0 = expand children, 1 = set skip
};

constexpr float kAabbPad = 1e-5f;  // matches bvh._AABB_PAD

}  // namespace

extern "C" {

// Builds the LBVH.  Inputs: per-primitive AABBs (n,3) row-major float32.
// Outputs (caller-allocated): `order` (n) — the Morton permutation such
// that leaf [first, first+count) ranges index pool[order]; node arrays
// starts/ends/skips/depths (cap) and nmin/nmax (cap,3).
// Returns the node count, -1 if cap is too small, -2 on bad arguments.
int64_t solr_lbvh_build(const float* aabb_min, const float* aabb_max,
                        int64_t n, int32_t leaf_size, int32_t* order,
                        int32_t* starts, int32_t* ends, int32_t* skips,
                        int32_t* depths, float* nmin, float* nmax,
                        int64_t cap) {
  if (n <= 0 || leaf_size <= 0 || cap <= 0) return -2;

  // --- Morton codes over quantized centroids (1024^3 grid) ----------------
  std::vector<float> cx(n), cy(n), cz(n);
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int64_t i = 0; i < n; ++i) {
    const float c[3] = {0.5f * (aabb_min[3 * i + 0] + aabb_max[3 * i + 0]),
                        0.5f * (aabb_min[3 * i + 1] + aabb_max[3 * i + 1]),
                        0.5f * (aabb_min[3 * i + 2] + aabb_max[3 * i + 2])};
    cx[i] = c[0]; cy[i] = c[1]; cz[i] = c[2];
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], c[k]);
      hi[k] = std::max(hi[k], c[k]);
    }
  }
  float span[3];
  for (int k = 0; k < 3; ++k) span[k] = std::max(hi[k] - lo[k], 1e-12f);

  std::vector<uint64_t> code(n);
  for (int64_t i = 0; i < n; ++i) {
    const float c[3] = {cx[i], cy[i], cz[i]};
    uint32_t q[3];
    for (int k = 0; k < 3; ++k) {
      float f = (c[k] - lo[k]) / span[k] * 1023.0f;
      f = std::min(std::max(f, 0.0f), 1023.0f);
      q[k] = static_cast<uint32_t>(f);
    }
    code[i] = (expand_bits(q[0]) << 2) | (expand_bits(q[1]) << 1) |
              expand_bits(q[2]);
  }
  std::vector<int32_t> ord(n);
  for (int64_t i = 0; i < n; ++i) ord[i] = static_cast<int32_t>(i);
  std::stable_sort(ord.begin(), ord.end(),
                   [&](int32_t a, int32_t b) { return code[a] < code[b]; });
  std::memcpy(order, ord.data(), sizeof(int32_t) * n);

  // --- Preorder median-split build (iterative; no recursion limit) --------
  int64_t k = 0;
  std::vector<Frame> stack;
  stack.push_back({0, static_cast<int32_t>(n), 0, -1, 0});
  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    if (f.phase == 1) {
      skips[f.node] = static_cast<int32_t>(k);
      continue;
    }
    if (k >= cap) return -1;
    const int32_t node = static_cast<int32_t>(k++);
    starts[node] = f.start;
    ends[node] = f.end;
    depths[node] = f.depth;
    skips[node] = -1;
    // phase-1 frame fires after this node's whole subtree is emitted.
    stack.push_back({f.start, f.end, f.depth, node, 1});
    if (f.end - f.start > leaf_size) {
      const int32_t mid = (f.start + f.end) / 2;
      // Right child pushed first so the left is emitted first (preorder).
      stack.push_back({mid, f.end, f.depth + 1, -1, 0});
      stack.push_back({f.start, mid, f.depth + 1, -1, 0});
    }
  }

  // --- Node AABBs: leaves from sorted prims, inner via reverse pass -------
  for (int64_t i = 0; i < k; ++i) {
    const bool is_leaf = (ends[i] - starts[i]) <= leaf_size;
    if (!is_leaf) continue;
    float mn[3] = {INFINITY, INFINITY, INFINITY};
    float mx[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int32_t p = starts[i]; p < ends[i]; ++p) {
      const int32_t src = ord[p];
      for (int c = 0; c < 3; ++c) {
        mn[c] = std::min(mn[c], aabb_min[3 * src + c]);
        mx[c] = std::max(mx[c], aabb_max[3 * src + c]);
      }
    }
    for (int c = 0; c < 3; ++c) {
      nmin[3 * i + c] = mn[c];
      nmax[3 * i + c] = mx[c];
    }
  }
  for (int64_t i = k - 1; i >= 0; --i) {
    const bool is_leaf = (ends[i] - starts[i]) <= leaf_size;
    if (is_leaf) continue;
    const int64_t left = i + 1;
    const int64_t right = skips[left];
    for (int c = 0; c < 3; ++c) {
      nmin[3 * i + c] = std::min(nmin[3 * left + c], nmin[3 * right + c]);
      nmax[3 * i + c] = std::max(nmax[3 * left + c], nmax[3 * right + c]);
    }
  }
  for (int64_t i = 0; i < 3 * k; ++i) {
    nmin[i] -= kAabbPad;
    nmax[i] += kAabbPad;
  }
  return k;
}

// Per-pool AABB computation for triangle soups — the other host-side
// hot loop the reference runs in C++ when meshes load (GPUKernel.cpp
// triangle bound updates inside processBoxes).  v0/v1/v2 are (n,3).
void solr_triangle_aabbs(const float* v0, const float* v1, const float* v2,
                         int64_t n, float* out_min, float* out_max) {
  for (int64_t i = 0; i < 3 * n; ++i) {
    out_min[i] = std::min(v0[i], std::min(v1[i], v2[i]));
    out_max[i] = std::max(v0[i], std::max(v1[i], v2[i]));
  }
}

}  // extern "C"
