// The backward of the pool-row gathers, for Hopper (sm_90a).  Built by
// nvcc into a shared library with a plain C interface and bound with
// ctypes (solr_tpu_torch/ops/gather.py).
//
// Replaces no TPU kernel: the reference differentiates its gathers
// (table[idx] in solr_tpu/ops/traverse.py and shade.py) through XLA,
// whose transpose of a gather is a scatter-add.  The port had left that
// transpose to PyTorch's accumulating index backward, which sorts the
// indices and then walks each run of equal indices with one warp, row
// after row: the gradient step's gathers pile hundreds of thousands of
// rows onto a few indices, and that walk took most of the step.
//
// gather_rows_bwd: out (n, W) += g (rows, W) at idx (rows), for W = 1-4
// f32 or f64 values and int64 indices; out comes in zeroed.  What bounds it is bytes:
// each row of g and its index read once, each touched entry of out
// written once (PERF.md).  Its design against duplicate indices:
//   * each warp takes 32 rows at a time, one row in each lane's
//     registers;
//   * a row whose gradient is exactly zero in every component drops
//     out: the rays that did not hit a pool still gather its row (the
//     index is clamped into the pool) and torch.where zeroed their
//     gradient; adding +0 or -0 to an accumulator that starts at +0
//     changes no bit;
//   * __match_any_sync groups the lanes of equal index; a shuffle tree
//     by rank within the group sums each group into its lowest lane,
//     which makes the group's one add;
//   * where the table fits kSharedBytes (the sphere, radius and
//     material tables), the adds go to a copy of the table in the CTA's
//     shared memory, and the CTA adds its copy to out once, one global
//     atomic per nonzero entry, with at most kCtasPerSm CTAs a
//     multiprocessor; else (a 999,698-row vertex table, whose remaining
//     duplicates are few) each group adds straight to out with global
//     atomics.
// The atomics make the sum of equal indices come in another order from
// run to run, as XLA's scatter-add does on a GPU, and float atomics
// flush a subnormal value to zero (an error under 2^-126 an add); the
// CPU path
// (index_add_, in row order) is the plain version.  An index outside
// [0, n) drops its row (the CPU path raises there).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// A table of up to this many bytes is summed in shared memory: 48 KB,
// the dynamic shared memory a CTA gets without opting in.
constexpr int64_t kSharedBytes = 49152;
constexpr int kCtasPerSm = 2;

template <typename T, int W, bool kShared>
__global__ void __launch_bounds__(kThreads)
    gather_rows_bwd(const T* __restrict__ g, const int64_t* __restrict__ idx,
                    int64_t rows, int64_t n, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* smem = reinterpret_cast<T*>(smem_bytes);
  if (kShared) {
    for (int64_t k = threadIdx.x; k < n * W; k += kThreads) smem[k] = T(0);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const unsigned above = lane == 31 ? 0u : kFull << (lane + 1);
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x) >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = warp * 32 + lane; r - lane < rows; r += stride) {
    T v[W];
    long long key = -1;  // -1: no add (past the end, a zero row, out of range)
    bool nonzero = false;
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < W; ++c) {
        v[c] = g[r * W + c];
        nonzero |= v[c] != T(0);  // a NaN counts as nonzero
      }
      const int64_t i = idx[r];
      if (nonzero && i >= 0 && i < n) key = i;
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c) v[c] = T(0);
    }
    const unsigned peers = __match_any_sync(kFull, key);
    const int rank = __popc(peers & ~(kFull << lane));
    // Round s: the lane of rank k * 2s adds what the lane of rank
    // k * 2s + s holds (the s-th lane of the group above it), which
    // already holds its own s ranks' sum.
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      unsigned m = peers & above;
      for (int k = 1; k < s; ++k) m &= m - 1;
      const int src = m ? __ffs(m) - 1 : lane;
      const bool take = m != 0u && (rank & (2 * s - 1)) == 0;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const T o = __shfl_sync(kFull, v[c], src);
        if (take) v[c] += o;
      }
    }
    if (key >= 0 && rank == 0) {
      T* dst = (kShared ? smem : out) + key * W;
#pragma unroll
      for (int c = 0; c < W; ++c) atomicAdd(dst + c, v[c]);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int64_t k = threadIdx.x; k < n * W; k += kThreads) {
      const T a = smem[k];
      if (a != T(0)) atomicAdd(out + k, a);
    }
  }
}

template <typename T, int W>
cudaError_t launch(const void* g, const int64_t* idx, int64_t rows,
                   int64_t n, void* out, cudaStream_t stream) {
  const T* gt = static_cast<const T*>(g);
  T* outt = static_cast<T*>(out);
  int64_t blocks = (rows + kThreads - 1) / kThreads;
  const int64_t bytes = n * W * static_cast<int64_t>(sizeof(T));
  if (bytes <= kSharedBytes) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    blocks = std::min(blocks, static_cast<int64_t>(sms) * kCtasPerSm);
    const unsigned grid = static_cast<unsigned>(blocks);
    auto kernel = gather_rows_bwd<T, W, true>;
    kernel<<<grid, kThreads, bytes, stream>>>(gt, idx, rows, n, outt);
  } else {
    const unsigned grid = static_cast<unsigned>(blocks);
    auto kernel = gather_rows_bwd<T, W, false>;
    kernel<<<grid, kThreads, 0, stream>>>(gt, idx, rows, n, outt);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const void* g, const int64_t* idx, int64_t rows,
                         int64_t n, int width, void* out, cudaStream_t s) {
  switch (width) {
    case 1: return launch<T, 1>(g, idx, rows, n, out, s);
    case 2: return launch<T, 2>(g, idx, rows, n, out, s);
    case 3: return launch<T, 3>(g, idx, rows, n, out, s);
    case 4: return launch<T, 4>(g, idx, rows, n, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (n, width), zeroed by the caller, += g (rows, width) at idx (rows)
// int64, all contiguous on the current device; width 1-4, and g and out
// f32 (elem_bytes 4) or f64 (elem_bytes 8).  Returns the cudaError_t of
// the launch (0 on success), or cudaErrorInvalidValue for another width
// or element size.
int solr_gather_rows_bwd(const void* g, const int64_t* idx, int64_t rows,
                         int64_t n, int width, int elem_bytes, void* out,
                         void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (elem_bytes == 4)
    err = launch_width<float>(g, idx, rows, n, width, out, s);
  if (elem_bytes == 8)
    err = launch_width<double>(g, idx, rows, n, width, out, s);
  return static_cast<int>(err);
}

// The table size, in bytes, up to which the kernel sums in shared
// memory.
int64_t solr_gather_shared_bytes() { return kSharedBytes; }

}  // extern "C"
