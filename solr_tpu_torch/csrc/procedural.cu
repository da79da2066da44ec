// The procedural albedo of each shaded hit (ProceduralKind 0-6) and its
// backward, for Hopper (sm_90a).  Built by nvcc into a shared library
// with a plain C interface and bound with ctypes
// (solr_tpu_torch/ops/textures.py).
//
// Replaces no TPU kernel: the reference (solr_tpu/ops/textures.py
// procedural_color) computes all seven kinds for every ray and then takes
// each ray's own, which XLA fuses into one elementwise kernel.  Eager
// PyTorch runs the same code as about 1,600 launches a call, and its
// autograd graph as about 900 more, once per shaded bounce.
//
// procedural_fwd: per ray, kind (int32), scale, uv (2) and base_color (4)
// in, the albedo (4) out.  What bounds it is bytes: 48 a ray in float32 (32
// read, 16 written) against a few operations for most kinds; the
// escape-time kinds (up to 32 iterations of 10 operations) and the
// turbulences (four octaves of four sines) stay under the card's rate at a
// few operations a byte.  Its design: one thread a ray, which branches on
// its own kind and computes that kind alone.  A warp whose lanes hit one
// material (neighbouring pixels mostly do, and every ray of a frame whose
// materials have no procedural) runs one kind; a warp of mixed kinds runs
// its kinds one after another, at most the seven that the plain version
// computes for every ray.  An escape-time lane stops at its first escape:
// the plain version's lane is frozen from then on (its z and its count keep
// their values), so the result is the same.  Each kind repeats the plain
// version's arithmetic op for op, in the same association, with the
// constants rounded to the tensor's type as PyTorch rounds a Python float,
// the math functions that PyTorch's CUDA kernels call (sinf, floorf, fmodf
// and their double forms) and no FMA contraction (--fmad=false): the
// forward is bit-equal to procedural_color_plain on the card.
//
// procedural_bwd: per ray, the incoming gradient (4) of the albedo to the
// gradients of uv (2), scale and base_color (4), for the ray's own kind:
//   * NONE: base_color's gradient is the incoming one; uv's and scale's 0;
//   * MANDELBROT, JULIA: rgb times the escape fraction f, alpha passed;
//     uv and scale 0 (the escape count is piecewise constant);
//   * CHECKER: rgb +-1 times the incoming gradient; uv and scale 0;
//   * NOISE, MARBLE, GRANITE: rgb times f, alpha passed; uv and scale
//     through the smoothstep weights (the lattice hashes are of floored
//     coordinates, whose gradient is 0), the marble's sine (as a cosine)
//     and the granite's clamp, which passes the gradient where its input
//     lies in [0, 1], edges included, as autograd's clamp does.
// The chain rule is taken in its own association, so those three kinds
// agree with autograd through the plain version to rounding; the others
// bit for bit.  A null output pointer skips that output.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIters = 32;    // textures._MANDEL_ITERS
constexpr int kOctaves = 4;   // textures.turbulence's default
constexpr int kKinds = 7;

enum Kind {
  kNone = 0, kMandelbrot = 1, kJulia = 2, kChecker = 3,
  kNoise = 4, kMarble = 5, kGranite = 6,
};

// The functions PyTorch's CUDA kernels call for torch.sin, cos, floor and
// remainder, by value type.
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float fmod_(float x, float y) {
  return fmodf(x, y);
}
__device__ __forceinline__ double fmod_(double x, double y) {
  return fmod(x, y);
}
__device__ __forceinline__ float fmax_(float x, float y) {
  return fmaxf(x, y);
}
__device__ __forceinline__ double fmax_(double x, double y) {
  return fmax(x, y);
}
__device__ __forceinline__ float fmin_(float x, float y) {
  return fminf(x, y);
}
__device__ __forceinline__ double fmin_(double x, double y) {
  return fmin(x, y);
}

__device__ __forceinline__ int clamp_kind(int32_t k) {
  return k < 0 ? 0 : (k > kKinds - 1 ? kKinds - 1 : k);
}

// The escape-time iteration count / kIters in [0, 1].
template <typename T>
__device__ T escape_time(T c_re, T c_im, T zr, T zi) {
  T count = T(0);
  for (int it = 0; it < kIters; ++it) {
    const T zr2 = zr * zr - zi * zi + c_re;
    const T zi2 = T(2) * zr * zi + c_im;
    if (!(zr2 * zr2 + zi2 * zi2 < T(4))) break;
    count = count + T(1);
    zr = zr2;
    zi = zi2;
  }
  return count / T(kIters);
}

template <typename T>
__device__ T mandelbrot(T u, T v, T s) {
  const T re = (u - T(0.6)) * T(2.6) * s;
  const T im = (v - T(0.5)) * T(2.4) * s;
  return escape_time(re, im, T(0), T(0));
}

template <typename T>
__device__ T julia(T u, T v, T s) {
  const T re = (u - T(0.5)) * T(3.0) * s;
  const T im = (v - T(0.5)) * T(3.0) * s;
  return escape_time(T(-0.70176), T(-0.3842), re, im);
}

template <typename T>
__device__ T hash2(T x, T y) {
  const T h = sin_(x * T(127.1) + y * T(311.7)) * T(43758.5453);
  return h - floor_(h);
}

// Value noise at (u, v) * s, and what its backward needs.
template <typename T>
struct Noise {
  T fx, fy, sx, sy, a, b, c, d, top, bot, value;
};

template <typename T>
__device__ Noise<T> noise(T u, T v, T s) {
  Noise<T> n;
  const T qx = u * s, qy = v * s;
  const T xi = floor_(qx), yi = floor_(qy);
  n.fx = qx - xi;
  n.fy = qy - yi;
  n.sx = n.fx * n.fx * (T(3.0) - T(2.0) * n.fx);
  n.sy = n.fy * n.fy * (T(3.0) - T(2.0) * n.fy);
  n.a = hash2(xi, yi);
  n.b = hash2(xi + T(1.0), yi);
  n.c = hash2(xi, yi + T(1.0));
  n.d = hash2(xi + T(1.0), yi + T(1.0));
  n.top = n.a * (T(1) - n.sx) + n.b * n.sx;
  n.bot = n.c * (T(1) - n.sx) + n.d * n.sx;
  n.value = n.top * (T(1) - n.sy) + n.bot * n.sy;
  return n;
}

template <typename T>
__device__ T turbulence(T u, T v, T s) {
  T out = T(0);
  T amp = T(0.5), freq = T(1.0);
  for (int o = 0; o < kOctaves; ++o) {
    out = out + noise(u, v, s * freq).value * amp;
    amp = amp * T(0.5);
    freq = freq * T(2.0);
  }
  return out;
}

// g times the gradient of value noise at (u, v) * s, added into gu, gv
// and gs.
template <typename T>
__device__ void noise_bwd(T u, T v, T s, T g, T& gu, T& gv, T& gs) {
  const Noise<T> n = noise(u, v, s);
  const T g_sx = g * ((n.b - n.a) * (T(1) - n.sy) + (n.d - n.c) * n.sy);
  const T g_sy = g * (n.bot - n.top);
  const T g_qx = g_sx * (T(6) * n.fx * (T(1) - n.fx));
  const T g_qy = g_sy * (T(6) * n.fy * (T(1) - n.fy));
  gu += g_qx * s;
  gv += g_qy * s;
  gs += g_qx * u + g_qy * v;
}

template <typename T>
__device__ void turbulence_bwd(T u, T v, T s, T g, T& gu, T& gv, T& gs) {
  T amp = T(0.5), freq = T(1.0);
  for (int o = 0; o < kOctaves; ++o) {
    T g_sf = T(0);
    noise_bwd(u, v, s * freq, g * amp, gu, gv, g_sf);
    gs += g_sf * freq;
    amp = amp * T(0.5);
    freq = freq * T(2.0);
  }
}

template <typename T>
__device__ T marble_arg(T u, T v, T s) {
  return u * s * T(6.28318) + T(4.0) * turbulence(u, v, s);
}

template <typename T>
__device__ T granite_arg(T u, T v, T s) {
  return turbulence(u, v, s * T(4.0)) * T(1.4);
}

template <typename T>
__device__ T clamp01(T x) {
  return x != x ? x : fmin_(fmax_(x, T(0.0)), T(1.0));
}

// (floor(u s) + floor(v s)) mod 2, the floor modulo of torch.remainder.
template <typename T>
__device__ T checker(T u, T v, T s) {
  T m = fmod_(floor_(u * s) + floor_(v * s), T(2.0));
  if (m != T(0) && m < T(0)) m += T(2.0);
  return m;
}

// The factor f of the kinds that tint base_color by f.
template <typename T>
__device__ T tint_factor(int k, T u, T v, T s) {
  switch (k) {
    case kMandelbrot: return mandelbrot(u, v, s);
    case kJulia: return julia(u, v, s);
    case kNoise: return noise(u, v, s).value;
    case kMarble: return T(0.5) + T(0.5) * sin_(marble_arg(u, v, s));
    default: return clamp01(granite_arg(u, v, s));  // kGranite
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    procedural_fwd(const int32_t* __restrict__ kind,
                   const T* __restrict__ scale, const T* __restrict__ uv,
                   const T* __restrict__ base, int64_t n,
                   T* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= n) return;
  const int k = clamp_kind(kind[i]);
  T c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j] = base[i * 4 + j];
  if (k == kChecker) {
    const T m = checker(uv[i * 2], uv[i * 2 + 1], scale[i]);
    if (!(m > T(0.5))) {
#pragma unroll
      for (int j = 0; j < 3; ++j) c[j] = T(1.0) - c[j];
    }
  } else if (k != kNone) {
    const T f = tint_factor(k, uv[i * 2], uv[i * 2 + 1], scale[i]);
#pragma unroll
    for (int j = 0; j < 3; ++j) c[j] = c[j] * f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[i * 4 + j] = c[j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    procedural_bwd(const int32_t* __restrict__ kind,
                   const T* __restrict__ scale, const T* __restrict__ uv,
                   const T* __restrict__ base, const T* __restrict__ grad,
                   int64_t n, T* __restrict__ grad_uv,
                   T* __restrict__ grad_scale, T* __restrict__ grad_base) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= n) return;
  const int k = clamp_kind(kind[i]);
  T g[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) g[j] = grad[i * 4 + j];
  T gb[4] = {g[0], g[1], g[2], g[3]};
  T gu = T(0), gv = T(0), gs = T(0);
  if (k == kChecker) {
    const T m = checker(uv[i * 2], uv[i * 2 + 1], scale[i]);
    if (!(m > T(0.5))) {
#pragma unroll
      for (int j = 0; j < 3; ++j) gb[j] = -g[j];
    }
  } else if (k != kNone) {
    const T u = uv[i * 2], v = uv[i * 2 + 1], s = scale[i];
    const T f = tint_factor(k, u, v, s);
#pragma unroll
    for (int j = 0; j < 3; ++j) gb[j] = g[j] * f;
    if (k >= kNoise && (grad_uv != nullptr || grad_scale != nullptr)) {
      const T gf = g[0] * base[i * 4] + g[1] * base[i * 4 + 1] +
                   g[2] * base[i * 4 + 2];
      if (k == kNoise) {
        noise_bwd(u, v, s, gf, gu, gv, gs);
      } else if (k == kMarble) {
        const T g_x = gf * T(0.5) * cos_(marble_arg(u, v, s));
        const T g_us = g_x * T(6.28318);
        gu += g_us * s;
        gs += g_us * u;
        turbulence_bwd(u, v, s, g_x * T(4.0), gu, gv, gs);
      } else {  // kGranite
        const T x = granite_arg(u, v, s);
        const T g_x = (x >= T(0.0) && x <= T(1.0)) ? gf : T(0);
        T g_s4 = T(0);
        turbulence_bwd(u, v, s * T(4.0), g_x * T(1.4), gu, gv, g_s4);
        gs += g_s4 * T(4.0);
      }
    }
  }
  if (grad_uv != nullptr) {
    grad_uv[i * 2] = gu;
    grad_uv[i * 2 + 1] = gv;
  }
  if (grad_scale != nullptr) grad_scale[i] = gs;
  if (grad_base != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) grad_base[i * 4 + j] = gb[j];
  }
}

unsigned blocks_of(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T>
cudaError_t launch_fwd(const int32_t* kind, const void* scale, const void* uv,
                       const void* base, int64_t n, void* out,
                       cudaStream_t stream) {
  const T* st = static_cast<const T*>(scale);
  const T* uvt = static_cast<const T*>(uv);
  const T* bt = static_cast<const T*>(base);
  T* ot = static_cast<T*>(out);
  const unsigned grid = blocks_of(n);
  procedural_fwd<T><<<grid, kThreads, 0, stream>>>(kind, st, uvt, bt, n, ot);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const int32_t* kind, const void* scale, const void* uv,
                       const void* base, const void* grad, int64_t n,
                       void* grad_uv, void* grad_scale, void* grad_base,
                       cudaStream_t stream) {
  const T* st = static_cast<const T*>(scale);
  const T* uvt = static_cast<const T*>(uv);
  const T* bt = static_cast<const T*>(base);
  const T* gt = static_cast<const T*>(grad);
  T* gut = static_cast<T*>(grad_uv);
  T* gst = static_cast<T*>(grad_scale);
  T* gbt = static_cast<T*>(grad_base);
  const unsigned grid = blocks_of(n);
  procedural_bwd<T><<<grid, kThreads, 0, stream>>>(kind, st, uvt, bt, gt, n,
                                                   gut, gst, gbt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n, 4) = the procedural albedo of kind (n) int32, scale (n), uv
// (n, 2) and base (n, 4), all contiguous on the current device, f32
// (elem_bytes 4) or f64 (elem_bytes 8).  Returns the cudaError_t of the
// launch (0 on success), or cudaErrorInvalidValue for another element
// size.
int solr_procedural_fwd(const int32_t* kind, const void* scale,
                        const void* uv, const void* base, int64_t n,
                        int elem_bytes, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (elem_bytes == 4)
    err = launch_fwd<float>(kind, scale, uv, base, n, out, s);
  if (elem_bytes == 8)
    err = launch_fwd<double>(kind, scale, uv, base, n, out, s);
  return static_cast<int>(err);
}

// grad_uv (n, 2), grad_scale (n) and grad_base (n, 4) from the incoming
// gradient grad (n, 4) of solr_procedural_fwd's output, with its inputs;
// a null output is not written.  Returns as solr_procedural_fwd.
int solr_procedural_bwd(const int32_t* kind, const void* scale,
                        const void* uv, const void* base, const void* grad,
                        int64_t n, int elem_bytes, void* grad_uv,
                        void* grad_scale, void* grad_base, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (elem_bytes == 4)
    err = launch_bwd<float>(kind, scale, uv, base, grad, n, grad_uv,
                            grad_scale, grad_base, s);
  if (elem_bytes == 8)
    err = launch_bwd<double>(kind, scale, uv, base, grad, n, grad_uv,
                             grad_scale, grad_base, s);
  return static_cast<int>(err);
}

}  // extern "C"
