// Batched evaluation of fitted cubic splines: S(t) and, on request, S'(t)
// and S''(t), from one bracket search and one read of the knots.
//
// Replaces: no Pallas kernel. The JAX package evaluates its splines with
//   jnp code (iv_interpolation_tpu/ops/cubic_spline.py, eval_cubic_spline,
//   eval_cubic_spline_deriv, eval_cubic_spline_second_deriv) and leaves the
//   fusion to XLA. Eager PyTorch runs the same code as separate passes: each
//   result its own bracket search (two copies, a searchsorted, a clamp), six
//   gathers and about twenty elementwise passes over the (slices, m)
//   queries, each pass a full read and write of device memory.
// Wrapper, launch plan and plain PyTorch version:
//   iv_interpolation_tpu_torch/ops/cuda/spline_eval.py.
//
// Layout: x, y and M are (slices, n) row-major, a slice's knots contiguous;
// the outputs (slices, m) row-major. Queries are read through strides:
// query j of slice s sits at
//   t[(s / inner) * t_outer + (s % inner) * t_inner + j * t_query],
// so a grid shared by a surface's expiries (stride 0 over them) or by a
// whole batch (the 30-day timeline) is read in place and never expanded.
// A null output pointer is a result not requested: it is neither computed
// nor written, and y is not read when neither S nor S' is requested.
//
// Interval: the plain version's rule, the count of interior knots
// x[1..n-2] <= t found by the same upper-bound bisection as
// torch.searchsorted(right=True) (same midpoints, so a NaN query or knot
// lands where the plain version's does), which lies in [0, n-2]: points
// left of x1 take the first interval and points right of x[n-2] the last,
// the boundary cubics' extrapolation of SciPy's extrapolate=True.
//
// Arithmetic: the operations of the plain version in its order, each one
// rounded on its own (__f*_rn / __d*_rn: never merged into a fused
// multiply-add), with IEEE division (the quotient of a zero dividend
// formed as the exact product that equals it, see ratio); no fast math.
//
// What bounds it on the H100: the bytes. A call must read x, y and M once
// and write each requested result once; at the surface step's grid
// (983,040 slices of n = 50 knots, m = 50 queries, three results, float32)
// that is 1.19 GB, 0.35 ms at 3.35 TB/s, against about 20 operations and
// a 6-step bisection a result.
//
// What the design does about it: a block owns a run of consecutive slices
// (and, for a long query row, one chunk of its queries: grid.y). The
// "staged" route copies the run's knots, one contiguous stretch of each of
// x, y and M, into shared memory with coalesced loads, several in flight a
// thread, then gives each thread the block's outputs in flat order, so
// that a warp's stores land on consecutive addresses whatever m is. Every
// bisection step and knot gather then reads shared memory; device memory
// sees each knot once and each output once. The launch plan
// (spline_eval_plan) sizes the run at about 2,048 outputs a block within
// 48 KiB of shared memory (40 slices at n = m = 50 in float32, 24 KB), so
// that eight blocks of 256 threads share an SM. The "global" route, for a
// slice whose knots do not fit in 48 KiB (n > 4,095 in float32, n > 2,047
// in float64; no path of the repository reaches it), searches and gathers
// the knots in device memory through the L2, one slice a block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // a block
constexpr int kUnroll = 4;                 // staging loads in flight a thread
constexpr long long kMaxSmem = 48 * 1024;  // the default dynamic limit

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }

// num / den. At a query on a knot (every query of the fit's error pass)
// many dividends are exactly 0: a or b, and with them S's curvature term.
// A zero dividend sends IEEE division down its slow path; the quotient is
// then a zero of sign(num) ^ sign(den), which the product num * den gives
// exactly for a finite, nonzero den.
template <typename T>
__device__ __forceinline__ T ratio(T num, T den) {
  return num == T(0) && den != T(0) && isfinite(den) ? mul(num, den) : quo(num, den);
}

// Block (bx, by): slices [bx * spb, bx * spb + spb) and queries
// [by * qc, by * qc + qc), both cut at the arrays' ends.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
spline_eval_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const T* __restrict__ M, const T* __restrict__ t,
                   T* __restrict__ S, T* __restrict__ dS, T* __restrict__ d2S,
                   long long slices, int n, int m, long long inner,
                   long long t_outer, long long t_inner, long long t_query,
                   int spb, int qc) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* toff = reinterpret_cast<long long*>(smem);  // query row a slice
  const long long s0 = static_cast<long long>(blockIdx.x) * spb;
  const int nsl = static_cast<int>(min(static_cast<long long>(spb), slices - s0));
  const int q0 = static_cast<int>(blockIdx.y) * qc;
  const int qn = min(qc, m - q0);
  const bool want_y = S != nullptr || dS != nullptr;

  for (int sl = threadIdx.x; sl < nsl; sl += kThreads) {
    const long long s = s0 + sl;
    toff[sl] = (s / inner) * t_outer + (s % inner) * t_inner;
  }
  const T* kx = x + s0 * n;
  const T* ky = y + s0 * n;
  const T* kM = M + s0 * n;
  if (kStaged) {
    T* sx = reinterpret_cast<T*>(toff + spb);
    T* sy = sx + spb * n;
    T* sM = sy + spb * n;
    const int count = nsl * n;
    for (int i0 = threadIdx.x; i0 < count; i0 += kUnroll * kThreads) {
      T vx[kUnroll], vy[kUnroll], vM[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < count) {
          vx[u] = __ldg(kx + i);
          vM[u] = __ldg(kM + i);
          if (want_y) vy[u] = __ldg(ky + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < count) {
          sx[i] = vx[u];
          sM[i] = vM[u];
          if (want_y) sy[i] = vy[u];
        }
      }
    }
    kx = sx;
    ky = sy;
    kM = sM;
  }
  __syncthreads();

  // the block's outputs in flat order: element e is query q0 + e % qn of
  // slice s0 + e / qn, walked by (sl, jj) without a division a step. Each
  // query is loaded one element ahead of its use, so that the load's
  // latency overlaps the previous element's search and arithmetic.
  const int total = nsl * qn;
  const int step = kThreads;
  const int dsl = step / qn, djj = step - dsl * qn;
  int sl = static_cast<int>(threadIdx.x) / qn;
  int jj = static_cast<int>(threadIdx.x) - sl * qn;
  const auto query = [&](int s, int q) {
    return __ldg(t + toff[s] + static_cast<long long>(q0 + q) * t_query);
  };
  T next = static_cast<int>(threadIdx.x) < total ? query(sl, jj) : T(0);
  for (int e = threadIdx.x; e < total; e += step) {
    const T tv = next;
    const int j = q0 + jj;
    const int here = sl;
    jj += djj;
    sl += dsl;
    if (jj >= qn) {
      jj -= qn;
      ++sl;
    }
    if (e + step < total) next = query(sl, jj);
    const T* xs = kx + here * n;
    int lo = 0, hi = n - 2;            // upper bound of tv in xs[1..n-2]
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(xs[1 + mid] > tv)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const T* Ms = kM + here * n;
    const T x0 = xs[lo], x1 = xs[lo + 1];
    const T M0 = Ms[lo], M1 = Ms[lo + 1];
    const T hh = sub(x1, x0);
    const T right = sub(x1, tv), left = sub(tv, x0);
    const long long o = (s0 + here) * static_cast<long long>(m) + j;
    if (want_y) {
      const T* ys = ky + here * n;
      const T y0 = ys[lo], y1 = ys[lo + 1];
      const T a = ratio(right, hh), b = ratio(left, hh);
      const T aa = mul(a, a), bb = mul(b, b);
      if (S != nullptr) {
        // a y0 + b y1 + ((a^3 - a) M0 + (b^3 - b) M1) hh^2 / 6
        const T curv = add(mul(sub(mul(aa, a), a), M0), mul(sub(mul(bb, b), b), M1));
        S[o] = add(add(mul(a, y0), mul(b, y1)), ratio(mul(curv, mul(hh, hh)), T(6)));
      }
      if (dS != nullptr) {
        // (y1 - y0) / hh + ((1 - 3 a^2) M0 + (3 b^2 - 1) M1) hh / 6
        const T curv = add(mul(add(mul(T(-3), aa), T(1)), M0),
                           mul(sub(mul(T(3), bb), T(1)), M1));
        dS[o] = add(ratio(sub(y1, y0), hh), ratio(mul(curv, hh), T(6)));
      }
    }
    if (d2S != nullptr) {
      // ((x1 - t) M0 + (t - x0) M1) / hh
      d2S[o] = ratio(add(mul(right, M0), mul(left, M1)), hh);
    }
  }
}

template <typename T>
int launch(const T* x, const T* y, const T* M, const T* t, T* S, T* dS,
           T* d2S, long long slices, int n, int m, long long inner,
           long long t_outer, long long t_inner, long long t_query, int spb,
           int qc, int staged, void* stream) {
  if (n < 2 || m < 1 || slices < 1 || inner < 1 || spb < 1 || qc < 1 ||
      (S == nullptr && dS == nullptr && d2S == nullptr) ||
      (!staged && spb != 1) ||
      static_cast<long long>(spb) * qc > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (slices + spb - 1) / spb;
  const long long chunks = (m + static_cast<long long>(qc) - 1) / qc;
  const long long smem =
      8LL * spb + (staged ? 3LL * spb * n * static_cast<long long>(sizeof(T)) : 0);
  if (blocks > 2147483647LL || chunks > 65535 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged) {
    spline_eval_kernel<T, true><<<grid, kThreads, static_cast<size_t>(smem), s>>>(
        x, y, M, t, S, dS, d2S, slices, n, m, inner, t_outer, t_inner, t_query,
        spb, qc);
  } else {
    spline_eval_kernel<T, false><<<grid, kThreads, static_cast<size_t>(smem), s>>>(
        x, y, M, t, S, dS, d2S, slices, n, m, inner, t_outer, t_inner, t_query,
        spb, qc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y, M (slices, n) and t (strided, see above) in; S, S', S'' out (null:
// not requested); spb slices and qc queries a block, staged != 0 for the
// shared-memory route, whose bytes a block (8 spb + 3 spb n sizeof(T)) the
// launch sizes and checks against kMaxSmem.
extern "C" int ivt_spline_eval_f32(const float* x, const float* y,
                                   const float* M, const float* t, float* S,
                                   float* dS, float* d2S, long long slices,
                                   int n, int m, long long inner,
                                   long long t_outer, long long t_inner,
                                   long long t_query, int spb, int qc,
                                   int staged, void* stream) {
  return launch<float>(x, y, M, t, S, dS, d2S, slices, n, m, inner, t_outer,
                       t_inner, t_query, spb, qc, staged, stream);
}

extern "C" int ivt_spline_eval_f64(const double* x, const double* y,
                                   const double* M, const double* t,
                                   double* S, double* dS, double* d2S,
                                   long long slices, int n, int m,
                                   long long inner, long long t_outer,
                                   long long t_inner, long long t_query,
                                   int spb, int qc, int staged,
                                   void* stream) {
  return launch<double>(x, y, M, t, S, dS, d2S, slices, n, m, inner, t_outer,
                        t_inner, t_query, spb, qc, staged, stream);
}
