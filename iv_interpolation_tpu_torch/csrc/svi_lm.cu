// Raw-SVI calibration of a batch of slices by Levenberg-Marquardt: every
// iteration of every slice in one launch.
//
// Replaces: no Pallas kernel. The JAX package runs its batched LM
//   (iv_interpolation_tpu/ops/lm.py, levenberg_marquardt_batched) as
//   vmap(jacfwd) of the residual under XLA. The port's generic loop
//   (ops/lm.py) runs it eagerly: about 195 launches an iteration, each a
//   pass of (slices, n) or (slices, n, 5) intermediates through device
//   memory. This kernel fixes the residual to raw SVI with linear loss and
//   no penalty, which lets it keep a slice on the chip for all of its
//   iterations. Wrapper and plain PyTorch version:
//   iv_interpolation_tpu_torch/ops/cuda/svi_lm.py.
//
// Layout: k, w and the weights are (slices, n) row-major; p0 and params
// (slices, 5) in the order (a, b, rho, m, sigma); cost, n_accepted and
// converged (slices). A null weights pointer means unit weights.
//
// The algorithm is the generic loop's with butterfly_penalty = 0 and
// loss = "linear": p = clamp(p0); each iteration solves (J^T J + diag(lam
// max(diag J^T J, 1e-12))) delta = -J^T r by Cholesky (a non-positive
// pivot or a factor that is not finite gives a NaN step), projects p +
// delta on the box, accepts a finite lower cost, divides lam by 3 on
// accept and multiplies it by 3 on reject (clamped to [1e-12, 1e12]), and
// freezes a slice at a small accepted step, a small gradient or a small
// accepted improvement. A frozen slice stops iterating: its outputs are
// what the frozen iterations would leave. The residual and its Jacobian
// are in closed form, with km = k - m, root = sqrt(km^2 + sigma^2) and
// u = rho km + root:
//   r = (a + b u - w) wt,  J = (1, u, b km, -b (rho + km / root),
//   b sigma / root) wt,
// the two quotients taken as products with 1 / root. One pass over a
// slice's quotes gives the cost at a trial point and, should it be
// accepted, J^T J and J^T r there: the next iteration's system.
//
// Arithmetic: every operation rounded on its own (__*_rn: never merged
// into a fused multiply-add), IEEE square root, reciprocal and division.
// Each sum over a slice's quotes is taken in runs of kRun = 8 quotes in
// quote order, each run from its first term, and the runs' sums joined in
// order from the first: about 8 + n / 8 roundings deep where one running
// sum is n deep. Along SVI's flat (m, sigma) valleys the normal equations
// magnify the rounding of J^T J's sums, and that decides where a float32
// LM stalls: with one running sum 1.83-2.12 % of the cell's slices ended
// more than 1 % above the float64 calibration's cost, with runs of 8
// 0.83-1.35 % (plain version, 15,360 slices of each of three seeds; the
// generic loop there 1.89-2.21 %); runs for J^T r and the cost alone
// changed nothing. On the card the cell reads 1.12 % (the generic loop's
// 1.24 %). The plain version runs the same operations in the same order,
// so the two agree bit for bit on any IEEE device.
//
// What bounds it on the H100: arithmetic. A call reads each quote once
// and writes 5 parameters and 3 scalars a slice, 0.39 GB at the cell's
// shape (983,040 slices of n = 50, float32, unit weights), 0.12 ms at
// 3.35 TB/s; its passes cost about 70 instructions a quote (a square
// root, a reciprocal, the residual, four Jacobian columns and 21 products
// summed), 50 quotes a pass, one pass an iteration, 50 iterations:
// about 1.7e11 instructions, 5.1 ms at 128 float32 lanes x 132 SMs x
// 1.98 GHz; the same work with fused multiply-adds would take about 2.8
// ms. It runs in 8.8-9.4 ms on an H100 at 700 W; among the causes, the
// slices that converge early (a quarter of the cell's) idle their lanes
// until their warp's last slice is done.
//
// What the design does about it: nothing of a slice goes back to device
// memory between iterations. A block owns kSlices = 32 consecutive
// slices, one a thread (64 measured alike), and first copies their quotes,
// coalesced, into shared memory, transposed with one padding column, so
// that each read of a quote by the warp's 32 slices is one conflict-free
// access; the LM state, the 21 sums and the 5 x 5 factor stay in
// registers (about 110 a thread in float32). At n = 50 in float32 with
// unit weights a block stages 13 KB, and 16 blocks, 512 slices, share an
// SM. Slices whose quotes do not fit in 48 KiB (n > 186 in float32 with
// unit weights) read them from device memory through the L1 (the
// "global" route, 1.4x slower at the cell's shape).
// A mapping of 8 lanes a slice, quotes in registers and the 21 sums
// reduced by shuffles, was measured 1.78x slower at the cell's shape
// (15.86 against 8.90 ms a call on an H100 at 700 W): its lanes repeat the
// 5 x 5 solve and the reductions, which outweighs the occupancy it gains.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kP = 5;                      // a, b, rho, m, sigma
constexpr int kPairs = kP * (kP + 1) / 2;  // J^T J's upper triangle
constexpr long long kMaxSmem = 48 * 1024;  // the default dynamic limit
constexpr int kSlices = 32;                // slices (threads) a block
constexpr int kRun = 8;                    // quotes summed apart, then joined

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float inv(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double inv(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float mag(float a) { return fabsf(a); }
__device__ __forceinline__ double mag(double a) { return fabs(a); }
__device__ __forceinline__ float not_a_number(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ double not_a_number(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// PyTorch's clamp: a NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
struct Box {
  T lo[kP], hi[kP];
};

// What one pass over a slice's quotes gives at one point: J^T J's upper
// triangle row by row ((0,0), (0,1), ..., (4,4)), J^T r and r^T r.
template <typename T>
struct Sums {
  T h[kPairs];
  T g[kP];
  T rr;
};

template <typename T>
__device__ __forceinline__ void join(Sums<T>& s, const Sums<T>& run) {
#pragma unroll
  for (int i = 0; i < kPairs; ++i) s.h[i] = add(s.h[i], run.h[i]);
#pragma unroll
  for (int i = 0; i < kP; ++i) s.g[i] = add(s.g[i], run.g[i]);
  s.rr = add(s.rr, run.rr);
}

// One quote's residual and Jacobian row at p, added to the sums (kFirst:
// the sums start from it). s2 = sigma^2 and bs = b sigma are the slice's.
template <typename T, bool kWeighted, bool kFirst>
__device__ __forceinline__ void add_quote(Sums<T>& s, const T (&p)[kP], T s2, T bs,
                                          T kj, T wj, T wtj) {
  const T km = sub(kj, p[3]);
  const T rt = root(add(mul(km, km), s2));
  const T ir = inv(rt);
  const T u = add(mul(p[2], km), rt);
  T r = sub(add(p[0], mul(p[1], u)), wj);
  T J[kP] = {T(1), u, mul(p[1], km), -mul(p[1], add(p[2], mul(km, ir))), mul(bs, ir)};
  if (kWeighted) {
    r = mul(r, wtj);
#pragma unroll
    for (int i = 0; i < kP; ++i) J[i] = mul(J[i], wtj);
  }
  // with unit weights J[0] is 1, and 1 x is x exactly: no product to take
  const auto times = [&](int i, T x) { return !kWeighted && i == 0 ? x : mul(J[i], x); };
  int e = 0;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
#pragma unroll
    for (int j = i; j < kP; ++j, ++e) {
      const T t = times(i, J[j]);
      s.h[e] = kFirst ? t : add(s.h[e], t);
    }
  }
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const T t = times(i, r);
    s.g[i] = kFirst ? t : add(s.g[i], t);
  }
  const T t = mul(r, r);
  s.rr = kFirst ? t : add(s.rr, t);
}

// J^T J entry (i, j) of the sums
__device__ __forceinline__ int pair(int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return lo * kP - lo * (lo - 1) / 2 + (hi - lo);
}

// delta of (J^T J + diag(lam max(diag, 1e-12))) delta = -g by Cholesky,
// NaN where a pivot is not positive or the factor is not finite.
template <typename T>
__device__ __forceinline__ void solve(const Sums<T>& s, T lam, T (&delta)[kP]) {
  T L[kP][kP];
  T id[kP];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const T hjj = s.h[pair(j, j)];
    const T tiny = T(1e-12);
    T sum = add(hjj, mul(lam, hjj < tiny ? tiny : hjj));
#pragma unroll
    for (int q = 0; q < j; ++q) sum = sub(sum, mul(L[j][q], L[j][q]));
    ok = ok && sum > T(0);
    const T d = root(sum);
    ok = ok && isfinite(d);
    L[j][j] = d;
    id[j] = inv(d);
#pragma unroll
    for (int i = j + 1; i < kP; ++i) {
      T t = s.h[pair(i, j)];
#pragma unroll
      for (int q = 0; q < j; ++q) t = sub(t, mul(L[i][q], L[j][q]));
      L[i][j] = mul(t, id[j]);
      ok = ok && isfinite(L[i][j]);
    }
  }
  T y[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    T t = -s.g[i];
#pragma unroll
    for (int q = 0; q < i; ++q) t = sub(t, mul(L[i][q], y[q]));
    y[i] = mul(t, id[i]);
  }
#pragma unroll
  for (int i = kP - 1; i >= 0; --i) {
    T t = y[i];
#pragma unroll
    for (int q = i + 1; q < kP; ++q) t = sub(t, mul(L[q][i], delta[q]));
    delta[i] = mul(t, id[i]);
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < kP; ++i) delta[i] = not_a_number(T(0));
  }
}

// The LM state of one slice.
template <typename T>
struct State {
  T p[kP];
  T lam, cost;
  int accepted;
  bool converged;
  Sums<T> cur;  // J^T J, J^T r and r^T r at p
};

// The rest of one LM iteration, given the trial point p_new = clamp(p +
// delta) and its pass: acceptance, lambda and the three convergence tests
// (tol = 1e-12 in the generic loop).
template <typename T>
__device__ __forceinline__ void decide(State<T>& st, const T (&p_new)[kP], const T (&delta)[kP],
                                       const Sums<T>& trial, T tol) {
  const T cost_new = mul(T(0.5), trial.rr);
  const bool accept = cost_new < st.cost && isfinite(cost_new);
  // the gradient test reads the point the step was taken from
  bool small_grad = true;
#pragma unroll
  for (int i = 0; i < kP; ++i) small_grad = small_grad && mag(st.cur.g[i]) < tol;
  bool small_step = false, small_impr = false;
  if (accept) {
    T pmax = mag(p_new[0]);
#pragma unroll
    for (int i = 1; i < kP; ++i) pmax = mag(p_new[i]) > pmax ? mag(p_new[i]) : pmax;
    const T thr = mul(tol, add(T(1), pmax));
    small_step = true;
#pragma unroll
    for (int i = 0; i < kP; ++i) small_step = small_step && mag(delta[i]) < thr;
    const T scale = st.cost < T(1) ? T(1) : st.cost;
    small_impr = sub(st.cost, cost_new) < mul(tol, scale);
#pragma unroll
    for (int i = 0; i < kP; ++i) st.p[i] = p_new[i];
    st.cost = cost_new;
    st.cur = trial;
    st.accepted += 1;
    st.lam = quo(st.lam, T(3));
  } else {
    st.lam = mul(st.lam, T(3));
  }
  st.lam = clamp(st.lam, T(1e-12), T(1e12));
  st.converged = small_step || small_grad || small_impr;
}

template <typename T>
__device__ __forceinline__ void trial_point(const State<T>& st, const Box<T>& box, T (&delta)[kP],
                                            T (&p_new)[kP]) {
  solve(st.cur, st.lam, delta);
#pragma unroll
  for (int i = 0; i < kP; ++i) p_new[i] = clamp(add(st.p[i], delta[i]), box.lo[i], box.hi[i]);
}

template <typename T>
__device__ __forceinline__ void write(const State<T>& st, long long s, T* params, T* cost,
                                      int* n_accepted, unsigned char* converged) {
#pragma unroll
  for (int i = 0; i < kP; ++i) params[s * kP + i] = st.p[i];
  cost[s] = st.cost;
  n_accepted[s] = st.accepted;
  converged[s] = st.converged ? 1 : 0;
}

// Thread t of block b calibrates slice b * kSlices + t. 16 blocks (at most
// 128 registers a thread) in float32; float64 state takes twice the
// registers, and 8 blocks keep it from spilling.
template <typename T, bool kWeighted, bool kStaged>
__global__ void __launch_bounds__(kSlices, sizeof(T) == 4 ? 16 : 8)
svi_lm_slice_kernel(const T* __restrict__ k, const T* __restrict__ w,
                    const T* __restrict__ wt, const T* __restrict__ p0,
                    T* __restrict__ params, T* __restrict__ cost,
                    int* __restrict__ n_accepted, unsigned char* __restrict__ converged,
                    long long slices, int n, int iters, T lambda0, T tol, Box<T> box) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long s0 = static_cast<long long>(blockIdx.x) * kSlices;
  const int nsl = static_cast<int>(min(static_cast<long long>(kSlices), slices - s0));
  const int t = static_cast<int>(threadIdx.x);
  const T *kq, *wq, *wtq = nullptr;
  int stride;
  if (kStaged) {
    // quote j of the block's slice sl at [j * ld + sl]
    const int ld = kSlices + 1;
    T* sk = reinterpret_cast<T*>(smem);
    T* sw = sk + n * ld;
    T* swt = sw + n * ld;
    const int count = nsl * n;
    const T* gk = k + s0 * n;
    const T* gw = w + s0 * n;
    const T* gwt = kWeighted ? wt + s0 * n : nullptr;
    for (int e = t; e < count; e += kSlices) {
      const int sl = e / n, j = e - sl * n;
      sk[j * ld + sl] = __ldg(gk + e);
      sw[j * ld + sl] = __ldg(gw + e);
      if (kWeighted) swt[j * ld + sl] = __ldg(gwt + e);
    }
    __syncthreads();
    kq = sk + t;
    wq = sw + t;
    if (kWeighted) wtq = swt + t;
    stride = ld;
  } else {
    kq = k + (s0 + t) * n;
    wq = w + (s0 + t) * n;
    if (kWeighted) wtq = wt + (s0 + t) * n;
    stride = 1;
  }
  if (t >= nsl) return;
  const long long s = s0 + t;

  // the sums over runs of kRun quotes, each run's from its first quote's
  // terms, the runs joined in order from the first
  const auto pass = [&](const T (&p)[kP], Sums<T>& out) {
    const T s2 = mul(p[4], p[4]);
    const T bs = mul(p[1], p[4]);
    const auto wt_at = [&](int j) { return kWeighted ? wtq[j * stride] : T(1); };
    for (int j0 = 0; j0 < n; j0 += kRun) {
      Sums<T> run;
      add_quote<T, kWeighted, true>(run, p, s2, bs, kq[j0 * stride], wq[j0 * stride], wt_at(j0));
#pragma unroll
      for (int u = 1; u < kRun; ++u) {
        const int j = j0 + u;
        if (j < n) {
          add_quote<T, kWeighted, false>(run, p, s2, bs, kq[j * stride], wq[j * stride],
                                         wt_at(j));
        }
      }
      if (j0 == 0) {
        out = run;
      } else {
        join(out, run);
      }
    }
  };

  State<T> st;
#pragma unroll
  for (int i = 0; i < kP; ++i) st.p[i] = clamp(p0[s * kP + i], box.lo[i], box.hi[i]);
  st.lam = lambda0;
  st.accepted = 0;
  st.converged = false;
  pass(st.p, st.cur);
  st.cost = mul(T(0.5), st.cur.rr);
  for (int it = 0; it < iters && !st.converged; ++it) {
    T delta[kP], p_new[kP];
    trial_point(st, box, delta, p_new);
    Sums<T> trial;
    pass(p_new, trial);
    decide(st, p_new, delta, trial, tol);
  }
  write(st, s, params, cost, n_accepted, converged);
}

// The staged route where a block's quotes fit in kMaxSmem, else the global one.
template <typename T, bool kWeighted>
int launch_routed(const T* k, const T* w, const T* wt, const T* p0, T* params, T* cost,
                  int* n_accepted, unsigned char* converged, long long slices, int n,
                  int iters, T lambda0, T tol, const Box<T>& box, cudaStream_t s) {
  const long long blocks = (slices + kSlices - 1) / kSlices;
  const long long smem = (kWeighted ? 3LL : 2LL) * n * (kSlices + 1LL) *
                         static_cast<long long>(sizeof(T));
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (smem <= kMaxSmem) {
    svi_lm_slice_kernel<T, kWeighted, true><<<grid, kSlices, static_cast<size_t>(smem), s>>>(
        k, w, wt, p0, params, cost, n_accepted, converged, slices, n, iters, lambda0, tol, box);
  } else {
    svi_lm_slice_kernel<T, kWeighted, false><<<grid, kSlices, 0, s>>>(
        k, w, wt, p0, params, cost, n_accepted, converged, slices, n, iters, lambda0, tol, box);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* k, const T* w, const T* wt, const T* p0, T* params, T* cost,
           int* n_accepted, unsigned char* converged, long long slices, int n, int iters,
           double lambda0, double tol, const double* bounds, void* stream) {
  if (slices < 1 || n < 1 || iters < 0 || bounds == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Box<T> box;
  for (int i = 0; i < kP; ++i) {
    box.lo[i] = static_cast<T>(bounds[i]);
    box.hi[i] = static_cast<T>(bounds[kP + i]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wt != nullptr) {
    return launch_routed<T, true>(k, w, wt, p0, params, cost, n_accepted, converged, slices, n,
                                  iters, static_cast<T>(lambda0), static_cast<T>(tol), box, s);
  }
  return launch_routed<T, false>(k, w, wt, p0, params, cost, n_accepted, converged, slices, n,
                                 iters, static_cast<T>(lambda0), static_cast<T>(tol), box, s);
}

}  // namespace

// k, w, weights (null: unit) (slices, n) and p0 (slices, 5) in; params
// (slices, 5), cost, n_accepted (int32) and converged (one byte, 0 or 1)
// out. bounds: a host array of the 5 lower then the 5 upper bounds.
extern "C" int ivt_svi_lm_f32(const float* k, const float* w, const float* wt, const float* p0,
                              float* params, float* cost, int* n_accepted,
                              unsigned char* converged, long long slices, int n, int iters,
                              double lambda0, double tol, const double* bounds,
                              void* stream) {
  return launch<float>(k, w, wt, p0, params, cost, n_accepted, converged, slices, n, iters,
                       lambda0, tol, bounds, stream);
}

extern "C" int ivt_svi_lm_f64(const double* k, const double* w, const double* wt,
                              const double* p0, double* params, double* cost, int* n_accepted,
                              unsigned char* converged, long long slices, int n, int iters,
                              double lambda0, double tol, const double* bounds,
                              void* stream) {
  return launch<double>(k, w, wt, p0, params, cost, n_accepted, converged, slices, n, iters,
                        lambda0, tol, bounds, stream);
}
