// Joint eSSVI calibration of a batch of surfaces by Levenberg-Marquardt:
// every iteration of every surface in one launch.
//
// Replaces: no Pallas kernel. The JAX package runs its eSSVI block solver
//   (iv_interpolation_tpu/ops/essvi.py) under XLA; the port's block solver
//   (ops/essvi.py, _fit_essvi_block) runs it eagerly: vmap(jacfwd) slice
//   Jacobians at the quotes and on the penalty grid, einsums for the
//   slice-space blocks, a block Thomas loop of about 574 launches an
//   iteration on (surfaces, 3, 3) blocks, and the trial cost, each a pass
//   of (surfaces, E, n) intermediates through device memory. This kernel
//   runs that loop's algorithm with a surface on the chip for all of its
//   iterations. Wrapper: iv_interpolation_tpu_torch/ops/cuda/essvi_lm.py;
//   its plain version is the eager loop itself.
//
// Layout: k, w and the weights (surfaces, E, n) row-major; k_pen (surfaces,
// m), the calendar hinge's grid; z0 (surfaces, 3E) = (z_theta, z_rho, z_psi)
// each of E entries, the start essvi_init gives; params (surfaces, E, 3) =
// (theta, rho, psi); cost, n_accepted and converged (surfaces). A null
// weights pointer means unit weights.
//
// The algorithm is _fit_essvi_block's:
//   * the transform: theta = cumsum(logaddexp(z_theta, 0) + 1e-8) + 1e-6,
//     summed expiry after expiry from the first (so theta never falls),
//     rho = 0.999 tanh(z_rho), psi = 0.999 cap(theta, rho) sigmoid(z_psi)
//     with cap = min(4 / (1 + |rho|), sqrt(4 theta / (1 + |rho|)));
//   * the residual: (w(k) - w_q) wt at the quotes, then the hinge
//     cw min(w_{e+1} - w_e, 0) on k_pen for each pair of adjacent expiries;
//   * the slice-space system: g_e and D_e from expiry e's quotes and the
//     hinges it takes part in (only where the gap is negative), U_e the
//     coupling of e and e + 1 through their hinge;
//   * the damping: lam max(diag D_e, 1e-12) + 1e-8 max(max diag, 1) on the
//     diagonal, the floor keyed to the surface's largest diagonal entry;
//   * the solve of that symmetric block-tridiagonal system against -g by
//     block elimination with closed-form 3 x 3 inverses (their cofactors the
//     cross products of the rows), each block inverted once;
//   * the pullback of the slice-space step to z through the transform's
//     inverse tangent map (d|rho|/d rho = +1 at 0; half the gradient to each
//     cap where they tie);
//   * acceptance of a finite z with a lower cost, lam / 3 on acceptance and
//     x 3 otherwise within [1e-12, 1e12], and convergence on an accepted
//     step below 1e-12 (1 + max |z|) or an accepted improvement below
//     1e-12 max(cost, 1); a converged surface is frozen.
// The slice Jacobian is in closed form, with u = psi k + theta rho and
// R = sqrt(u^2 + theta^2 (1 - rho^2)) (R's tangent 0 where it is clamped at
// 1e-12, as jacfwd of the clamp gives it):
//   dw/dtheta = (1 + (u rho + theta (1 - rho^2)) / R) / 2,
//   dw/drho   = (psi k + theta psi k / R) / 2,
//   dw/dpsi   = (rho k + u k / R) / 2.
// The blocks are eliminated in the eager loop's order (block Thomas, each
// Schur complement inverted once); where no hinge is active on the surface
// (U = 0: every elimination leaves each block as it is) each block is solved
// alone. Sums are taken in another order than the eager loop's einsums, and
// multiply-adds may fuse: in float64 the two agree to rounding (about 1e-14
// of a parameter on the book's surfaces).
//
// Work that gives the same numbers, skipped: after a rejected trial z is
// unchanged, so the system is the one already held: the kernel linearises
// only at the start and after an accepted step, and a rejected trial runs
// the damping, the solve, the pullback, the transform and the cost alone. A
// converged surface stops; so does one whose trial is rejected with lam at
// its ceiling, since every later iteration repeats that one exactly.
//
// What bounds it on the H100: issued instructions. A call reads the quotes
// once (0.4 GB at the cell's 32,768 x 30 x 50 in float32, 0.12 ms at 3.35
// TB/s). Its work a surface is a full pass (w, its Jacobian, g, D, U and
// the cost: about 60 instructions a point) at the start and after each
// accepted step and a cost-only pass (about 20 a point) each iteration,
// over 30 x 50 quotes and 29 x 33 hinge points, and each iteration's solve,
// pullback and transform (about 150 an expiry): 1.06e11 instructions a
// call at the cell's shape (42.0 iterations up to a surface's stop, 5.7
// accepted), 3.17 ms at 128 float32 lanes x 132 SMs x 1.98 GHz. It runs in
// about 8.7 ms on an H100 at 700 W. Measured there in float32 at that
// shape, 50 iterations: the block Thomas chain takes 17.6 ms without the
// uncoupled shortcut and 8.5-8.7 ms with it (block cyclic reduction across
// the lanes, tried: 12.0 and 8.3 ms).
//
// What the design does about it: one warp a surface, lane e owning expiry
// e (E <= 32), so the data term's sums need no reduction: lane e keeps
// D_e, U_e and g_e in registers. The hinge couples expiries e and e + 1 at
// the same grid point: lane e + 1's w and Jacobian arrive by a shuffle. The
// theta cumsum is a broadcast of each increment, added in expiry order;
// the pullback's difference is one shuffle; the damping floor's maximum,
// the cost and the convergence tests are warp reductions. The chain passes
// each Schur complement's products up one lane and each x down one lane.
// Each warp first copies its surface's quotes, coalesced, into shared
// memory as [quote][expiry], so that lane e's reads are one conflict-free
// access a quote for all iterations; a block holds up to kMaxWarps surfaces within 48 KiB (four at
// the cell's shape in float32), and a surface whose quotes do not fit alone
// reads them in device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;                 // one warp a surface, lane e expiry e
constexpr int kMaxWarps = 4;               // surfaces a block
constexpr long long kMaxSmem = 48 * 1024;  // the default dynamic limit

// ops/essvi.py's transform and its guards
constexpr double kRhoMax = 0.999;
constexpr double kPsiFrac = 0.999;
constexpr double kThetaMin = 1e-6;
constexpr double kDthetaMin = 1e-8;
constexpr double kTiny = 1e-8;       // the pullback's divisors and the damping floor
constexpr double kRootMin = 1e-12;   // R's clamp
constexpr double kDiagMin = 1e-12;   // the damping's floor on each diagonal entry

__device__ __forceinline__ float Sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double Sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float Exp(float x) { return expf(x); }
__device__ __forceinline__ double Exp(double x) { return exp(x); }
__device__ __forceinline__ float Log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double Log1p(double x) { return log1p(x); }
__device__ __forceinline__ float Tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double Tanh(double x) { return tanh(x); }
__device__ __forceinline__ float Abs(float x) { return fabsf(x); }
__device__ __forceinline__ double Abs(double x) { return fabs(x); }

// PyTorch's clamp_min: a NaN stays NaN
template <typename T>
__device__ __forceinline__ T at_least(T x, T lo) {
  return x < lo ? lo : x;
}

template <typename T>
__device__ __forceinline__ T larger(T a, T b) {
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T sigmoid(T x) {
  return T(1) / (T(1) + Exp(-x));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;  // the same bits on every lane: each step adds the same two values
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v = larger(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// psi's butterfly cap min(4 / (1 + |rho|), sqrt(4 theta / (1 + |rho|)))
template <typename T>
__device__ __forceinline__ T psi_cap(T theta, T rho) {
  const T one_r = T(1) + Abs(rho);
  const T flat = T(4) / one_r;
  const T root = Sqrt(T(4) * theta / one_r);
  return flat < root ? flat : root;
}

// One lane's expiry: its unconstrained z and the parameters they give.
template <typename T>
struct Expiry {
  T zt, zr, zp;
  T theta, rho, psi;
};

// theta, rho and psi of every lane's z. theta_e is the sum of the first
// e + 1 increments taken in expiry order, as a sequential cumsum takes it:
// each increment is positive, so theta never falls from one expiry to the
// next, in any rounding.
template <typename T>
__device__ __forceinline__ void transform(Expiry<T>& x, int lane, int E) {
  const T softplus = larger(x.zt, T(0)) + Log1p(Exp(-Abs(x.zt)));  // logaddexp(z, 0)
  const T d = softplus + T(kDthetaMin);
  T theta = T(0);
  for (int i = 0; i < E; ++i) {
    const T di = __shfl_sync(kFull, d, i);
    if (i <= lane) theta += di;
  }
  x.theta = theta + T(kThetaMin);
  x.rho = T(kRhoMax) * Tanh(x.zr);
  x.psi = T(kPsiFrac) * psi_cap(x.theta, x.rho) * sigmoid(x.zp);
}

// A slice's constants: w(k) = (theta + rho psi k + R) / 2 with
// R = sqrt(u^2 + c), u = psi k + theta rho, c = theta^2 (1 - rho^2).
template <typename T>
struct Slice {
  T theta, rho, psi, tr, rp, c, a1;  // a1 = theta (1 - rho^2)
};

template <typename T>
__device__ __forceinline__ Slice<T> slice_of(const Expiry<T>& x) {
  const T one_m = T(1) - x.rho * x.rho;
  return {x.theta, x.rho, x.psi, x.theta * x.rho, x.rho * x.psi,
          x.theta * x.theta * one_m, x.theta * one_m};
}

template <typename T>
__device__ __forceinline__ T w_at(const Slice<T>& c, T k) {
  const T u = c.psi * k + c.tr;
  const T R = at_least(Sqrt(u * u + c.c), T(kRootMin));
  return T(0.5) * ((c.theta + c.rp * k) + R);
}

// w at k and dw/d(theta, rho, psi) there
template <typename T>
__device__ __forceinline__ T w_jac(const Slice<T>& c, T k, T (&J)[3]) {
  const T u = c.psi * k + c.tr;
  const T R0 = Sqrt(u * u + c.c);
  const bool clamped = R0 < T(kRootMin);
  const T R = clamped ? T(kRootMin) : R0;
  const T iR = clamped ? T(0) : T(1) / R;
  const T pk = c.psi * k;
  J[0] = T(0.5) * (T(1) + (u * c.rho + c.a1) * iR);
  J[1] = T(0.5) * (pk + c.theta * pk * iR);
  J[2] = T(0.5) * (c.rho * k + u * k * iR);
  return T(0.5) * ((c.theta + c.rp * k) + R);
}

// One lane's slice: quote j at k[j * stride] (and w, wt); n = 0 on a lane
// past the last expiry. kp: the surface's hinge grid, the same on every lane.
template <typename T>
struct Quotes {
  const T* k;
  const T* w;
  const T* wt;
  const T* kp;
  int stride, n, m;
};

// Lane e's rows of the slice-space normal equations.
template <typename T>
struct System {
  T d[6];  // D_e: (0,0) (0,1) (0,2) (1,1) (1,2) (2,2)
  T u[9];  // U_e, row-major: expiry e's rows against expiry e + 1's columns
  T g[3];
};

template <typename T>
__device__ __forceinline__ void add_outer(T (&d)[6], const T (&a)[3]) {
  d[0] += a[0] * a[0];
  d[1] += a[0] * a[1];
  d[2] += a[0] * a[2];
  d[3] += a[1] * a[1];
  d[4] += a[1] * a[2];
  d[5] += a[2] * a[2];
}

// The full pass at x: lane e's D_e, U_e and g_e into s; returns its share of
// the sum of squared residuals (the data term at its quotes, and the hinge
// of the pair (e, e + 1)).
template <typename T, bool kWeighted>
__device__ __forceinline__ T linearize(const Expiry<T>& x, const Quotes<T>& q, int lane, int E,
                                       T cw, System<T>& s) {
#pragma unroll
  for (int i = 0; i < 6; ++i) s.d[i] = T(0);
#pragma unroll
  for (int i = 0; i < 9; ++i) s.u[i] = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) s.g[i] = T(0);
  T rr = T(0);
  const Slice<T> c = slice_of(x);
  for (int j = 0; j < q.n; ++j) {
    T J[3];
    const T kj = q.k[j * q.stride];
    T r = w_jac(c, kj, J) - q.w[j * q.stride];
    if (kWeighted) {
      const T a = q.wt[j * q.stride];
      r *= a;
#pragma unroll
      for (int i = 0; i < 3; ++i) J[i] *= a;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) s.g[i] += J[i] * r;
    add_outer(s.d, J);
    rr += r * r;
  }
  if (cw > T(0)) {
    for (int j = 0; j < q.m; ++j) {
      T J[3], Jn[3];
      const T wp = w_jac(c, q.kp[j], J);
      const T wn = __shfl_down_sync(kFull, wp, 1);
#pragma unroll
      for (int i = 0; i < 3; ++i) Jn[i] = __shfl_down_sync(kFull, J[i], 1);
      const T gap = wn - wp;                                 // the pair (e, e + 1)
      const T gap_below = __shfl_up_sync(kFull, gap, 1);     // the pair (e - 1, e)
      if (lane < E - 1) {
        const T rc = cw * (gap > T(0) ? T(0) : gap);
        rr += rc * rc;
        if (gap < T(0)) {
          T lo[3], hi[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            lo[i] = -cw * J[i];
            hi[i] = cw * Jn[i];
          }
#pragma unroll
          for (int i = 0; i < 3; ++i) s.g[i] += lo[i] * rc;
          add_outer(s.d, lo);
#pragma unroll
          for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int b = 0; b < 3; ++b) s.u[a * 3 + b] += lo[a] * hi[b];
          }
        }
      }
      if (lane >= 1 && lane < E && gap_below < T(0)) {
        const T rc = cw * gap_below;
        T hi[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) hi[i] = cw * J[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) s.g[i] += hi[i] * rc;
        add_outer(s.d, hi);
      }
    }
  }
  return rr;
}

// The cost-only pass: lane e's share of the sum of squared residuals at x.
template <typename T, bool kWeighted>
__device__ __forceinline__ T residual_sq(const Expiry<T>& x, const Quotes<T>& q, int lane,
                                         int E, T cw) {
  T rr = T(0);
  const Slice<T> c = slice_of(x);
  for (int j = 0; j < q.n; ++j) {
    T r = w_at(c, q.k[j * q.stride]) - q.w[j * q.stride];
    if (kWeighted) r *= q.wt[j * q.stride];
    rr += r * r;
  }
  if (cw > T(0)) {
    for (int j = 0; j < q.m; ++j) {
      const T wp = w_at(c, q.kp[j]);
      const T gap = __shfl_down_sync(kFull, wp, 1) - wp;
      if (lane < E - 1) {
        const T rc = cw * (gap > T(0) ? T(0) : gap);
        rr += rc * rc;
      }
    }
  }
  return rr;
}

// Closed-form 3 x 3 inverse: the cofactors of row i are the cross product
// of the other two rows (ops/essvi._inv3x3).
template <typename T>
__device__ __forceinline__ void inverse3(const T (&a)[9], T (&out)[9]) {
  const T c1[3] = {a[4] * a[8] - a[5] * a[7], a[5] * a[6] - a[3] * a[8],
                   a[3] * a[7] - a[4] * a[6]};  // r2 x r3
  const T c2[3] = {a[7] * a[2] - a[8] * a[1], a[8] * a[0] - a[6] * a[2],
                   a[6] * a[1] - a[7] * a[0]};  // r3 x r1
  const T c3[3] = {a[1] * a[5] - a[2] * a[4], a[2] * a[3] - a[0] * a[5],
                   a[0] * a[4] - a[1] * a[3]};  // r1 x r2
  const T inv_det = T(1) / (a[0] * c1[0] + a[1] * c1[1] + a[2] * c1[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i * 3 + 0] = c1[i] * inv_det;
    out[i * 3 + 1] = c2[i] * inv_det;
    out[i * 3 + 2] = c3[i] * inv_det;
  }
}

template <typename T>
__device__ __forceinline__ void matvec(const T (&a)[9], const T (&x)[3], T (&y)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = a[i * 3] * x[0] + a[i * 3 + 1] * x[1] + a[i * 3 + 2] * x[2];
}

// c = a b of 3 x 3 row-major matrices
template <typename T>
__device__ __forceinline__ void matmul(const T (&a)[9], const T (&b)[9], T (&c)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c[i * 3 + j] = a[i * 3] * b[j] + a[i * 3 + 1] * b[3 + j] + a[i * 3 + 2] * b[6 + j];
    }
  }
}

// The damped system's step: (D + damp I, U) x = -g by the eager loop's
// block Thomas chain (ops/essvi._block_thomas), its Schur complements
// passed lane to lane. Going up the expiries, lane e takes
// M = U_{e-1}^T S_{e-1}^{-1} U_{e-1} and v = U_{e-1}^T S_{e-1}^{-1} y_{e-1}
// from lane e - 1, inverts S_e = A_e - M once and forms y_e = b_e - v; going
// down, lane e takes x_{e+1} from lane e + 1 and forms
// x_e = S_e^{-1} (y_e - U_e x_{e+1}). Each step has one lane busy. Where no
// hinge is active on the surface (U = 0, the common case) every step leaves
// each block as it is, so each lane solves its own block at once. Lanes past
// E hold x = 0.
template <typename T>
__device__ __forceinline__ void solve(const System<T>& s, T lam, int lane, int E, T (&x)[3]) {
  const bool live = lane < E;
  const T diag_max = warp_max(live ? larger(larger(s.d[0], s.d[3]), s.d[5]) : T(0));
  const T floor = T(kTiny) * larger(diag_max, T(1));
  T a[9], b[3];
  {
    const T d[9] = {s.d[0], s.d[1], s.d[2], s.d[1], s.d[3], s.d[4], s.d[2], s.d[4], s.d[5]};
#pragma unroll
    for (int i = 0; i < 9; ++i) a[i] = d[i];
  }
  a[0] += lam * at_least(s.d[0], T(kDiagMin)) + floor;
  a[4] += lam * at_least(s.d[3], T(kDiagMin)) + floor;
  a[8] += lam * at_least(s.d[5], T(kDiagMin)) + floor;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    b[i] = -s.g[i];
    x[i] = T(0);
  }
  bool coupled = false;
#pragma unroll
  for (int i = 0; i < 9; ++i) coupled = coupled || s.u[i] != T(0);
  T ai[9];
  if (!__any_sync(kFull, coupled)) {
    if (live) {
      inverse3(a, ai);
      matvec(ai, b, x);
    }
    return;
  }
  T y[3], m[9], v[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = T(0);
  for (int e = 0; e < E; ++e) {
    T send[12] = {};
    if (lane == e) {
#pragma unroll
      for (int i = 0; i < 9; ++i) a[i] -= m[i];
      inverse3(a, ai);
#pragma unroll
      for (int i = 0; i < 3; ++i) y[i] = b[i] - v[i];
      T su[9], sy[3];
      matmul(ai, s.u, su);  // S_e^{-1} U_e
      matvec(ai, y, sy);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          send[i * 3 + j] = s.u[i] * su[j] + s.u[3 + i] * su[3 + j] + s.u[6 + i] * su[6 + j];
        }
        send[9 + i] = s.u[i] * sy[0] + s.u[3 + i] * sy[1] + s.u[6 + i] * sy[2];
      }
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) m[i] = __shfl_up_sync(kFull, send[i], 1);
#pragma unroll
    for (int i = 0; i < 3; ++i) v[i] = __shfl_up_sync(kFull, send[9 + i], 1);
  }
  T next[3] = {T(0), T(0), T(0)};  // x_{e+1}, from lane e + 1
  for (int e = E - 1; e >= 0; --e) {
    if (lane == e) {
      T t[3];
      matvec(s.u, next, t);
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = y[i] - t[i];
      matvec(ai, t, x);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) next[i] = __shfl_down_sync(kFull, x[i], 1);
  }
}

// z + the slice-space step d taken back through the transform's inverse
// tangent map (ops/essvi._pullback_step, psi_butterfly_cap_grads).
template <typename T>
__device__ __forceinline__ void pullback(const Expiry<T>& x, const T (&d)[3], int lane,
                                         Expiry<T>& nx) {
  const T below = __shfl_up_sync(kFull, d[0], 1);
  const T incr = lane == 0 ? d[0] : d[0] - below;
  const T dzt = incr / at_least(sigmoid(x.zt), T(kTiny));
  const T th = Tanh(x.zr);
  const T dzr = d[1] / at_least(T(kRhoMax) * (T(1) - th * th), T(kTiny));
  const T one_r = T(1) + Abs(x.rho);
  const T flat = T(4) / one_r;
  const T root = Sqrt(T(4) * x.theta / one_r);
  const T cap = flat < root ? flat : root;
  const T sign = x.rho >= T(0) ? T(1) : T(-1);
  const T flat_rho = T(-4) / (one_r * one_r) * sign;
  const T half_inv_root = T(0.5) / root;
  const T root_theta = half_inv_root * (T(4) / one_r);
  const T root_rho = half_inv_root * (T(-4) * x.theta / (one_r * one_r)) * sign;
  const T share = flat < root ? T(1) : (flat == root ? T(0.5) : T(0));
  const T cap_th = (T(1) - share) * root_theta;
  const T cap_rho = share * flat_rho + (T(1) - share) * root_rho;
  const T sp = sigmoid(x.zp);
  const T induced = T(kPsiFrac) * sp * (cap_th * d[0] + cap_rho * d[1]);
  const T dzp = (d[2] - induced) / at_least(T(kPsiFrac) * cap * sp * (T(1) - sp), T(kTiny));
  nx.zt = x.zt + dzt;
  nx.zr = x.zr + dzr;
  nx.zp = x.zp + dzp;
}

// Warp w of block b calibrates surface b * (blockDim.x / 32) + w. In
// float32 at most 128 registers a thread, so that 16 warps (the most that
// the staged quotes let share an SM at the cell's shape) fit; float64 stages
// half as many surfaces an SM and takes up to twice the registers.
template <typename T, bool kWeighted, bool kStaged>
__global__ void __launch_bounds__(kMaxWarps * kLanes, sizeof(T) == 4 ? 4 : 2)
essvi_lm_kernel(const T* __restrict__ k, const T* __restrict__ w, const T* __restrict__ wt,
                const T* __restrict__ k_pen, const T* __restrict__ z0, T* __restrict__ params,
                T* __restrict__ cost_out, int* __restrict__ n_accepted,
                unsigned char* __restrict__ converged, long long surfaces, int E, int n, int m,
                int iters, T cw, T lambda0, T tol, int per_warp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = static_cast<int>(threadIdx.x) & (kLanes - 1);
  const int warp = static_cast<int>(threadIdx.x) / kLanes;
  const long long s = static_cast<long long>(blockIdx.x) * (blockDim.x / kLanes) + warp;
  if (s >= surfaces) return;  // the whole warp
  const bool live = lane < E;
  const long long q0 = s * E * n;
  Quotes<T> q;
  if (kStaged) {
    // the surface's quotes as [quote][expiry], then its hinge grid
    T* sk = reinterpret_cast<T*>(smem) + static_cast<long long>(warp) * per_warp;
    T* sw = sk + n * E;
    T* swt = sw + n * E;
    T* skp = kWeighted ? swt + n * E : swt;
    for (int i = lane; i < E * n; i += kLanes) {
      const int e = i / n, j = i - e * n;
      sk[j * E + e] = __ldg(k + q0 + i);
      sw[j * E + e] = __ldg(w + q0 + i);
      if (kWeighted) swt[j * E + e] = __ldg(wt + q0 + i);
    }
    for (int j = lane; j < m; j += kLanes) skp[j] = __ldg(k_pen + s * m + j);
    __syncwarp();
    q = {sk + lane, sw + lane, swt + lane, skp, E, live ? n : 0, m};
  } else {
    const long long row = q0 + static_cast<long long>(lane) * n;
    q = {k + row, w + row, kWeighted ? wt + row : nullptr, k_pen + s * m, 1, live ? n : 0, m};
  }

  Expiry<T> x;
  const long long zb = s * 3 * E;
  x.zt = live ? z0[zb + lane] : T(0);
  x.zr = live ? z0[zb + E + lane] : T(0);
  x.zp = live ? z0[zb + 2 * E + lane] : T(0);
  transform(x, lane, E);
  System<T> sys;
  T cost = T(0.5) * warp_sum(linearize<T, kWeighted>(x, q, lane, E, cw, sys));
  T lam = lambda0;
  int accepted = 0;
  bool done = false, fresh = true;  // fresh: sys is the system at x
  for (int it = 0; it < iters; ++it) {
    if (!fresh) {
      linearize<T, kWeighted>(x, q, lane, E, cw, sys);
      fresh = true;
    }
    T step[3];
    solve(sys, lam, lane, E, step);
    Expiry<T> nx;
    pullback(x, step, lane, nx);
    if (!live) nx.zt = nx.zr = nx.zp = T(0);  // a lane past E holds no expiry
    transform(nx, lane, E);
    const T cost_new = T(0.5) * warp_sum(residual_sq<T, kWeighted>(nx, q, lane, E, cw));
    const bool finite = !live || (isfinite(nx.zt) && isfinite(nx.zr) && isfinite(nx.zp));
    const bool accept = __all_sync(kFull, finite) && cost_new < cost;
    if (accept) {
      const T step_max = warp_max(
          live ? larger(larger(Abs(step[0]), Abs(step[1])), Abs(step[2])) : T(0));
      const T z_max =
          warp_max(live ? larger(larger(Abs(nx.zt), Abs(nx.zr)), Abs(nx.zp)) : T(0));
      const bool small_step = step_max < tol * (T(1) + z_max);
      const bool small_impr = cost - cost_new < tol * larger(cost, T(1));
      x = nx;
      cost = cost_new;
      ++accepted;
      fresh = false;
      lam = at_least(lam / T(3), T(1e-12));
      if (lam > T(1e12)) lam = T(1e12);
      done = small_step || small_impr;
      if (done) break;
    } else {
      const T before = lam;
      lam = at_least(lam * T(3), T(1e-12));
      if (lam > T(1e12)) lam = T(1e12);
      if (lam == before) break;  // every later iteration repeats this one
    }
  }
  if (live) {
    T* p = params + (s * E + lane) * 3;
    p[0] = x.theta;
    p[1] = x.rho;
    p[2] = x.psi;
  }
  if (lane == 0) {
    cost_out[s] = cost;
    n_accepted[s] = accepted;
    converged[s] = done ? 1 : 0;
  }
}

// The staged route where one surface's quotes fit in kMaxSmem (as many
// surfaces a block as fit, up to kMaxWarps), else the global one.
template <typename T, bool kWeighted>
int launch_routed(const T* k, const T* w, const T* wt, const T* k_pen, const T* z0, T* params,
                  T* cost, int* n_accepted, unsigned char* converged, long long surfaces, int E,
                  int n, int m, int iters, T cw, T lambda0, T tol, cudaStream_t st) {
  const long long per_warp = (kWeighted ? 3LL : 2LL) * n * E + m;
  const long long bytes = per_warp * static_cast<long long>(sizeof(T));
  int warps = kMaxWarps;
  while (warps > 1 && warps * bytes > kMaxSmem) --warps;
  const bool staged = warps * bytes <= kMaxSmem;
  if (!staged) warps = kMaxWarps;
  const long long blocks = (surfaces + warps - 1) / warps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  const unsigned threads = static_cast<unsigned>(warps * kLanes);
  if (staged) {
    essvi_lm_kernel<T, kWeighted, true><<<grid, threads, static_cast<size_t>(warps * bytes), st>>>(
        k, w, wt, k_pen, z0, params, cost, n_accepted, converged, surfaces, E, n, m, iters, cw,
        lambda0, tol, static_cast<int>(per_warp));
  } else {
    essvi_lm_kernel<T, kWeighted, false><<<grid, threads, 0, st>>>(
        k, w, wt, k_pen, z0, params, cost, n_accepted, converged, surfaces, E, n, m, iters, cw,
        lambda0, tol, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* k, const T* w, const T* wt, const T* k_pen, const T* z0, T* params, T* cost,
           int* n_accepted, unsigned char* converged, long long surfaces, int E, int n, int m,
           int iters, double calendar_weight, double lambda0, double tol, void* stream) {
  if (surfaces < 1 || E < 1 || E > kLanes || n < 1 || m < 0 || iters < 0 ||
      static_cast<long long>(E) * n > 2147483647LL / 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T cw = static_cast<T>(calendar_weight);
  if (wt != nullptr) {
    return launch_routed<T, true>(k, w, wt, k_pen, z0, params, cost, n_accepted, converged,
                                  surfaces, E, n, m, iters, cw, static_cast<T>(lambda0),
                                  static_cast<T>(tol), st);
  }
  return launch_routed<T, false>(k, w, wt, k_pen, z0, params, cost, n_accepted, converged,
                                 surfaces, E, n, m, iters, cw, static_cast<T>(lambda0),
                                 static_cast<T>(tol), st);
}

}  // namespace

// k, w, weights (null: unit) (surfaces, E, n), k_pen (surfaces, m) and z0
// (surfaces, 3E) in; params (surfaces, E, 3), cost, n_accepted (int32) and
// converged (one byte, 0 or 1) out. E at most 32.
extern "C" int ivt_essvi_lm_f32(const float* k, const float* w, const float* wt,
                                const float* k_pen, const float* z0, float* params, float* cost,
                                int* n_accepted, unsigned char* converged, long long surfaces,
                                int E, int n, int m, int iters, double calendar_weight,
                                double lambda0, double tol, void* stream) {
  return launch<float>(k, w, wt, k_pen, z0, params, cost, n_accepted, converged, surfaces, E, n,
                       m, iters, calendar_weight, lambda0, tol, stream);
}

extern "C" int ivt_essvi_lm_f64(const double* k, const double* w, const double* wt,
                                const double* k_pen, const double* z0, double* params,
                                double* cost, int* n_accepted, unsigned char* converged,
                                long long surfaces, int E, int n, int m, int iters,
                                double calendar_weight, double lambda0, double tol,
                                void* stream) {
  return launch<double>(k, w, wt, k_pen, z0, params, cost, n_accepted, converged, surfaces, E, n,
                        m, iters, calendar_weight, lambda0, tol, stream);
}
