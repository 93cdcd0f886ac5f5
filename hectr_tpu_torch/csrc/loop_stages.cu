// The CSTR closed loop's own stages for Hopper (sm_90a): K13, one step of
// everything of a loop step but the regulator, for every plant of a batch in
// one launch.
//
// It replaces no TPU kernel: in the JAX package these stages are XLA code
// that jax.jit fuses into the one program of a loop step on a TPU
// (hectr_tpu/control/simulate.py, stages.py, ode.py, plants/cstr.py).  Eager
// PyTorch runs them as some 245 float64 kernels a step, and as a CUDA graph
// of those kernels fed by 6 input copies and drained by 5 clones; this kernel
// makes them one launch that reads its inputs where they lie and writes its
// outputs once.
//
// Per plant row, in float64 and in the order of
// hectr_tpu_torch/control/simulate.py Stages.step, each operation as the port
// runs it on the card (every product and sum a round-to-nearest intrinsic, so
// nvcc contracts nothing into an FMA):
//   * actuate (control/stages.py): the plant in absolute units, two
//     linearly-implicit substeps at dt/2 (control/ode.py stiff_step), each
//     with cstr_ode and cstr_jacobian (control/plants/cstr.py: the Arrhenius
//     factor K0 exp((1/T) (-E/R)), as PyTorch divides a scalar by a tensor,
//     and (F0 - F) (1/S), as it divides a tensor by a scalar), I - dt J and a
//     3x3 solve by elimination with partial pivoting, column j's pivot the
//     first row of largest magnitude there (ode.solve_pivoted's rule);
//   * estimate_forward: xhatm = A xhat + B u + Bd dhat, dhatm = dhat;
//   * with the next step's observation: measure (y = C x), measure_forward
//     (e = y - C xhatm - Cd dhatm, xhat = xhatm + Lx e, dhat = dhatm + Ld e)
//     and select_target ((xr, ur) = Ginv [Bd dhat; rsp - Hr Cd dhat]).
// A matrix-vector product sums over its columns in ascending order; the
// port's elementwise product and sum (stages.apply) sums in the order of
// PyTorch's reduction, so the two may round apart by ulps.  An observe-only
// mode runs the last item alone on (x, xhatm, dhatm): an episode's first
// measurement update and selector.
//
// Shapes: nx = 3, nu = 2, np = 1 (the CSTR), ny = 1..3 outputs, nd = 0..3
// disturbances.  The constants (A, B, C, Bd, Cd, Hr, Lx, Ld, Ginv, xs, us,
// ps, the plant's scalars and dt / 2) lie in one float64 buffer of kWords
// words, laid out as LAYOUT in hectr_tpu_torch/ops/stages_cuda.py; each
// block stages it in shared memory before its rows start.  The six inputs
// are read through a row stride each (a stride of 0 broadcasts one row; the
// disturbance row p_seq[..., k, :] is a strided view); the output is one
// contiguous [rows, 11 + nd] row each: x, xhat, dhat, xr, ur.
//
// What bounds it on this card: a few hundred dependent float64 operations a
// row (four exponentials, eight divisions in the solves) and (2 (11 + nd) +
// kWords) words of device memory: 1,104 bytes at one plant, 0.3 ns at 3.35
// TB/s, and 214 kB at 1,024 plants, 64 ns.  One plant is bound by the latency
// of one launch and of one thread's chain, which is what the design answers:
// one launch with no copies around it, one thread a row, the constants read
// from device memory once a block, in parallel by its threads.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// The constants' layout (ops/stages_cuda.py LAYOUT): every matrix row-major
// at a row stride of kRow words, Ginv at kNr.
constexpr int kA = 0, kB = 9, kC = 18, kBd = 27, kCd = 36, kHr = 45,
              kLx = 51, kLd = 60, kGinv = 69, kXs = 94, kUs = 97, kPs = 99,
              kPlant = 100, kWords = 112;
constexpr int kRow = 3, kNx = 3, kNu = 2, kNr = 5, kMaxOut = 3;
// the plant's scalars from kPlant on (ops/stages_cuda.py PLANT), then dt / 2
enum PlantWord { kS, kInvS, kHeat, kCool, kK0, kE, kNegE, kC0, kT0, kHalfDt };
enum Mode { kStep = 0, kStepObserve = 1, kObserve = 2 };

struct StageArgs {
  const double* consts;
  const double* x;
  const double* u;
  const double* p;
  const double* xhat;
  const double* dhat;
  const double* rsp;
  int64_t sx, su, sp, sxhat, sdhat, srsp;   // row strides, in words
  double* out;
  int64_t rows;
  int ny, nd, mode;
};

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double div(double a, double b) {
  return __ddiv_rn(a, b);
}

// sum_j m[j] v[j], j ascending, from zero (an empty sum is 0)
__device__ __forceinline__ double dot(const double* m, const double* v,
                                      int n) {
  double s = 0.0;
  for (int j = 0; j < n; ++j) s = add(s, mul(m[j], v[j]));
  return s;
}

// torch.argmax's rule: the first largest, a NaN the largest
__device__ __forceinline__ bool larger(double v, double best) {
  return v > best || (isnan(v) && !isnan(best));
}

// One linearly-implicit substep x + dt (I - dt J)^-1 f(x) of the CSTR at
// (x, u, F0), in place; k holds the constants.
__device__ void stiff_step(const double* k, double x[kNx],
                           const double u[kNu], double F0) {
  const double* q = k + kPlant;
  const double c = x[0], T = x[1], h = x[2];
  const double kT = mul(q[kK0], exp(mul(div(1.0, T), q[kNegE])));
  const double Sh = mul(h, q[kS]);
  const double Shh = mul(Sh, h);
  const double TT = mul(T, T);
  const double nF0_Sh = div(-F0, Sh);
  const double f[kNx] = {
      sub(div(mul(F0, sub(q[kC0], c)), Sh), mul(kT, c)),
      add(add(div(mul(F0, sub(q[kT0], T)), Sh), mul(mul(q[kHeat], kT), c)),
          mul(q[kCool], sub(u[0], T))),
      mul(sub(F0, u[1]), q[kInvS])};
  const double J[kNx][kNx] = {
      {sub(nF0_Sh, kT), mul(div(mul(-kT, q[kE]), TT), c),
       div(mul(-F0, sub(q[kC0], c)), Shh)},
      {mul(q[kHeat], kT),
       sub(add(nF0_Sh, mul(div(mul(mul(q[kHeat], kT), q[kE]), TT), c)),
           q[kCool]),
       div(mul(-F0, sub(q[kT0], T)), Shh)},
      {0.0, 0.0, 0.0}};
  const double dt = q[kHalfDt];
  // [I - dt J | f], then elimination with partial pivoting as
  // ode.solve_pivoted: the pivot row out, the first row in its place
  double m[kNx][kNx + 1];
  for (int i = 0; i < kNx; ++i) {
    for (int j = 0; j < kNx; ++j)
      m[i][j] = sub(i == j ? 1.0 : 0.0, mul(dt, J[i][j]));
    m[i][kNx] = f[i];
  }
  int piv = 0;
  for (int i = 1; i < kNx; ++i)
    if (larger(fabs(m[i][0]), fabs(m[piv][0]))) piv = i;
  double u0[kNx + 1], r[kNx - 1][kNx];
  for (int j = 0; j <= kNx; ++j) u0[j] = m[piv][j];
  for (int i = 0; i < kNx - 1; ++i) {
    const double* o = m[i + 1 == piv ? 0 : i + 1];
    const double factor = div(o[0], u0[0]);
    for (int j = 0; j < kNx; ++j)
      r[i][j] = sub(o[j + 1], mul(factor, u0[j + 1]));
  }
  const int piv1 = larger(fabs(r[1][0]), fabs(r[0][0])) ? 1 : 0;
  const double* u1 = r[piv1];
  const double* o = r[1 - piv1];
  const double factor = div(o[0], u1[0]);
  const double u22 = sub(o[1], mul(factor, u1[1]));
  const double c2 = sub(o[2], mul(factor, u1[2]));
  // back substitution
  const double s2 = div(c2, u22);
  const double s1 = div(sub(u1[2], mul(u1[1], s2)), u1[0]);
  const double s0 = div(sub(sub(u0[3], mul(u0[1], s1)), mul(u0[2], s2)),
                        u0[0]);
  x[0] = add(c, mul(dt, s0));
  x[1] = add(T, mul(dt, s1));
  x[2] = add(h, mul(dt, s2));
}

__global__ void __launch_bounds__(kThreads)
    loop_stages_kernel(const StageArgs a) {
  __shared__ double k[kWords];
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) k[i] = a.consts[i];
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (r >= a.rows) return;
  const int ny = a.ny, nd = a.nd;
  double x[kNx], xhatm[kNx], dhatm[kMaxOut];
  for (int i = 0; i < kNx; ++i) x[i] = a.x[r * a.sx + i];
  if (a.mode != kStep) {
    for (int i = 0; i < kNx; ++i) xhatm[i] = a.xhat[r * a.sxhat + i];
    for (int i = 0; i < nd; ++i) dhatm[i] = a.dhat[r * a.sdhat + i];
  }
  if (a.mode != kObserve) {
    // actuate: two substeps at dt / 2 in absolute units
    double u[kNu], uu[kNu], xx[kNx];
    for (int i = 0; i < kNu; ++i) {
      u[i] = a.u[r * a.su + i];
      uu[i] = add(u[i], k[kUs + i]);
    }
    const double F0 = add(a.p[r * a.sp], k[kPs]);
    for (int i = 0; i < kNx; ++i) xx[i] = add(x[i], k[kXs + i]);
    stiff_step(k, xx, uu, F0);
    stiff_step(k, xx, uu, F0);
    for (int i = 0; i < kNx; ++i) x[i] = sub(xx[i], k[kXs + i]);
    if (a.mode == kStepObserve) {
      // estimate_forward: xhatm' = A xhat + B u + Bd dhat; dhatm' = dhat
      double xh[kNx];
      for (int i = 0; i < kNx; ++i) xh[i] = xhatm[i];
      for (int i = 0; i < kNx; ++i)
        xhatm[i] = add(add(dot(k + kA + i * kRow, xh, kNx),
                           dot(k + kB + i * kRow, u, kNu)),
                       dot(k + kBd + i * kRow, dhatm, nd));
    }
  }
  double* out = a.out + r * (2 * kNx + nd + kNx + kNu);
  for (int i = 0; i < kNx; ++i) out[i] = x[i];
  if (a.mode == kStep) return;
  // measure and measure_forward
  double e[kMaxOut], xhat[kNx], dhat[kMaxOut];
  for (int i = 0; i < ny; ++i) {
    const double* c = k + kC + i * kRow;
    e[i] = sub(sub(dot(c, x, kNx), dot(c, xhatm, kNx)),
               dot(k + kCd + i * kRow, dhatm, nd));
  }
  for (int i = 0; i < kNx; ++i)
    xhat[i] = add(xhatm[i], dot(k + kLx + i * kRow, e, ny));
  for (int i = 0; i < nd; ++i)
    dhat[i] = add(dhatm[i], dot(k + kLd + i * kRow, e, ny));
  // select_target
  double pack[kNr], cd[kMaxOut], ref[kNr];
  for (int i = 0; i < kNx; ++i) pack[i] = dot(k + kBd + i * kRow, dhat, nd);
  for (int i = 0; i < ny; ++i) cd[i] = dot(k + kCd + i * kRow, dhat, nd);
  for (int i = 0; i < kNu; ++i)
    pack[kNx + i] = sub(a.rsp[r * a.srsp + i], dot(k + kHr + i * kRow, cd, ny));
  for (int i = 0; i < kNr; ++i) ref[i] = dot(k + kGinv + i * kNr, pack, kNr);
  for (int i = 0; i < kNx; ++i) out[kNx + i] = xhat[i];
  for (int i = 0; i < nd; ++i) out[2 * kNx + i] = dhat[i];
  for (int i = 0; i < kNr; ++i) out[2 * kNx + nd + i] = ref[i];
}

}  // namespace

extern "C" {

// K13 over `rows` plant rows on `stream`: consts float64 [kWords]; x, u, p,
// xhat, dhat, rsp float64 rows of 3, 2, 1, 3, nd and 2 words at the row
// strides given (u and p unread in the observe-only mode 2, xhat, dhat and
// rsp in mode 0); out float64 [rows, 11 + nd] contiguous (mode 0 writes its
// first 3 words a row).  Returns the launch's CUDA error (0 on success);
// neither allocates nor synchronises.
int hectr_loop_stages(const void* consts, const void* x, const void* u,
                      const void* p, const void* xhat, const void* dhat,
                      const void* rsp, int64_t sx, int64_t su, int64_t sp,
                      int64_t sxhat, int64_t sdhat, int64_t srsp, void* out,
                      int64_t rows, int ny, int nd, int mode, void* stream) {
  if (rows < 1 || ny < 1 || ny > kMaxOut || nd < 0 || nd > kMaxOut ||
      mode < kStep || mode > kObserve)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  StageArgs a;
  a.consts = static_cast<const double*>(consts);
  a.x = static_cast<const double*>(x);
  a.u = static_cast<const double*>(u);
  a.p = static_cast<const double*>(p);
  a.xhat = static_cast<const double*>(xhat);
  a.dhat = static_cast<const double*>(dhat);
  a.rsp = static_cast<const double*>(rsp);
  a.sx = sx;
  a.su = su;
  a.sp = sp;
  a.sxhat = sxhat;
  a.sdhat = sdhat;
  a.srsp = srsp;
  a.out = static_cast<double*>(out);
  a.rows = rows;
  a.ny = ny;
  a.nd = nd;
  a.mode = mode;
  loop_stages_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* hectr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
