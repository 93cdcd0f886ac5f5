// Negacyclic NTT / inverse NTT for Hopper (sm_90a), one CTA per row.
//
// Replaces the TPU kernels hectr_tpu/ops/ntt_pallas.py::_fwd_kernel
// (K1, forward, natural -> bit-reversed order, Cooley-Tukey with
// merged-psi twiddles) and ::_inv_kernel (K2, inverse, bit-reversed ->
// natural, Gentleman-Sande over psi^-1 powers, times N^-1).  They compute
// what the plain PyTorch ntt_plain / intt_plain in
// hectr_tpu_torch/ckks/ntt.py compute, bit for bit; the TPU kernels'
// rank-1 twiddle factorisation and roll+mask stage form are Mosaic
// workarounds and are not carried over.
//
// Layout.  Input and output are the port's contiguous int64 [rows, N]
// residue tensors (rows = batch * L, limb = row % L).  The kernel reads
// the low 32 bits of each input element (residues are < p < 2^30) and
// writes each output residue zero-extended to 64 bits.  Twiddles and
// their Shoup companions are per-limb [L, N] tables of 32-bit patterns,
// read from global memory, so a chain may mix primes row by row.
//
// Design.  The whole row lives in dynamic shared memory as uint32
// (16 KB at N = 2^12, 128 KB at N = 2^15, above the 48 KB default and
// so opted into with cudaFuncSetAttribute), and all log2 N stages run in
// the block with a __syncthreads() between stages.  Values stay lazy in
// [0, 2p) between stages (p < 2^30 keeps every sum below 2^32); the
// Shoup quotient is __umulhi(a, w'), whose error is at most one for any
// a < 2^32, so a product lands in [0, 2p) with no correction.  One final
// normalisation brings the row to [0, p).
//
// What bounds it on this card: per row N log2 N / 2 butterflies, each
// one Shoup multiply (three 32-bit multiplies) and two adds, against
// 2 * N * 8 bytes of device traffic for the row itself plus the twiddle
// reads.  The design leaves for later: multi-row CTAs, register-resident
// stages, fusing the limb loop of the callers, TMA loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLogN = 15;

__device__ __forceinline__ uint32_t mul_shoup_lazy(uint32_t a, uint32_t w,
                                                   uint32_t w_shoup,
                                                   uint32_t p) {
  const uint32_t q = __umulhi(a, w_shoup);
  return a * w - q * p;  // wrapping; the true value lies in [0, 2p)
}

__device__ __forceinline__ uint32_t add_lazy(uint32_t a, uint32_t b,
                                             uint32_t p2) {
  const uint32_t s = a + b;  // < 4p < 2^32
  return s >= p2 ? s - p2 : s;
}

__device__ __forceinline__ uint32_t sub_lazy(uint32_t a, uint32_t b,
                                             uint32_t p2) {
  const uint32_t d = a + p2 - b;  // in (0, 4p)
  return d >= p2 ? d - p2 : d;
}

__global__ void ntt_fwd_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ out,
                               const uint32_t* __restrict__ psi,
                               const uint32_t* __restrict__ psi_shoup,
                               const uint32_t* __restrict__ primes, int L,
                               int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int nh = n >> 1;
  const int limb = blockIdx.x % L;
  const uint32_t p = primes[limb];
  const uint32_t p2 = p + p;
  const int64_t* x = in + static_cast<size_t>(blockIdx.x) * n;
  const uint32_t* w = psi + static_cast<size_t>(limb) * n;
  const uint32_t* wsh = psi_shoup + static_cast<size_t>(limb) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = static_cast<uint32_t>(x[i]);
  __syncthreads();

  // stage with m groups of 2 * half elements; half = 2^lh
  for (int m = 1, lh = logn - 1; m < n; m <<= 1, --lh) {
    for (int b = threadIdx.x; b < nh; b += blockDim.x) {
      const int g = b >> lh;
      const int iu = (g << (lh + 1)) + (b & ((1 << lh) - 1));
      const int iv = iu + (1 << lh);
      const uint32_t t = mul_shoup_lazy(s[iv], w[m + g], wsh[m + g], p);
      const uint32_t u = s[iu];
      s[iu] = add_lazy(u, t, p2);
      s[iv] = sub_lazy(u, t, p2);
    }
    __syncthreads();
  }

  int64_t* y = out + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t v = s[i];
    y[i] = static_cast<int64_t>(v >= p ? v - p : v);
  }
}

__global__ void ntt_inv_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ out,
                               const uint32_t* __restrict__ psi_inv,
                               const uint32_t* __restrict__ psi_inv_shoup,
                               const uint32_t* __restrict__ primes,
                               const uint32_t* __restrict__ n_inv,
                               const uint32_t* __restrict__ n_inv_shoup,
                               int L, int logn) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int nh = n >> 1;
  const int limb = blockIdx.x % L;
  const uint32_t p = primes[limb];
  const uint32_t p2 = p + p;
  const int64_t* x = in + static_cast<size_t>(blockIdx.x) * n;
  const uint32_t* w = psi_inv + static_cast<size_t>(limb) * n;
  const uint32_t* wsh = psi_inv_shoup + static_cast<size_t>(limb) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = static_cast<uint32_t>(x[i]);
  __syncthreads();

  // stage with h = n / (2 * half) groups; half = 2^lh
  for (int lh = 0; lh < logn; ++lh) {
    const int h = n >> (lh + 1);
    for (int b = threadIdx.x; b < nh; b += blockDim.x) {
      const int g = b >> lh;
      const int iu = (g << (lh + 1)) + (b & ((1 << lh) - 1));
      const int iv = iu + (1 << lh);
      const uint32_t u = s[iu];
      const uint32_t v = s[iv];
      s[iu] = add_lazy(u, v, p2);
      s[iv] = mul_shoup_lazy(u + p2 - v, w[h + g], wsh[h + g], p);
    }
    __syncthreads();
  }

  const uint32_t ni = n_inv[limb];
  const uint32_t ni_sh = n_inv_shoup[limb];
  int64_t* y = out + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t v = mul_shoup_lazy(s[i], ni, ni_sh, p);
    y[i] = static_cast<int64_t>(v >= p ? v - p : v);
  }
}

int threads_for(int logn) {
  const int half = 1 << (logn - 1);
  return half < 32 ? 32 : (half > 1024 ? 1024 : half);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success); it neither allocates nor synchronises.
int hectr_ntt_fwd(const void* in, void* out, const void* psi,
                  const void* psi_shoup, const void* primes, int rows, int L,
                  int logn, void* stream) {
  if (logn < 1 || logn > kMaxLogN || rows < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) << logn;
  cudaError_t err = allow_smem(ntt_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_fwd_kernel<<<rows, threads_for(logn), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(psi),
      static_cast<const uint32_t*>(psi_shoup),
      static_cast<const uint32_t*>(primes), L, logn);
  return static_cast<int>(cudaGetLastError());
}

int hectr_ntt_inv(const void* in, void* out, const void* psi_inv,
                  const void* psi_inv_shoup, const void* primes,
                  const void* n_inv, const void* n_inv_shoup, int rows, int L,
                  int logn, void* stream) {
  if (logn < 1 || logn > kMaxLogN || rows < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) << logn;
  cudaError_t err = allow_smem(ntt_inv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_inv_kernel<<<rows, threads_for(logn), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(psi_inv),
      static_cast<const uint32_t*>(psi_inv_shoup),
      static_cast<const uint32_t*>(primes),
      static_cast<const uint32_t*>(n_inv),
      static_cast<const uint32_t*>(n_inv_shoup), L, logn);
  return static_cast<int>(cudaGetLastError());
}

const char* hectr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
