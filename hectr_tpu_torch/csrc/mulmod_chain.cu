// Modular-multiply ceiling probe for Hopper (sm_90a): every element goes
// through r dependent lazy Shoup multiplies by its lane's constant.
//
// Replaces the TPU kernel scripts/bench_vpu_ceiling.py::main.kernel (K3):
// a VMEM-resident [512, 128] uint32 block per grid step, chained through
// R_CHAIN mul_mod_shoup_u32_lazy calls in a fori_loop.  It computes what
// the plain PyTorch chain in hectr_tpu_torch/bench/vpu_ceiling.py
// computes, bit for bit: the lazy result lies in [0, 2p) and is fixed by
// the exact high product, which __umulhi gives and the plain version
// takes from int64.
//
// Layout.  Input and output are the port's contiguous int64 [rows, lanes]
// residue tensors; the kernel reads the low 32 bits of each element
// (inputs below 2^31, e.g. in [0, 2p)) and writes the lazy result
// zero-extended.  w, w' and p are [lanes] tables of 32-bit patterns.
//
// Design.  One thread per element, its chain in a register: there is no
// data movement inside the loop, so the loop body is the multiply
// primitive of modmath.cuh (one IMAD.HI for the quotient, two 32-bit
// multiply-adds for a*w - q*p) plus loop control amortised over the
// unrolled body.  What bounds it on this card is the integer
// multiply-add issue rate of the SMs; the 8 bytes read and written per
// element are spent once per r multiplies.  Independent elements of
// neighbouring threads hide each chain's latency.

#include <cstdint>
#include <cuda_runtime.h>

#include "modmath.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void mulmod_chain_kernel(const int64_t* __restrict__ in,
                                    int64_t* __restrict__ out,
                                    const uint32_t* __restrict__ w,
                                    const uint32_t* __restrict__ w_shoup,
                                    const uint32_t* __restrict__ primes,
                                    int64_t n, int lanes, int r) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int lane = static_cast<int>(i % lanes);
  const uint32_t wl = w[lane];
  const uint32_t wsh = w_shoup[lane];
  const uint32_t p = primes[lane];
  uint32_t x = static_cast<uint32_t>(in[i]);
#pragma unroll 8
  for (int j = 0; j < r; ++j) x = mul_shoup_lazy(x, wl, wsh, p);
  out[i] = static_cast<int64_t>(x);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// neither allocates nor synchronises.
int hectr_mulmod_chain(const void* in, void* out, const void* w,
                       const void* w_shoup, const void* primes, int64_t n,
                       int lanes, int r, void* stream) {
  if (n < 1 || lanes < 1 || r < 0 || n % lanes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  mulmod_chain_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(w_shoup),
      static_cast<const uint32_t*>(primes), n, lanes, r);
  return static_cast<int>(cudaGetLastError());
}

const char* hectr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
