// Lazy modular arithmetic on 32-bit residues, shared by the kernels of
// this directory so that each issues the same primitive the same way.
//
// Values stay in [0, 2p) between operations; every modulus is below
// 2^30, so every sum below stays under 2^32.  The Shoup quotient
// __umulhi(a, w') with w' = floor(w * 2^32 / p) errs by at most one for
// any a < 2^32, so a product a * w lands in [0, 2p) with no correction.
// This is hectr_tpu/ckks/modmath.py::mul_mod_shoup_u32_lazy with the
// 16-bit-partial high product replaced by the hardware's.
//
// Below them, the int64 arithmetic of the plain PyTorch primitives
// (hectr_tpu_torch/ckks/modmath.py): words that wrap as PyTorch's int64 do,
// PyTorch's shift rule and Barrett's mul_mod, for the kernels that must
// agree with those primitives bit for bit on every input (rns_ops.cu,
// codec.cu).

#pragma once

#include <cstdint>

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

// int64 arithmetic that wraps as PyTorch's does (signed overflow is not
// defined in C++, unsigned wrap-around is).
__device__ __forceinline__ int64_t add64(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) +
                              static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t sub64(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) -
                              static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t mul64(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) *
                              static_cast<uint64_t>(b));
}
// PyTorch's right shift of int64: arithmetic, and a shift by 63 or more (or
// by a negative amount) shifts by 63.
__device__ __forceinline__ int64_t shr64(int64_t a, int64_t s) {
  return static_cast<uint64_t>(s) >= 63 ? a >> 63 : a >> s;
}
__device__ __forceinline__ int64_t correct(int64_t r, int64_t p) {
  return r >= p ? r - p : r;
}

// _barrett of ckks/modmath.py: q = ((x >> (k-2)) * mu) >> (k+2), r = x - q p,
// two corrections; mul_mod(a, b) is barrett(mul64(a, b), p, mu, k).
__device__ __forceinline__ int64_t barrett(int64_t x, int64_t p, int64_t mu,
                                           int64_t k) {
  const int64_t q = shr64(mul64(shr64(x, sub64(k, 2)), mu), add64(k, 2));
  return correct(correct(sub64(x, mul64(q, p)), p), p);
}
