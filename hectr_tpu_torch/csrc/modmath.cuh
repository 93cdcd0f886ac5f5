// Lazy modular arithmetic on 32-bit residues, shared by the kernels of
// this directory so that each issues the same primitive the same way.
//
// Values stay in [0, 2p) between operations; every modulus is below
// 2^30, so every sum below stays under 2^32.  The Shoup quotient
// __umulhi(a, w') with w' = floor(w * 2^32 / p) errs by at most one for
// any a < 2^32, so a product a * w lands in [0, 2p) with no correction.
// This is hectr_tpu/ckks/modmath.py::mul_mod_shoup_u32_lazy with the
// 16-bit-partial high product replaced by the hardware's.

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
