// Cross-shard stages of the coefficient-sharded negacyclic NTT for Hopper
// (sm_90a): K4 (forward, Cooley-Tukey) and K5 (inverse, Gentleman-Sande).
//
// The sharded transform (hectr_tpu_torch/parallel/ntt_shard.py) splits a
// ring of N into D chunks of C = N/D.  Its first log2 D forward stages (the
// last log2 D inverse ones) pair shard s with shard s ^ d, d = D/2 ... 1, and
// every pair shares one twiddle per limb, psi_rev[m + s / (2d)] (psi_inv_rev
// for the inverse) with m = D / (2d).  The JAX package runs these stages as
// XLA code inside shard_map (hectr_tpu/parallel/ntt_shard.py:117 fwd_local,
// :137 inv_local), which XLA fuses on a TPU; there is no Pallas kernel to
// replace.  They compute what the plain PyTorch cross_stages_plain and
// exchange_stage_plain of ntt_shard.py compute, bit for bit: every output is
// the unique residue in [0, p).
//
// Layout.  The port's contiguous int64 residue tensors; the kernels read the
// low 32 bits of each element (residues are < p < 2^30) and write each
// output zero-extended.  Twiddles, Shoup companions and primes are the
// ring's own [L, N] / [L] tables of 32-bit patterns (ckks/ntt.py
// NTTTables.psi_rev32, ...), row r of a tensor being limb r % L.
//
// Two forms of each kernel.
//
//   Local form (every shard in one tensor, [rows, D, C]: the local mesh, so
//   every ring above one K1 row on one card).  One thread owns two
//   neighbouring columns of one row and holds their D residues each (one a
//   shard, stride C) in registers, runs all log2 D radix-2 stages on them in
//   place with lazy [0, 2p) butterflies, and writes canonical residues.  So
//   one launch does every cross-shard stage, and its device traffic is one
//   16-byte load and one 16-byte store per two elements, coalesced along
//   the columns.  The twiddles (D - 1 per limb) are read by every thread of
//   a row and stay in L1.
//
//   Received form (one shard per rank, [rows, 1, C]: a process mesh, one
//   stage per exchange).  After the partner's chunk has arrived, one launch
//   computes this shard's half of the butterfly with one multiply:
//     forward  u-shard  u + S v_recv        v-shard  u_recv - S v_own
//     inverse  u-shard  u + v_recv          v-shard  (u_recv - v_own) S
//   The received chunk is read as it travels: the int32 bit patterns of
//   the transport's wire tensor.
//
// What bounds them on this card: device memory.  The local form moves 16
// bytes per element for log2(D) / 2 lazy Shoup multiplies; at D = 8 that is
// 1.5 multiplies (4.5 IMADs) per 16 bytes against the card's 64 IMADs per
// SM per clock, some 30x below the SMs' multiply rate.  The received form
// moves 20 bytes (8 own, 4 received, 8 written) per element for at most
// one multiply.
// bench.exchange_bound counts both.

#include <cstdint>
#include <cuda_runtime.h>

#include "modmath.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLogShards = 3;    // D = 2 .. 8

__device__ __forceinline__ uint32_t reduce(uint32_t v, uint32_t p) {
  return v >= p ? v - p : v;
}

// The D residues of two neighbouring columns, a[] the first, b[] the
// second, run through every cross-shard stage.  Stage j (forward order)
// has distance d = D >> (j + 1) and m = 1 << j twiddle groups; the pair
// (s, s + d) with s in group g = s / (2d) uses twiddle m + g.
template <int LOGD, bool INVERSE>
__global__ void __launch_bounds__(kThreads) exchange_local_kernel(
    const int64_t* __restrict__ in, int64_t* __restrict__ out,
    const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_shoup,
    const uint32_t* __restrict__ primes, int64_t threads_total, int L,
    int log_chunk) {
  constexpr int D = 1 << LOGD;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= threads_total) return;
  const int64_t chunk = int64_t(1) << log_chunk;
  const int64_t row = i >> (log_chunk - 1);
  const int64_t col = (i & ((chunk >> 1) - 1)) << 1;
  const int limb = static_cast<int>(row % L);
  const int64_t n = chunk << LOGD;
  const uint32_t p = primes[limb];
  const uint32_t p2 = 2 * p;
  const uint32_t* w = psi + limb * n;
  const uint32_t* ws = psi_shoup + limb * n;
  const int64_t base = row * n + col;

  uint32_t a[D], b[D];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    const longlong2 v =
        *reinterpret_cast<const longlong2*>(in + base + s * chunk);
    a[s] = static_cast<uint32_t>(v.x);
    b[s] = static_cast<uint32_t>(v.y);
  }
#pragma unroll
  for (int k = 0; k < LOGD; ++k) {
    const int j = INVERSE ? LOGD - 1 - k : k;
    const int m = 1 << j;
    const int d = D >> (j + 1);
#pragma unroll
    for (int g = 0; g < m; ++g) {
      const uint32_t S = __ldg(w + m + g);
      const uint32_t Ssh = __ldg(ws + m + g);
#pragma unroll
      for (int q = 0; q < d; ++q) {
        const int s = 2 * d * g + q;
        if (!INVERSE) {
          const uint32_t ta = mul_shoup_lazy(a[s + d], S, Ssh, p);
          const uint32_t tb = mul_shoup_lazy(b[s + d], S, Ssh, p);
          a[s + d] = sub_lazy(a[s], ta, p2);
          b[s + d] = sub_lazy(b[s], tb, p2);
          a[s] = add_lazy(a[s], ta, p2);
          b[s] = add_lazy(b[s], tb, p2);
        } else {
          const uint32_t da = sub_lazy(a[s], a[s + d], p2);
          const uint32_t db = sub_lazy(b[s], b[s + d], p2);
          a[s] = add_lazy(a[s], a[s + d], p2);
          b[s] = add_lazy(b[s], b[s + d], p2);
          a[s + d] = mul_shoup_lazy(da, S, Ssh, p);
          b[s + d] = mul_shoup_lazy(db, S, Ssh, p);
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < D; ++s) {
    longlong2 v;
    v.x = static_cast<int64_t>(reduce(a[s], p));
    v.y = static_cast<int64_t>(reduce(b[s], p));
    *reinterpret_cast<longlong2*>(out + base + s * chunk) = v;
  }
}

// One stage of one shard against its partner's chunk: own [rows, C] of
// int64, recv [rows, C] of int32 wire words; the stage's twiddle is entry
// `index` of each limb's table.
template <bool INVERSE>
__global__ void __launch_bounds__(kThreads) exchange_recv_kernel(
    const int64_t* __restrict__ own, const int32_t* __restrict__ recv,
    int64_t* __restrict__ out, const uint32_t* __restrict__ psi,
    const uint32_t* __restrict__ psi_shoup,
    const uint32_t* __restrict__ primes, int64_t threads_total, int L,
    int log_chunk, int64_t n, int64_t index, int is_u) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= threads_total) return;
  const int64_t row = i >> (log_chunk - 1);
  const int limb = static_cast<int>(row % L);
  const int64_t at = 2 * i;            // [rows, C] is contiguous
  const uint32_t p = primes[limb];
  const uint32_t p2 = 2 * p;
  const uint32_t S = __ldg(psi + limb * n + index);
  const uint32_t Ssh = __ldg(psi_shoup + limb * n + index);

  const longlong2 o = *reinterpret_cast<const longlong2*>(own + at);
  uint32_t x[2] = {static_cast<uint32_t>(o.x), static_cast<uint32_t>(o.y)};
  const int2 w2 = *reinterpret_cast<const int2*>(recv + at);
  const uint32_t r[2] = {static_cast<uint32_t>(w2.x),
                         static_cast<uint32_t>(w2.y)};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    uint32_t v;
    if (!INVERSE) {
      v = is_u ? add_lazy(x[k], mul_shoup_lazy(r[k], S, Ssh, p), p2)
               : sub_lazy(r[k], mul_shoup_lazy(x[k], S, Ssh, p), p2);
    } else {
      v = is_u ? add_lazy(x[k], r[k], p2)
               : mul_shoup_lazy(sub_lazy(r[k], x[k], p2), S, Ssh, p);
    }
    x[k] = reduce(v, p);
  }
  longlong2 res;
  res.x = static_cast<int64_t>(x[0]);
  res.y = static_cast<int64_t>(x[1]);
  *reinterpret_cast<longlong2*>(out + at) = res;
}

// Blocks for one thread per two elements, or 0 if the grid is too large.
unsigned blocks_for(int64_t threads_total) {
  const int64_t blocks = (threads_total + kThreads - 1) / kThreads;
  return blocks > 0x7fffffff ? 0u : static_cast<unsigned>(blocks);
}

template <int LOGD, bool INVERSE>
cudaError_t launch_local(const void* in, void* out, const void* psi,
                         const void* psi_shoup, const void* primes,
                         int64_t rows, int L, int log_chunk, void* stream) {
  const int64_t threads_total = (rows << log_chunk) / 2;
  const unsigned blocks = blocks_for(threads_total);
  if (blocks == 0) return cudaErrorInvalidValue;
  exchange_local_kernel<LOGD, INVERSE>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
          static_cast<const uint32_t*>(psi),
          static_cast<const uint32_t*>(psi_shoup),
          static_cast<const uint32_t*>(primes), threads_total, L, log_chunk);
  return cudaGetLastError();
}

template <bool INVERSE>
cudaError_t launch_local_d(int logd, const void* in, void* out,
                           const void* psi, const void* psi_shoup,
                           const void* primes, int64_t rows, int L,
                           int log_chunk, void* stream) {
  switch (logd) {
    case 1: return launch_local<1, INVERSE>(in, out, psi, psi_shoup, primes,
                                            rows, L, log_chunk, stream);
    case 2: return launch_local<2, INVERSE>(in, out, psi, psi_shoup, primes,
                                            rows, L, log_chunk, stream);
    case 3: return launch_local<3, INVERSE>(in, out, psi, psi_shoup, primes,
                                            rows, L, log_chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool INVERSE>
cudaError_t launch_recv(const void* own, const void* recv, void* out,
                        const void* psi, const void* psi_shoup,
                        const void* primes, int64_t rows, int L,
                        int log_chunk, int64_t n, int64_t index, int is_u,
                        void* stream) {
  const int64_t threads_total = (rows << log_chunk) / 2;
  const unsigned blocks = blocks_for(threads_total);
  if (blocks == 0) return cudaErrorInvalidValue;
  exchange_recv_kernel<INVERSE>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int64_t*>(own), static_cast<const int32_t*>(recv),
          static_cast<int64_t*>(out), static_cast<const uint32_t*>(psi),
          static_cast<const uint32_t*>(psi_shoup),
          static_cast<const uint32_t*>(primes), threads_total, L, log_chunk,
          n, index, is_u);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the launch's CUDA error
// (0 on success); it neither allocates nor synchronises.

// Local form: all log2 D stages over `in` [rows, D, C], D = 2^logd,
// C = 2^log_chunk; rows = batch * L.
int hectr_exchange_local(const void* in, void* out, const void* psi,
                         const void* psi_shoup, const void* primes,
                         int64_t rows, int L, int logd, int log_chunk,
                         int inverse, void* stream) {
  if (rows < 1 || L < 1 || rows % L != 0 || logd < 1 ||
      logd > kMaxLogShards || log_chunk < 1 || log_chunk + logd > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      inverse ? launch_local_d<true>(logd, in, out, psi, psi_shoup, primes,
                                     rows, L, log_chunk, stream)
              : launch_local_d<false>(logd, in, out, psi, psi_shoup, primes,
                                      rows, L, log_chunk, stream));
}

// Received form: one stage of one shard, own [rows, C] of int64 and recv
// [rows, C] of int32 wire words, twiddle entry `index` of a ring of n,
// this shard the u-half of its pairs if is_u.
int hectr_exchange_recv(const void* own, const void* recv, void* out,
                        const void* psi, const void* psi_shoup,
                        const void* primes, int64_t rows, int L,
                        int log_chunk, int64_t n, int64_t index, int is_u,
                        int inverse, void* stream) {
  if (rows < 1 || L < 1 || rows % L != 0 || log_chunk < 1 ||
      (int64_t(1) << log_chunk) >= n || index < 1 || index >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      inverse ? launch_recv<true>(own, recv, out, psi, psi_shoup, primes,
                                  rows, L, log_chunk, n, index, is_u, stream)
              : launch_recv<false>(own, recv, out, psi, psi_shoup, primes,
                                   rows, L, log_chunk, n, index, is_u,
                                   stream));
}

const char* hectr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
