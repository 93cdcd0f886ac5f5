// Public-key encryption's arithmetic for Hopper (sm_90a): K14, every
// ciphertext row of a batch in one launch.
//
// In the JAX package encryption is XLA code that jax.jit fuses on a TPU
// (hectr_tpu/ckks/scheme.py encrypt): the three draws' floor-mod into
// residues, their forward NTTs (through the Pallas K1) and the combination
// with the public key.  The port's composition of the same
// (ckks/scheme.py encrypt_composed, the plain version on the CPU) is ten
// launches on the card: three torch.remainder, three K1, three K9 and a
// stack, and about 7.5 times the bytes the result needs through device
// memory.
//
// What it computes.  For each batch row b and limb j (prime p): the draws
// v, e0, e1 (signed int64 [*batch, N]) floor-modded into [0, p), the
// words torch.remainder gives for every int64; their forward negacyclic
// NTTs, K1's words in K1's order (both end in the unique residue in
// [0, p)); then c0 = add_mod(mul_add_mod(v^, pk0, e0^), m) and
// c1 = mul_add_mod(v^, pk1, e1^) by the plain primitives' own arithmetic
// (modmath.cuh barrett, PyTorch's wrapping int64), so the words equal the
// composition's for every public key and plaintext; written into the
// halves of the [*batch, 2, k, N] output.
//
// Design.  A row (b, j) is held by a cluster of three groups of 2^logc
// CTAs, one group a draw, each group a K1 row: the same plan of
// register-resident passes, swizzled exchange and split over 2^logc CTAs,
// through the passes of ntt_passes.cuh, from K1's geometry at the fewest
// CTAs that keep a slice within 64 KB (logc = 1 at 2^15, else 0;
// ops/encrypt_cuda.py::geometry).  Each group floor-mods its draw as it
// loads it and transforms it into its shared memory; after a cluster
// barrier the three CTAs that hold one slice of the three transforms
// each write a third of both ciphertext halves over that slice, reading the
// transforms from each other's shared memory (distributed shared memory)
// and the key's and the plaintext's words 16 bytes at a time; a last
// cluster barrier keeps every slice alive until its peers have read it.
// So the three transforms run side by side (at one ciphertext the launch
// takes about one transform's latency, not three), each CTA holds K1's
// state and no more, each draw word is read from device memory once a
// limb, each plaintext word once, each ciphertext word is written once, and
// no residue, transform or c0/c1 pair leaves the chip.  The k limbs of a
// batch row are neighbouring clusters, so a draw read by the first of them
// is in L2 for the others.
//
// What bounds it on this card: device memory, as K1.  A row moves the
// draws once (24 N bytes a batch row), the plaintext row (8 N) and the two
// ciphertext rows (16 N); the tables and the key's rows stay in L2.
// bench.encrypt_work counts bytes and multiplies; at N = 2^13 a batch row
// of four limbs is 983,040 bytes against 704,512 lazy multiplies (3 x 4
// NTTs and the key products), so bytes bind by about 2.3 times.  What
// holds it above that bound is each CTA's chain of phases (loads, passes,
// barriers, combine) at two CTAs an SM, and the first pass's 64-bit draw
// words, which hold twice the registers of K1's loads in flight.

#include "ntt_passes.cuh"

namespace {

constexpr int kDraws = 3;   // v, e0, e1: one group of CTAs each

// torch.remainder(x, p) for int64 x and 2 < p < 2^30: the floor-mod, in
// [0, p), with no branch, so that a pass's loads all issue before the
// first of them is used.  Barrett on the word's 64 bits u as unsigned:
// q = umulhi(u, m) for m = floor((2^64 - 1) / p) lies within two of
// floor(u / p), so u - q p is in [0, 3p), below 2^32; a negative word is
// u - 2^64, so R = 2^64 mod p comes off it.
struct FloorMod {
  uint32_t p;
  uint32_t R;               // 2^64 mod p
  uint64_t m;               // floor((2^64 - 1) / p)
  __device__ explicit FloorMod(uint32_t p_) : p(p_), m(~0ull / p_) {
    const uint32_t top = static_cast<uint32_t>(~0ull - m * p_);  // (2^64-1) mod p
    R = top + 1 == p_ ? 0 : top + 1;
  }
  __device__ __forceinline__ uint32_t operator()(int64_t x) const {
    const uint64_t u = static_cast<uint64_t>(x);
    uint32_t r = static_cast<uint32_t>(u) -
                 static_cast<uint32_t>(__umul64hi(u, m)) * p;
    r = r >= p ? r - p : r;
    r = r >= p ? r - p : r;
    if (x < 0) r = r >= R ? r - R : r + (p - R);
    return r;
  }
};

// modmath.py add_mod_plain: s = a + b, s - p where s >= p
__device__ __forceinline__ int64_t add_mod(int64_t a, int64_t b, int64_t p) {
  const int64_t s = add64(a, b);
  return s >= p ? sub64(s, p) : s;
}

// Both ciphertext halves over pairs [lo, hi) of this CTA's slice:
// c0 = add_mod(mul_add_mod(v^, pk0, e0^), m), c1 = mul_add_mod(v^, pk1,
// e1^), v^, e0^, e1^ the lazy slices s[0..2] (this CTA's and its peers').
// pk0, pk1, m, y0, y1 point at the slice's first word.
__device__ __forceinline__ void combine(
    const uint32_t* const (&s)[kDraws], const int64_t* __restrict__ pk0,
    const int64_t* __restrict__ pk1, const int64_t* __restrict__ m,
    int64_t* __restrict__ y0, int64_t* __restrict__ y1, int lo, int hi,
    uint32_t p, int64_t mu, int64_t kb) {
#pragma unroll 2
  for (int q = lo + threadIdx.x; q < hi; q += blockDim.x) {
    const longlong2 w0 = __ldg(reinterpret_cast<const longlong2*>(pk0 + 2 * q));
    const longlong2 w1 = __ldg(reinterpret_cast<const longlong2*>(pk1 + 2 * q));
    const longlong2 mm = __ldg(reinterpret_cast<const longlong2*>(m + 2 * q));
    const int64_t k0[2] = {w0.x, w0.y}, k1[2] = {w1.x, w1.y};
    const int64_t ms[2] = {mm.x, mm.y};
    int64_t c0[2], c1[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int at = swz(2 * q + u);
      const int64_t v = reduce(s[0][at], p);
      const int64_t a = reduce(s[1][at], p);
      const int64_t b = reduce(s[2][at], p);
      c0[u] = add_mod(add_mod(barrett(mul64(v, k0[u]), p, mu, kb), a, p),
                      ms[u], p);
      c1[u] = add_mod(barrett(mul64(v, k1[u]), p, mu, kb), b, p);
    }
    *reinterpret_cast<longlong2*>(y0 + 2 * q) = make_longlong2(c0[0], c0[1]);
    *reinterpret_cast<longlong2*>(y1 + 2 * q) = make_longlong2(c1[0], c1[1]);
  }
}

// A cluster of 3 x 2^logc CTAs a row (b, j), row = b L + j: cluster rank
// d 2^logc + k is draw d's CTA k.  v, e0, e1: the draws [B, N]; m: the
// plaintext [B, L, N]; pk: the key [2, pk_rows, N] (its first L rows a
// half are used); out: [B, 2, L, N]; mu, kb: Barrett's per-limb constants
// [L].  V0 as ntt_fwd_kernel's.
template <int V0>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    encrypt_kernel(const int64_t* __restrict__ v,
                   const int64_t* __restrict__ e0,
                   const int64_t* __restrict__ e1,
                   const int64_t* __restrict__ m,
                   const int64_t* __restrict__ pk, int64_t* __restrict__ out,
                   const uint32_t* __restrict__ psi,
                   const uint32_t* __restrict__ psi_shoup,
                   const uint32_t* __restrict__ primes,
                   const int64_t* __restrict__ mu,
                   const int64_t* __restrict__ kb, int L, int pk_rows,
                   int logn, int logc, int plan) {
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int crank = static_cast<int>(cluster.block_rank());
  const int draw = crank >> logc;
  const int rank = crank & ((1 << logc) - 1);
  const int row = blockIdx.x / (kDraws << logc);
  const Row r = row_of(primes, psi, psi_shoup, row, L, logn, logc, rank,
                       draw << logc);
  const int b = row / L;
  const int64_t* x = draw == 0 ? v : draw == 1 ? e0 : e1;
  // the first pass waits for the barrier above: every peer has started
  forward<V0>(x + (static_cast<size_t>(b) << logn), s, r, plan,
              FloorMod(r.p), false);
  cluster.sync();           // every draw transformed

  // the three CTAs of rank `rank` share its slice's pairs, a third each
  const int j = row - b * L;
  const int slice_log = logn - logc;
  const int pairs = 1 << (slice_log - 1);
  const uint32_t* peers[kDraws];
#pragma unroll
  for (int d = 0; d < kDraws; ++d)
    peers[d] = d == draw ? s : cluster.map_shared_rank(s, (d << logc) + rank);
  const size_t slice = static_cast<size_t>(rank) << slice_log;
  const size_t c0 = (static_cast<size_t>(row + b * L) << logn) + slice;
  combine(peers, pk + (static_cast<size_t>(j) << logn) + slice,
          pk + (static_cast<size_t>(pk_rows + j) << logn) + slice,
          m + (static_cast<size_t>(row) << logn) + slice, out + c0,
          out + c0 + (static_cast<size_t>(L) << logn), draw * pairs / kDraws,
          (draw + 1) * pairs / kDraws, r.p, mu[j], kb[j]);
  cluster.sync();           // every slice stays until its peers have read it
}

}  // namespace

extern "C" {

// K14 over rows = B L rows of 2^logn (B batch rows of L limbs) on
// `stream`, a cluster of 3 x 2^logc CTAs a row; `logc`, `threads` and
// `plan` from ops/encrypt_cuda.py::geometry (logn).  Returns the launch's
// CUDA error (0 on success); it neither allocates nor synchronises.
int hectr_encrypt(const void* v, const void* e0, const void* e1,
                  const void* m, const void* pk, void* out, const void* psi,
                  const void* psi_shoup, const void* primes, const void* mu,
                  const void* kb, int rows, int L, int pk_rows, int logn,
                  int logc, int threads, int plan, void* stream) {
  const int cluster = kDraws << logc;
  if (!valid(rows, L, logn, logc, threads, plan) || rows % L != 0 ||
      pk_rows < L || cluster > 8 || rows > 0x7fffffff / cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      first_columns(logn, plan) == 2 ? encrypt_kernel<2> : encrypt_kernel<1>,
      rows, cluster, threads, sizeof(uint32_t) << (logn - logc), stream,
      static_cast<const int64_t*>(v), static_cast<const int64_t*>(e0),
      static_cast<const int64_t*>(e1), static_cast<const int64_t*>(m),
      static_cast<const int64_t*>(pk), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(psi),
      static_cast<const uint32_t*>(psi_shoup),
      static_cast<const uint32_t*>(primes), static_cast<const int64_t*>(mu),
      static_cast<const int64_t*>(kb), L, pk_rows, logn, logc, plan));
}

const char* hectr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
