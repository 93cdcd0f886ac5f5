// Negacyclic NTT / inverse NTT for Hopper (sm_90a): register-resident
// radix passes, one row spread over a thread-block cluster.
//
// Replaces the TPU kernels hectr_tpu/ops/ntt_pallas.py::_fwd_kernel
// (K1, forward, natural -> bit-reversed order, Cooley-Tukey with
// merged-psi twiddles) and ::_inv_kernel (K2, inverse, bit-reversed ->
// natural, Gentleman-Sande over psi^-1 powers, times N^-1).  They compute
// what the plain PyTorch ntt_plain / intt_plain in
// hectr_tpu_torch/ckks/ntt.py compute, bit for bit: every output is the
// unique residue in [0, p), so any schedule of the same butterflies gives
// the same words.  The TPU kernels' rank-1 twiddle factorisation and
// roll+mask stage form are Mosaic workarounds and are not carried over.
//
// Layout.  Input and output are the port's contiguous int64 [rows, N]
// residue tensors (rows = batch * L, limb = row % L), read and written 16
// bytes (two residues) per thread access; the kernel reads the low 32 bits
// of each input element (residues are < p < 2^30) and writes each output
// zero-extended.  Twiddles and their Shoup companions are per-limb [L, N]
// tables of 32-bit patterns, so a chain may mix primes row by row.
//
// Design.  The log2 N stages are grouped into passes of r <= 5 stages,
// as few as the row needs, split evenly, widest first (15 -> 5, 5, 5;
// 14 -> 5, 5, 4; 12 -> 4, 4, 4: ops/ntt_cuda.py::pass_widths).  In a
// pass a thread holds the 2^r elements of the row that those stages
// combine (fixed high and low index bits, the pass's r bits varying),
// loads the 2^r - 1 twiddles and companions they need, and runs the r
// stages in registers with no barrier.  Between passes the row is
// exchanged through shared memory as uint32, swizzled (swz below) so that
// every pass's warp accesses hit 32 distinct banks.  At logN = 15 that is
// 3 passes and 2 exchanges instead of 15 barriers.
//
// A row is split over a cluster of C = 2^logc CTAs (cudaLaunchKernelEx
// with a cluster dimension), CTA k holding elements [k N/C, (k+1) N/C) in
// its shared memory.  The forward transform's first pass covers the top
// r0 >= logc index bits, so it is the only one that crosses CTAs: each
// thread loads its elements straight from device memory into registers,
// runs the pass, and stores each result into the shared memory of the CTA
// that owns it (distributed shared memory, cluster.map_shared_rank); one
// cluster barrier later every further pass is local to a CTA, and the CTA
// writes its slice out, 16 bytes a store.  The inverse runs the same plan
// backwards: each CTA reads its slice into shared memory (16-byte loads,
// kCopyChunks in flight a thread), runs the low passes locally, and after
// a cluster barrier the last pass gathers its elements from the cluster's
// shared memory, multiplies by N^-1, reduces to [0, p) and writes straight
// to device memory; a final cluster barrier keeps every CTA's shared
// memory alive until its peers have read it.  The crossing pass takes two
// columns a thread (16-byte device accesses) where it is at most 4 stages
// wide, and one (8-byte accesses, neighbouring threads on neighbouring
// addresses) where it is 5: two columns of 32 would hold 64 residues and
// their twiddles in registers and spill.
//
// The wrapper picks C and the threads from (rows, logN) alone
// (ops/ntt_cuda.py::geometry): C so that a launch has more CTAs than two
// for each SM (a launch of 4-44 rows at 2^15 gets 8 CTAs a row, the
// FLAGSHIP digit stack of 264 rows 2), at most 256 threads at <= 128
// registers (__launch_bounds__(256, 2)) and at most 64 KB of the row a
// CTA (so a 2^15 row always takes 2 CTAs or more, also for FLAGSHIP_QP's
// stacks of 364-544 rows), so that two CTAs share an SM and one's loads
// overlap the other's passes.  bench/ntt_kernels.py times every cluster
// size at every shape the encrypted loops give the kernels, beside the
// one the wrapper picks.
//
// Values stay lazy in [0, 2p) between stages (p < 2^30 keeps every sum
// below 2^32); the Shoup quotient is __umulhi(a, w'), whose error is at
// most one for any a < 2^32, so a product lands in [0, 2p) with no
// correction (modmath.cuh, shared with the multiply-ceiling probe
// mulmod_chain.cu, so that probe stays the denominator of the same
// instruction).
//
// What bounds it on this card: per row 2 * N * 8 bytes of device traffic
// (the row in and out; the tables, 8 N bytes per limb, are shared by the
// rows of a limb and stay in L2) against N log2 N / 2 butterflies, each
// one lazy Shoup multiply (three 32-bit IMADs) and two lazy adds.  At
// 3.35 TB/s and 64 IMADs per SM per clock the bytes bind, by about 4x at
// logN = 15.  The kernels reach about half that bound on the FLAGSHIP
// digit stack: a CTA's phases (load, pass, cluster barrier, two local
// passes, store) run one after another, and its partner on the SM is in
// the same phase more often than not.  Launches of a few rows are held
// by that chain's latency (about 9 us at 2^15), not by bytes.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "modmath.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLogN = 15;
constexpr int kMaxPassBits = 5;
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 2;       // two CTAs an SM: <= 128 registers
constexpr int kCopyChunks = 8;      // 16-byte loads in flight a thread
constexpr int kMaxLogCluster = 3;   // 8 CTAs: the portable cluster size

// The shared-memory word of element a of a CTA's slice: the low 5 bits
// (the bank) XORed with h = bits 5-9, and bits 2-3 of h once more into
// bank bits 3-4.  Whatever the pass's low index bit lo and width R, a
// warp's 32 words then lie in 32 banks (tests/test_torch_ntt_schedule.py
// checks every plan).
__device__ __forceinline__ int swz(int a) {
  const int h = (a >> 5) & 31;
  return a ^ h ^ ((h << 1) & 24);
}

__device__ __forceinline__ uint32_t reduce(uint32_t v, uint32_t p) {
  return v >= p ? v - p : v;
}

// the cluster barrier in two halves, so the first pass's loads overlap
// the wait for every peer CTA to have started
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// K consecutive twiddles, 16 bytes a load where K allows (the index of the
// first is a multiple of K, and each limb's table starts 16-byte aligned)
template <int K>
__device__ __forceinline__ void load_tw(uint32_t (&d)[K],
                                        const uint32_t* __restrict__ t) {
  if constexpr (K >= 4) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(t + i));
      d[i] = v.x;
      d[i + 1] = v.y;
      d[i + 2] = v.z;
      d[i + 3] = v.w;
    }
  } else if constexpr (K == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(t));
    d[0] = v.x;
    d[1] = v.y;
  } else {
    d[0] = __ldg(t);
  }
}

// The R stages of one Cooley-Tukey pass on V columns of 2^R elements.
// Element v of a column is row element (G << (lo + R)) | (v << lo) | l;
// with hb = logN - lo - R high bits and base = 2^hb + G, stage S of the
// pass (global stage hb + S) takes twiddle psi_rev[(base << S) + (v >>
// (R - S))] for the pair (v, v + 2^(R-1-S)).
template <int R, int V, int S = 0>
__device__ __forceinline__ void ct_stages(uint32_t (&x)[V][1 << R],
                                          const uint32_t* __restrict__ w,
                                          const uint32_t* __restrict__ wsh,
                                          int base, uint32_t p, uint32_t p2) {
  constexpr int K = 1 << S;
  constexpr int HALF = 1 << (R - 1 - S);
  uint32_t wv[K], ws[K];
  load_tw<K>(wv, w + (base << S));
  load_tw<K>(ws, wsh + (base << S));
#pragma unroll
  for (int g = 0; g < K; ++g) {
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int iu = g * 2 * HALF + j;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const uint32_t t = mul_shoup_lazy(x[c][iu + HALF], wv[g], ws[g], p);
        const uint32_t u = x[c][iu];
        x[c][iu] = add_lazy(u, t, p2);
        x[c][iu + HALF] = sub_lazy(u, t, p2);
      }
    }
  }
  if constexpr (S + 1 < R) ct_stages<R, V, S + 1>(x, w, wsh, base, p, p2);
}

// The R stages of one Gentleman-Sande pass, same element numbering:
// stage S (global stage lo + S) pairs (v, v + 2^S) and takes twiddle
// psi_inv_rev[(base << (R - 1 - S)) + (v >> (S + 1))].
template <int R, int V, int S = 0>
__device__ __forceinline__ void gs_stages(uint32_t (&x)[V][1 << R],
                                          const uint32_t* __restrict__ w,
                                          const uint32_t* __restrict__ wsh,
                                          int base, uint32_t p, uint32_t p2) {
  constexpr int K = 1 << (R - 1 - S);
  constexpr int HALF = 1 << S;
  uint32_t wv[K], ws[K];
  load_tw<K>(wv, w + (base << (R - 1 - S)));
  load_tw<K>(ws, wsh + (base << (R - 1 - S)));
#pragma unroll
  for (int g = 0; g < K; ++g) {
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int iu = g * 2 * HALF + j;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const uint32_t u = x[c][iu];
        const uint32_t v = x[c][iu + HALF];
        x[c][iu] = add_lazy(u, v, p2);
        x[c][iu + HALF] = mul_shoup_lazy(u + p2 - v, wv[g], ws[g], p);
      }
    }
  }
  if constexpr (S + 1 < R) gs_stages<R, V, S + 1>(x, w, wsh, base, p, p2);
}

struct Row {
  int logn;
  int logc;                 // the cluster holds 2^logc CTAs
  int rank;                 // this CTA's rank in it
  uint32_t p, p2;
  const uint32_t* w;        // this limb's twiddles and companions
  const uint32_t* wsh;
};

// Forward, first pass (the top R index bits, lo = logN - R): V columns
// per thread, read from device memory, results stored into the owning
// CTA's shared memory.  Column pairs are spread over the cluster.
template <int R, int V>
__device__ void fwd_first(const int64_t* __restrict__ x, uint32_t* s,
                          const Row& r) {
  constexpr int E = 1 << R;
  const int lo = r.logn - R;
  const int slice_log = r.logn - r.logc;
  const int mask = (1 << slice_log) - 1;
  const int per_cta = ((1 << lo) / V) >> r.logc;
  cg::cluster_group cluster = cg::this_cluster();
  bool waited = r.logc == 0;
  for (int q = threadIdx.x; q < per_cta; q += blockDim.x) {
    const int l = V * (r.rank * per_cta + q);
    uint32_t a[V][E];
#pragma unroll
    for (int v = 0; v < E; ++v) {
      const int64_t* src = x + (v << lo) + l;
      if constexpr (V == 2) {
        const longlong2 d = __ldg(reinterpret_cast<const longlong2*>(src));
        a[0][v] = static_cast<uint32_t>(d.x);
        a[1][v] = static_cast<uint32_t>(d.y);
      } else {
        a[0][v] = static_cast<uint32_t>(
            __ldg(reinterpret_cast<const long long*>(src)));
      }
    }
    ct_stages<R, V>(a, r.w, r.wsh, 1, r.p, r.p2);
    if (!waited) {          // every peer has started: its memory is live
      cluster_wait();
      waited = true;
    }
#pragma unroll
    for (int v = 0; v < E; ++v) {
      const int i = (v << lo) + l;
      const int owner = i >> slice_log;
      uint32_t* dst = owner == r.rank ? s : cluster.map_shared_rank(s, owner);
#pragma unroll
      for (int c = 0; c < V; ++c) dst[swz((i & mask) + c)] = a[c][v];
    }
  }
  if (!waited) cluster_wait();
}

// A pass local to this CTA's slice over index bits [lo, lo + R).
template <int R, bool Forward>
__device__ void local_pass(uint32_t* s, const Row& r, int lo) {
  constexpr int E = 1 << R;
  const int hb = r.logn - lo - R;
  const int items = 1 << (r.logn - r.logc - R);
  const int lmask = (1 << lo) - 1;
  const int gbase = (1 << hb) + (r.rank << (hb - r.logc));
  for (int q = threadIdx.x; q < items; q += blockDim.x) {
    const int at = ((q >> lo) << (lo + R)) | (q & lmask);
    uint32_t a[1][E];
#pragma unroll
    for (int v = 0; v < E; ++v) a[0][v] = s[swz(at + (v << lo))];
    if constexpr (Forward)
      ct_stages<R, 1>(a, r.w, r.wsh, gbase + (q >> lo), r.p, r.p2);
    else
      gs_stages<R, 1>(a, r.w, r.wsh, gbase + (q >> lo), r.p, r.p2);
#pragma unroll
    for (int v = 0; v < E; ++v) s[swz(at + (v << lo))] = a[0][v];
  }
}

// Inverse, last pass (the top R index bits): V columns per thread,
// gathered from the cluster's shared memory, times N^-1, reduced to
// [0, p) and written to device memory.
template <int R, int V>
__device__ void inv_last(int64_t* __restrict__ y, uint32_t* s, const Row& r,
                         uint32_t ni, uint32_t ni_sh) {
  constexpr int E = 1 << R;
  const int lo = r.logn - R;
  const int slice_log = r.logn - r.logc;
  const int mask = (1 << slice_log) - 1;
  const int per_cta = ((1 << lo) / V) >> r.logc;
  cg::cluster_group cluster = cg::this_cluster();
  for (int q = threadIdx.x; q < per_cta; q += blockDim.x) {
    const int l = V * (r.rank * per_cta + q);
    uint32_t a[V][E];
#pragma unroll
    for (int v = 0; v < E; ++v) {
      const int i = (v << lo) + l;
      const int owner = i >> slice_log;
      const uint32_t* src =
          owner == r.rank ? s : cluster.map_shared_rank(s, owner);
#pragma unroll
      for (int c = 0; c < V; ++c) a[c][v] = src[swz((i & mask) + c)];
    }
    gs_stages<R, V>(a, r.w, r.wsh, 1, r.p, r.p2);
#pragma unroll
    for (int v = 0; v < E; ++v) {
      int64_t* dst = y + (v << lo) + l;
      const uint32_t b0 = reduce(mul_shoup_lazy(a[0][v], ni, ni_sh, r.p), r.p);
      if constexpr (V == 2) {
        const uint32_t b1 =
            reduce(mul_shoup_lazy(a[1][v], ni, ni_sh, r.p), r.p);
        *reinterpret_cast<longlong2*>(dst) = make_longlong2(b0, b1);
      } else {
        *dst = b0;
      }
    }
  }
}

// A runtime pass width as a template argument: f(integral_constant<R>)
// for r = R in 1..RMax (the plan's widths are checked on the host).
template <int RMax, typename F>
__device__ __forceinline__ void by_width(int r, F f) {
  switch (r) {
    case 1: f(std::integral_constant<int, 1>()); break;
    case 2: if constexpr (RMax >= 2) f(std::integral_constant<int, 2>()); break;
    case 3: if constexpr (RMax >= 3) f(std::integral_constant<int, 3>()); break;
    case 4: if constexpr (RMax >= 4) f(std::integral_constant<int, 4>()); break;
    default: if constexpr (RMax >= 5) f(std::integral_constant<int, 5>());
  }
}

// the widest first pass of V0 columns a thread that stays in registers
template <int V0>
constexpr int kFirstPassBits = V0 == 2 ? 4 : kMaxPassBits;

__device__ __forceinline__ Row make_row(const uint32_t* primes,
                                        const uint32_t* w,
                                        const uint32_t* wsh, int L, int logn,
                                        int logc) {
  const int row = blockIdx.x >> logc;
  const int limb = row % L;
  const uint32_t p = primes[limb];
  const size_t off = static_cast<size_t>(limb) << logn;
  return Row{logn, logc, static_cast<int>(cg::this_cluster().block_rank()),
             p, p + p, w + off, wsh + off};
}

__device__ __forceinline__ void cluster_sync(int logc) {
  if (logc > 0)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// plan: pass widths, 4 bits each, first (top index bits) in bits 0-3;
// V0: columns a thread takes in the first pass (1 where it is the only)
template <int V0>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    ntt_fwd_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                   const uint32_t* __restrict__ psi,
                   const uint32_t* __restrict__ psi_shoup,
                   const uint32_t* __restrict__ primes, int L, int logn,
                   int logc, int plan) {
  extern __shared__ uint32_t s[];
  if (logc > 0) cluster_arrive_relaxed();
  const Row r = make_row(primes, psi, psi_shoup, L, logn, logc);
  const size_t row_off = static_cast<size_t>(blockIdx.x >> logc) << logn;
  const int64_t* x = in + row_off;
  const int r0 = plan & 15;
  if (logn > r0)
    by_width<kFirstPassBits<V0>>(
        r0, [&](auto R) { fwd_first<decltype(R)::value, V0>(x, s, r); });
  else
    by_width<kMaxPassBits>(
        r0, [&](auto R) { fwd_first<decltype(R)::value, 1>(x, s, r); });
  cluster_sync(logc);

  int lo = logn - r0;
  for (int j = 1; (plan >> (4 * j)) & 15; ++j) {
    const int rj = (plan >> (4 * j)) & 15;
    lo -= rj;
    by_width<kMaxPassBits>(
        rj, [&](auto R) { local_pass<decltype(R)::value, true>(s, r, lo); });
    __syncthreads();
  }

  const int slice_log = logn - logc;
  int64_t* y = out + row_off + (static_cast<size_t>(r.rank) << slice_log);
  for (int q = threadIdx.x; 2 * q < (1 << slice_log); q += blockDim.x) {
    const uint32_t b0 = reduce(s[swz(2 * q)], r.p);
    const uint32_t b1 = reduce(s[swz(2 * q + 1)], r.p);
    *reinterpret_cast<longlong2*>(y + 2 * q) = make_longlong2(b0, b1);
  }
}

template <int V0>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    ntt_inv_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                   const uint32_t* __restrict__ psi_inv,
                   const uint32_t* __restrict__ psi_inv_shoup,
                   const uint32_t* __restrict__ primes,
                   const uint32_t* __restrict__ n_inv,
                   const uint32_t* __restrict__ n_inv_shoup, int L, int logn,
                   int logc, int plan) {
  extern __shared__ uint32_t s[];
  const Row r = make_row(primes, psi_inv, psi_inv_shoup, L, logn, logc);
  const size_t row_off = static_cast<size_t>(blockIdx.x >> logc) << logn;
  const int slice_log = logn - logc;
  const int64_t* x = in + row_off + (static_cast<size_t>(r.rank) << slice_log);
  // kCopyChunks 16-byte loads in flight a thread before any is stored
  const int pairs = 1 << (slice_log - 1);
  for (int q0 = threadIdx.x; q0 < pairs; q0 += kCopyChunks * blockDim.x) {
    longlong2 d[kCopyChunks];
#pragma unroll
    for (int u = 0; u < kCopyChunks; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q < pairs)
        d[u] = __ldg(reinterpret_cast<const longlong2*>(x + 2 * q));
    }
#pragma unroll
    for (int u = 0; u < kCopyChunks; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q < pairs) {
        s[swz(2 * q)] = static_cast<uint32_t>(d[u].x);
        s[swz(2 * q + 1)] = static_cast<uint32_t>(d[u].y);
      }
    }
  }
  __syncthreads();

  int npass = 1;
  while ((plan >> (4 * npass)) & 15) ++npass;
  int lo = 0;
  for (int j = npass - 1; j >= 1; --j) {
    const int rj = (plan >> (4 * j)) & 15;
    by_width<kMaxPassBits>(
        rj, [&](auto R) { local_pass<decltype(R)::value, false>(s, r, lo); });
    lo += rj;
    __syncthreads();
  }
  cluster_sync(logc);

  const int limb = (blockIdx.x >> logc) % L;
  const uint32_t ni = n_inv[limb];
  const uint32_t ni_sh = n_inv_shoup[limb];
  int64_t* y = out + row_off;
  const int r0 = plan & 15;
  if (logn > r0)
    by_width<kFirstPassBits<V0>>(r0, [&](auto R) {
      inv_last<decltype(R)::value, V0>(y, s, r, ni, ni_sh);
    });
  else
    by_width<kMaxPassBits>(r0, [&](auto R) {
      inv_last<decltype(R)::value, 1>(y, s, r, ni, ni_sh);
    });
  if (logc > 0) cg::this_cluster().sync();   // peers may still read s
}

// The plan and geometry ops/ntt_cuda.py::geometry produces, checked.
bool valid(int rows, int L, int logn, int logc, int threads, int plan) {
  if (logn < 1 || logn > kMaxLogN || rows < 1 || L < 1 || logc < 0 ||
      logc > kMaxLogCluster || rows > (0x7fffffff >> logc) || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0)
    return false;
  int sum = 0, j = 0;
  for (; j < 8 && ((plan >> (4 * j)) & 15); ++j) {
    const int rj = (plan >> (4 * j)) & 15;
    if (rj > kMaxPassBits) return false;
    sum += rj;
  }
  if (sum != logn || (j < 8 && (plan >> (4 * j)) != 0)) return false;
  const int r0 = plan & 15;
  // the first pass covers the CTA bits, and every CTA gets column pairs
  return logc == 0 || (logc <= r0 && logn - r0 - 1 >= logc);
}

// The first (forward) / last (inverse) pass takes two columns a thread,
// for 16-byte device accesses, where the row has more than one pass and
// that pass is at most kFirstPassBits<2> wide; one column otherwise.
int first_columns(int logn, int plan) {
  const int r0 = plan & 15;
  return logn > r0 && r0 <= kFirstPassBits<2> ? 2 : 1;
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in.  Every
// launch above 48 KB sets it for itself and nothing sets it lower, so an
// occupancy query never takes away what a later launch needs.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int rows, int logn, int logc,
                   int threads, void* stream, Args... args) {
  const size_t smem = sizeof(uint32_t) << (logn - logc);
  const cudaError_t set = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (set != cudaSuccess) return set;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << logc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) << logc);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the launch's CUDA
// error (0 on success); it neither allocates nor synchronises.  `logc`,
// `threads` and `plan` come from ops/ntt_cuda.py::geometry.
int hectr_ntt_fwd(const void* in, void* out, const void* psi,
                  const void* psi_shoup, const void* primes, int rows, int L,
                  int logn, int logc, int threads, int plan, void* stream) {
  if (!valid(rows, L, logn, logc, threads, plan))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      first_columns(logn, plan) == 2 ? ntt_fwd_kernel<2> : ntt_fwd_kernel<1>,
      rows, logn, logc, threads, stream, static_cast<const int64_t*>(in),
      static_cast<int64_t*>(out), static_cast<const uint32_t*>(psi),
      static_cast<const uint32_t*>(psi_shoup),
      static_cast<const uint32_t*>(primes), L, logn, logc, plan));
}

int hectr_ntt_inv(const void* in, void* out, const void* psi_inv,
                  const void* psi_inv_shoup, const void* primes,
                  const void* n_inv, const void* n_inv_shoup, int rows, int L,
                  int logn, int logc, int threads, int plan, void* stream) {
  if (!valid(rows, L, logn, logc, threads, plan))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      first_columns(logn, plan) == 2 ? ntt_inv_kernel<2> : ntt_inv_kernel<1>,
      rows, logn, logc, threads, stream, static_cast<const int64_t*>(in),
      static_cast<int64_t*>(out), static_cast<const uint32_t*>(psi_inv),
      static_cast<const uint32_t*>(psi_inv_shoup),
      static_cast<const uint32_t*>(primes),
      static_cast<const uint32_t*>(n_inv),
      static_cast<const uint32_t*>(n_inv_shoup), L, logn, logc, plan));
}

// The most clusters of this geometry that the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0 means the launch cannot run), or a
// negated CUDA error.
int hectr_ntt_max_clusters(int forward, int logn, int logc, int threads,
                           int plan) {
  const size_t smem = sizeof(uint32_t) << (logn - logc);
  const bool two = first_columns(logn, plan) == 2;
  void* kernel =
      forward ? reinterpret_cast<void*>(two ? ntt_fwd_kernel<2>
                                            : ntt_fwd_kernel<1>)
              : reinterpret_cast<void*>(two ? ntt_inv_kernel<2>
                                            : ntt_inv_kernel<1>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << logc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1u << logc);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}

const char* hectr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
