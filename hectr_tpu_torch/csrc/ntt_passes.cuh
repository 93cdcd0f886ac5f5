// The forward NTT's passes and launch plumbing shared by the kernels that
// run it: K1 (ntt.cu) and K14 (encrypt.cu).  The design is ntt.cu's note:
// register-resident radix passes of at most 5 stages, a row exchanged
// between passes through swizzled shared memory and spread over a cluster
// of 2^logc CTAs, the first pass the only one that crosses CTAs.  The plan
// and geometry come from ops/ntt_cuda.py::geometry and are checked here
// (valid).  Each including file gets its own copy: everything below is in
// an anonymous namespace.

#pragma once

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
  int logc;                 // the row is spread over 2^logc CTAs
  int rank;                 // this CTA's rank among them
  int base;                 // the cluster rank of the first of them
  uint32_t p, p2;
  const uint32_t* w;        // this limb's twiddles and companions
  const uint32_t* wsh;
};

// Forward, first pass (the top R index bits, lo = logN - R): V columns
// per thread, read from device memory (each word through `load`, which
// gives a residue below 2p), results stored into the owning CTA's shared
// memory.  Column pairs are spread over the cluster.  Unless `waited`,
// each thread completes the cluster barrier its thread arrived at before
// its first store: the peers' memory is then live and free to write.
template <int R, int V, typename Load>
__device__ void fwd_first(const int64_t* __restrict__ x, uint32_t* s,
                          const Row& r, Load load, bool waited) {
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
      const int64_t* src = x + (v << lo) + l;
      if constexpr (V == 2) {
        const longlong2 d = __ldg(reinterpret_cast<const longlong2*>(src));
        a[0][v] = load(d.x);
        a[1][v] = load(d.y);
      } else {
        a[0][v] = load(__ldg(reinterpret_cast<const long long*>(src)));
      }
    }
    ct_stages<R, V>(a, r.w, r.wsh, 1, r.p, r.p2);
    if (!waited) {          // every peer has arrived: its memory is free
      cluster_wait();
      waited = true;
    }
#pragma unroll
    for (int v = 0; v < E; ++v) {
      const int i = (v << lo) + l;
      const int owner = i >> slice_log;
      uint32_t* dst =
          owner == r.rank ? s : cluster.map_shared_rank(s, r.base + owner);
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
          owner == r.rank ? s : cluster.map_shared_rank(s, r.base + owner);
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

// Row `row` of a launch over L limbs, as the CTA of rank `rank` among the
// 2^logc that hold it, the first of them rank `base` of the cluster.
__device__ __forceinline__ Row row_of(const uint32_t* primes,
                                      const uint32_t* w, const uint32_t* wsh,
                                      int row, int L, int logn, int logc,
                                      int rank, int base) {
  const int limb = row % L;
  const uint32_t p = primes[limb];
  const size_t off = static_cast<size_t>(limb) << logn;
  return Row{logn, logc, rank, base, p, p + p, w + off, wsh + off};
}

// The row of a launch whose cluster is the 2^logc CTAs of one row.
__device__ __forceinline__ Row make_row(const uint32_t* primes,
                                        const uint32_t* w,
                                        const uint32_t* wsh, int L, int logn,
                                        int logc) {
  return row_of(primes, w, wsh, blockIdx.x >> logc, L, logn, logc,
                static_cast<int>(cg::this_cluster().block_rank()), 0);
}

__device__ __forceinline__ void cluster_sync(int logc) {
  if (logc > 0)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// K1's input word: the residue in its low 32 bits
struct Low32 {
  __device__ __forceinline__ uint32_t operator()(int64_t a) const {
    return static_cast<uint32_t>(a);
  }
};

// The forward transform of the row at x (each word through `load`) into
// this CTA's slice s of the row, lazy in [0, 2p), in bit-reversed order:
// the first pass across the cluster, then the local passes, each followed
// by a barrier, so every thread of the CTA may read the slice after it.
// `waited` as fwd_first's.
template <int V0, typename Load>
__device__ __forceinline__ void forward(const int64_t* __restrict__ x,
                                        uint32_t* s, const Row& r, int plan,
                                        Load load, bool waited) {
  const int r0 = plan & 15;
  if (r.logn > r0)
    by_width<kFirstPassBits<V0>>(r0, [&](auto R) {
      fwd_first<decltype(R)::value, V0>(x, s, r, load, waited);
    });
  else
    by_width<kMaxPassBits>(r0, [&](auto R) {
      fwd_first<decltype(R)::value, 1>(x, s, r, load, waited);
    });
  cluster_sync(r.logc);

  int lo = r.logn - r0;
  for (int j = 1; (plan >> (4 * j)) & 15; ++j) {
    const int rj = (plan >> (4 * j)) & 15;
    lo -= rj;
    by_width<kMaxPassBits>(
        rj, [&](auto R) { local_pass<decltype(R)::value, true>(s, r, lo); });
    __syncthreads();
  }
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

// One launch of `kernel` over `rows` clusters of `cluster` CTAs,
// `smem` bytes of dynamic shared memory a CTA.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int rows, int cluster,
                   int threads, size_t smem, void* stream, Args... args) {
  const cudaError_t set = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (set != cudaSuccess) return set;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * cluster);
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
