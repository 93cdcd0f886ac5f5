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
//
// The passes and the launch plumbing live in ntt_passes.cuh, which K14
// (encrypt.cu) shares.

#include "ntt_passes.cuh"

namespace {

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
  forward<V0>(in + row_off, s, r, plan, Low32(), logc == 0);

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
      rows, 1 << logc, threads, sizeof(uint32_t) << (logn - logc), stream,
      static_cast<const int64_t*>(in),
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
      rows, 1 << logc, threads, sizeof(uint32_t) << (logn - logc), stream,
      static_cast<const int64_t*>(in),
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
