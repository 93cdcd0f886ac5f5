// The fused passes of hybrid key switching for Hopper (sm_90a): K6 (RNS base
// conversion), K7 (the key inner product) and K8 (the mod-down tail).
//
// In the JAX package these are XLA code that jax.jit fuses into a few passes
// over the residues on a TPU: grouped_convert / base_convert
// (hectr_tpu/ckks/basecvt.py:134, :157), _inner_product and the tail of
// _mod_down_special (hectr_tpu/ckks/keyswitch.py:281, :302).  Eager PyTorch
// runs each as dozens of int64 kernels with a full-size temporary apiece.
// Each kernel here computes what the plain PyTorch function of the port
// computes (hectr_tpu_torch/ckks/basecvt.py grouped_convert / base_convert,
// ckks/keyswitch.py key_inner_product / mod_down_tail), bit for bit: every
// output is the unique residue in [0, p), so any exact order of the modular
// sums gives the plain words.
//
// Layout.  The port's contiguous int64 residue tensors (residues < p < 2^30),
// read as their low 32 bits and written zero-extended; the constants are the
// port's int64 tensors as they are (values < 2^32).  Every kernel takes any
// column count C (a coefficient mesh passes N / D columns) and any row subset
// with its own primes (a limb mesh passes a shard's rows).
//
// What bounds them on this card: device memory.  K6 moves 8 bytes in per
// group row and 8 out per target row for about (A + 1) lazy multiplies per
// output; K7 reads a digit and its key words (8 and 32 or 16 bytes) for two
// multiplies; K8 moves 24 bytes for one.  At the card's 5.6e12 lazy
// multiplies/s and 3.35 TB/s that is 2-6 times below the multiply rate
// (bench.keyswitch_bound counts both).  So each is one pass: each input read
// once, each output written once, nothing in between in device memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "modmath.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatchTile = 8;    // leading rows one K7 thread carries

__device__ __forceinline__ uint32_t reduce(uint32_t v, uint32_t p) {
  return v >= p ? v - p : v;
}

// The low 32 bits of a read-only int64 word, through the read-only cache.
__device__ __forceinline__ uint32_t word(const int64_t* a, int64_t i) {
  return static_cast<uint32_t>(
      __ldg(reinterpret_cast<const long long*>(a + i)));
}

// K6: x [lead, G, A, C] -> out [lead, G, T, C].  One thread per (leading
// row, group, column) and chunk of `tchunk` target rows (blockIdx.y) does the
// conversion of its column for those rows in registers.  A conversion from
// one or two source rows (the mod-down, a rescale) has only lead * C columns,
// too few threads to fill the card at one thread a column, so the targets
// are spread over the grid, as many chunks as one wave of resident threads
// holds (more waves would pay the chain below once each); each chunk
// recomputes y and v, which costs A reads of x from L2 and a few
// multiplies, and changes no output word:
//   y_i = x_i (Q/q_i)^-1 mod q_i                     canonical, in [0, q_i)
//   v   = rint(y_0/q_0 + y_1/q_1 + ...)              float64, left to right
//   out = sum_i y_i [Q/q_i]_{p_t} - v [Q]_{p_t}      mod p_t, every target t
// v decides bit-equality: another order or rounding of the float sum can move
// it by one (the plain _correction's docstring).  So each quotient is one
// IEEE division and the sum runs left to right from y_0/q_0, with the _rn
// intrinsics (never contracted into an FMA), and rint rounds half to even as
// torch.round does.  A truncated group's dummy rows (q = 1, inverse 0, so
// y = 0) would add +0.0, which leaves the non-negative sum as it is:
// skipping them is bit-equal.  0 <= v <= A, and y_i < q_i < 2^30 is below
// 2^32, the lazy Shoup multiply's domain, even where q_i > p_t.
template <int A>
__global__ void __launch_bounds__(kThreads) base_convert_kernel(
    const int64_t* __restrict__ x, int64_t* __restrict__ out,
    const int64_t* __restrict__ inv, const int64_t* __restrict__ inv_shoup,
    const int64_t* __restrict__ q, const int64_t* __restrict__ M,
    const int64_t* __restrict__ M_shoup, const int64_t* __restrict__ Qmod,
    const int64_t* __restrict__ Qmod_shoup, const int64_t* __restrict__ p,
    int64_t threads_total, int G, int T, int64_t C, int tchunk) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= threads_total) return;
  const int64_t col = i % C;
  const int64_t lg = i / C;               // leading row * G + group
  const int g = static_cast<int>(lg % G);
  const int64_t* xin = x + lg * A * C + col;
  int64_t* o = out + lg * T * C + col;

  uint32_t y[A];
  bool real[A];
  double s = 0.0;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const uint32_t qa = word(q, g * A + a);
    real[a] = qa != 1u;
    y[a] = 0;
    if (real[a]) {
      const uint32_t xa = static_cast<uint32_t>(xin[a * C]);
      y[a] = reduce(mul_shoup_lazy(xa, word(inv, g * A + a),
                                   word(inv_shoup, g * A + a), qa), qa);
      const double r = __ddiv_rn(static_cast<double>(y[a]),
                                 static_cast<double>(qa));
      s = a == 0 ? r : __dadd_rn(s, r);
    }
  }
  const uint32_t v = static_cast<uint32_t>(rint(s));

  const int t_end = min(T, static_cast<int>(blockIdx.y + 1) * tchunk);
  for (int t = blockIdx.y * tchunk; t < t_end; ++t) {
    const uint32_t pt = word(p, t);
    const uint32_t p2 = 2 * pt;
    uint32_t acc = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (real[a]) {
        const int64_t m = (static_cast<int64_t>(g) * A + a) * T + t;
        acc = add_lazy(acc, mul_shoup_lazy(y[a], word(M, m),
                                           word(M_shoup, m), pt), p2);
      }
    }
    const int64_t gt = static_cast<int64_t>(g) * T + t;
    const uint32_t corr = mul_shoup_lazy(v, word(Qmod, gt),
                                         word(Qmod_shoup, gt), pt);
    o[t * C] = static_cast<int64_t>(reduce(sub_lazy(acc, corr, p2), pt));
  }
}

// K7: digits [lead, dnum, R, C] and the key [dnum, W, R, C] (W = 4: rows
// (b, a) and their Shoup companions; W = 2: the compact layout) -> out
// [lead, 2, R, C] = sum_j digits[j] * key[j, c] mod p_r, c = 0, 1.  One
// thread per (row, column) and tile of kBatchTile leading rows: it walks the
// digits and, inside, the tile's rows, so each key word is read once for the
// tile.  With `perm` the digits are read at perm[column] (a Galois
// automorphism in the evaluation domain), which saves materialising the
// permuted digit stack.
//   W = 4: lazy Shoup products in [0, 2p), summed lazily in [0, 2p).
//   W = 2: the products d * w < p^2 < 2^60 summed in 64 bits, reduced every
//          16 digits (16 such products stay below 2^64), then once.
template <bool SHOUP>
__global__ void __launch_bounds__(kThreads) key_inner_product_kernel(
    const int64_t* __restrict__ digits, const int64_t* __restrict__ key,
    const int64_t* __restrict__ perm, int64_t* __restrict__ out,
    const int64_t* __restrict__ p, int64_t lead, int dnum, int R,
    int64_t C) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t plane = static_cast<int64_t>(R) * C;
  if (i >= plane) return;
  const int64_t b0 = static_cast<int64_t>(blockIdx.y) * kBatchTile;
  const int nb = static_cast<int>(min(static_cast<int64_t>(kBatchTile),
                                      lead - b0));
  const int r = static_cast<int>(i / C);
  const int64_t col = i % C;
  const int64_t src =
      perm ? r * C + __ldg(reinterpret_cast<const long long*>(perm + col))
           : i;
  const uint32_t pr = word(p, r);
  const uint32_t p2 = 2 * pr;
  constexpr int W = SHOUP ? 4 : 2;
  const int64_t* d0 = digits + b0 * dnum * plane + src;

  if constexpr (SHOUP) {
    uint32_t acc0[kBatchTile], acc1[kBatchTile];
#pragma unroll
    for (int b = 0; b < kBatchTile; ++b) acc0[b] = acc1[b] = 0;
#pragma unroll 2
    for (int j = 0; j < dnum; ++j) {
      const int64_t* kj = key + j * W * plane + i;
      const uint32_t w0 = word(kj, 0), w1 = word(kj, plane);
      const uint32_t s0 = word(kj, 2 * plane), s1 = word(kj, 3 * plane);
#pragma unroll
      for (int b = 0; b < kBatchTile; ++b) {
        if (b < nb) {
          const uint32_t d = word(d0, (b * dnum + j) * plane);
          acc0[b] = add_lazy(acc0[b], mul_shoup_lazy(d, w0, s0, pr), p2);
          acc1[b] = add_lazy(acc1[b], mul_shoup_lazy(d, w1, s1, pr), p2);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatchTile; ++b) {
      if (b < nb) {
        int64_t* o = out + (b0 + b) * 2 * plane + i;
        o[0] = static_cast<int64_t>(reduce(acc0[b], pr));
        o[plane] = static_cast<int64_t>(reduce(acc1[b], pr));
      }
    }
  } else {
    uint64_t acc0[kBatchTile], acc1[kBatchTile];
#pragma unroll
    for (int b = 0; b < kBatchTile; ++b) acc0[b] = acc1[b] = 0;
    for (int j = 0; j < dnum; ++j) {
      const int64_t* kj = key + j * W * plane + i;
      const uint64_t w0 = word(kj, 0), w1 = word(kj, plane);
      const bool fold = (j & 15) == 15;
#pragma unroll
      for (int b = 0; b < kBatchTile; ++b) {
        if (b < nb) {
          const uint64_t d = word(d0, (b * dnum + j) * plane);
          acc0[b] += d * w0;
          acc1[b] += d * w1;
          if (fold) {
            acc0[b] %= pr;
            acc1[b] %= pr;
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatchTile; ++b) {
      if (b < nb) {
        int64_t* o = out + (b0 + b) * 2 * plane + i;
        o[0] = static_cast<int64_t>(acc0[b] % pr);
        o[plane] = static_cast<int64_t>(acc1[b] % pr);
      }
    }
  }
}

// K8: (acc - ext) * P^-1 mod p_r over [lead, R, C]; acc's leading rows lie
// `acc_stride` elements apart (the first R rows of a wider [.., R + S, C]
// tensor), ext and out are contiguous.
__global__ void __launch_bounds__(kThreads) mod_down_tail_kernel(
    const int64_t* __restrict__ acc, int64_t acc_stride,
    const int64_t* __restrict__ ext, const int64_t* __restrict__ pinv,
    const int64_t* __restrict__ pinv_shoup, const int64_t* __restrict__ p,
    int64_t* __restrict__ out, int64_t threads_total, int R, int64_t C) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= threads_total) return;
  const int64_t plane = static_cast<int64_t>(R) * C;
  const int64_t row = i / plane;
  const int64_t rc = i % plane;
  const int r = static_cast<int>(rc / C);
  const uint32_t pr = word(p, r);
  const uint32_t a = static_cast<uint32_t>(acc[row * acc_stride + rc]);
  const uint32_t e = static_cast<uint32_t>(ext[i]);
  const uint32_t diff = sub_lazy(a, e, 2 * pr);
  out[i] = static_cast<int64_t>(
      reduce(mul_shoup_lazy(diff, word(pinv, r), word(pinv_shoup, r), pr),
             pr));
}

// Blocks for one thread per element, or 0 if the grid is too large.
unsigned blocks_for(int64_t threads_total) {
  const int64_t blocks = (threads_total + kThreads - 1) / kThreads;
  return blocks > 0x7fffffff ? 0u : static_cast<unsigned>(blocks);
}

// The threads of K6<A> the card holds at once: SMs x the blocks an SM keeps
// resident at this instance's registers; read once (0 if it cannot be read,
// which leaves one chunk).
template <int A>
int64_t resident_threads() {
  static const int64_t n = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, base_convert_kernel<A>, kThreads, 0) != cudaSuccess) {
      (void)cudaGetLastError();      // leave no error for the launch check
      return int64_t{0};
    }
    return static_cast<int64_t>(sms) * per_sm * kThreads;
  }();
  return n;
}

template <int A>
cudaError_t launch_base_convert(const void* x, void* out, const void* inv,
                                const void* inv_shoup, const void* q,
                                const void* M, const void* M_shoup,
                                const void* Qmod, const void* Qmod_shoup,
                                const void* p, int64_t lead, int G, int T,
                                int64_t C, cudaStream_t stream) {
  const int64_t threads_total = lead * G * C;
  const unsigned blocks = blocks_for(threads_total);
  if (blocks == 0) return cudaErrorInvalidValue;
  const int64_t fit = resident_threads<A>() / threads_total;
  const int chunks = static_cast<int>(fit < 1 ? 1 : fit < T ? fit : T);
  const int tchunk = (T + chunks - 1) / chunks;
  const dim3 grid(blocks, static_cast<unsigned>((T + tchunk - 1) / tchunk));
  base_convert_kernel<A><<<grid, kThreads, 0, stream>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const int64_t*>(inv), static_cast<const int64_t*>(inv_shoup),
      static_cast<const int64_t*>(q), static_cast<const int64_t*>(M),
      static_cast<const int64_t*>(M_shoup), static_cast<const int64_t*>(Qmod),
      static_cast<const int64_t*>(Qmod_shoup), static_cast<const int64_t*>(p),
      threads_total, G, T, C, tchunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the launch's CUDA error
// (0 on success); it neither allocates nor synchronises.

// K6: x [lead, G, A, C] over each group's primes q ([G, A]) -> out
// [lead, G, T, C] over the targets p ([T]); the constants of
// ckks/basecvt.py (inv, inv_shoup, q [G, A]; M, M_shoup [G, A, T]; Qmod,
// Qmod_shoup [G, T]), int64.
int hectr_base_convert(const void* x, void* out, const void* inv,
                       const void* inv_shoup, const void* q, const void* M,
                       const void* M_shoup, const void* Qmod,
                       const void* Qmod_shoup, const void* p, int64_t lead,
                       int G, int A, int T, int64_t C, void* stream) {
  if (lead < 1 || G < 1 || T < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (A) {
#define HECTR_BASE_CONVERT(N)                                              \
    case N:                                                                \
      return static_cast<int>(launch_base_convert<N>(                      \
          x, out, inv, inv_shoup, q, M, M_shoup, Qmod, Qmod_shoup, p,      \
          lead, G, T, C, s));
    HECTR_BASE_CONVERT(1)
    HECTR_BASE_CONVERT(2)
    HECTR_BASE_CONVERT(3)
    HECTR_BASE_CONVERT(4)
#undef HECTR_BASE_CONVERT
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7: digits [lead, dnum, R, C], key [dnum, 4 or 2, R, C] (shoup = 1 or 0),
// perm [C] of int64 or null, p [R] -> out [lead, 2, R, C].
int hectr_key_inner_product(const void* digits, const void* key,
                            const void* perm, void* out, const void* p,
                            int64_t lead, int dnum, int R, int64_t C,
                            int shoup, void* stream) {
  if (lead < 1 || dnum < 1 || R < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = blocks_for(static_cast<int64_t>(R) * C);
  const int64_t tiles = (lead + kBatchTile - 1) / kBatchTile;
  if (blocks == 0 || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks, static_cast<unsigned>(tiles));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const int64_t*>(digits);
  const auto* k = static_cast<const int64_t*>(key);
  const auto* pm = static_cast<const int64_t*>(perm);
  auto* o = static_cast<int64_t*>(out);
  const auto* pr = static_cast<const int64_t*>(p);
  if (shoup)
    key_inner_product_kernel<true><<<grid, kThreads, 0, s>>>(
        d, k, pm, o, pr, lead, dnum, R, C);
  else
    key_inner_product_kernel<false><<<grid, kThreads, 0, s>>>(
        d, k, pm, o, pr, lead, dnum, R, C);
  return static_cast<int>(cudaGetLastError());
}

// K8: acc [lead, R, C] with leading stride acc_stride, ext [lead, R, C],
// pinv, pinv_shoup, p [R] -> out [lead, R, C].
int hectr_mod_down_tail(const void* acc, int64_t acc_stride, const void* ext,
                        const void* pinv, const void* pinv_shoup,
                        const void* p, void* out, int64_t lead, int R,
                        int64_t C, void* stream) {
  if (lead < 1 || R < 1 || C < 1 || acc_stride < static_cast<int64_t>(R) * C)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads_total = lead * R * C;
  const unsigned blocks = blocks_for(threads_total);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  mod_down_tail_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(acc), acc_stride,
      static_cast<const int64_t*>(ext), static_cast<const int64_t*>(pinv),
      static_cast<const int64_t*>(pinv_shoup), static_cast<const int64_t*>(p),
      static_cast<int64_t*>(out), threads_total, R, C);
  return static_cast<int>(cudaGetLastError());
}

const char* hectr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
