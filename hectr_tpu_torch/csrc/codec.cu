// CKKS encode and decode for Hopper (sm_90a): K11, the float64 encode pass,
// and K12, the double-double CRT decode.
//
// In the JAX package these are XLA code that jax.jit fuses, with the Pallas
// NTT, into the one program of a loop step on a TPU: encode
// (hectr_tpu/ckks/scheme.py:162-184: the embedding of encoding.py:145-159,
// round(m' * scale), integer_residues of encoding.py:180-205, the zero fill
// and the strided store) and decode_ri (scheme.py:187-236: the CRT digits,
// the double-double fractional CRT of dd.py:23-105, the unembedding of
// encoding.py:169-177).  Eager PyTorch runs them as about 36 float64 and
// int64 launches an encode and 25 a limb of decode.
//
// K11 computes what the plain composition of the port computes
// (hectr_tpu_torch/ckks/encoding.py coefficient_rows_plain of embed_ri): for
// each coefficient row of each prime p, the residue of y = rint(m'_j * scale)
// mod p at column j * (N / 2s), zero at every other column.  The m' entry
// reads m' as it is, so it is bit-equal to the plain version; the fused entry
// (s <= 64) computes m'_j = (sum_i ReE[i,j] re_i + sum_i ImE[i,j] im_i) / s
// itself, each sum over i ascending, where the plain version's matrix
// product sums in the BLAS's order: the two may round m'_j an ulp apart, and
// y then by at most one.  The integer stage is integer_residues' own: the
// exact split |y| = a1 2^54 + a2 2^27 + a3, (a1 [2^54]_p + (a2 [2^27]_p mod
// p) + a3) mod p in int64, and p - r for a negative y.
//
// K12 computes what decode_ri's plain tail computes (scheme.py
// crt_values_plain): the digits c_i = x_i (Q/p_i)^-1 mod p_i by the Barrett
// mul_mod of ckks/modmath.py (modmath.cuh, as K9 runs it), the double-double
// sum of c_i / p_i over the rows in row order, its fractional part times
// Q / scale, y = hi + lo: bit-equal to the plain y.  For s <= 64 it also
// unembeds, re_i = sum_j ReE[i,j] y_j and im_i the same with ImE, j
// ascending (the plain matrix-vector product sums in the BLAS's order).  The
// digits entry takes the digits gathered already (a limb mesh's decode).
//
// Every float64 operation is a round-to-nearest intrinsic (__dadd_rn,
// __dsub_rn, __dmul_rn, __ddiv_rn): nvcc's default --fmad=true would contract
// a product and a sum into an FMA, which breaks the Dekker/Knuth error-free
// transforms (ckks/dd.py) and would round the embedding's sums otherwise
// than the plain elementwise operations.  rint rounds half to even, as
// torch.round does.
//
// Layout.  The data operands are read through their own strides: the
// wrapper (hectr_tpu_torch/ops/codec_cuda.py) merges their leading (batch)
// dimensions, up to kMaxBatchDims, and passes each operand's strides over
// them and along its inner dimensions, so the real and imaginary views of a
// complex tensor, a zero vector broadcast over a batch and the strided view
// intt(...)[..., ::N/2s] are read in place.  The outputs are contiguous.
//
// What bounds them on this card: K11 writes r N 8 bytes a batch row (5.8 MB
// at FLAGSHIP's 22 rows: 1.7 us at 3.35 TB/s) for 4 s float64 operations and
// a few integer ones a nonzero coefficient, so device memory; one thread
// writes four columns of one row, neighbouring threads neighbouring words,
// and the thread of a nonzero column computes its coefficient (the embedding
// redone for each prime: 2s products, against the 8 N / 2s bytes of its
// row's columns).  K12 reads 2s words of each of k rows at a stride of N/2s
// words (a 32-byte sector each) for about 60 float64 operations a word: a
// FLAGSHIP decode is 2 rows x 32 columns, latency-bound by nature.  Its point
// is one launch where the plain version makes about 60; one block a batch
// row keeps its 2s values of y in shared memory for the unembedding.

#include <cstdint>
#include <cuda_runtime.h>

#include "modmath.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                  // columns a K11 thread walks
constexpr int kColumnsPerBlock = kThreads * kPerThread;
constexpr int kMaxBatchDims = 4;
constexpr int kMaxUnembedWidth = 128;          // 2 * MATRIX_MAX_SLOTS

// The merged leading dimensions, outer to inner (unused ones of size 1), and
// two operands' strides over them, in elements.
struct Batch {
  uint32_t sizes[kMaxBatchDims];
  int64_t strides[2][kMaxBatchDims];
};

struct EncodeArgs {
  Batch batch;
  const double* in0;        // re (fused) or m'
  const double* in1;        // im (fused) or null
  int64_t in_strides[2];    // along the slot / coefficient dimension
  const double* re_e;       // ReE, ImE [s, 2s] contiguous (fused), or null
  const double* im_e;
  const int64_t* primes;    // [r] through prime_stride
  int64_t prime_stride;
  int64_t* out;             // [batch, r, n] contiguous
  double scale;
  uint32_t rows;            // r
  uint32_t n;               // columns of a row
  uint32_t width;           // 2s coefficients
  uint32_t stride;          // n / width
  uint32_t col_blocks;      // blocks along a row
};

struct DecodeArgs {
  Batch batch;
  const int64_t* x;         // [batch, k, 2s] through its strides
  int64_t row_stride;
  int64_t col_stride;
  const int64_t* consts[4]; // p, inv, mu, k: [k] through const_strides
  int64_t const_strides[4];
  const double* re_e;       // ReE, ImE [s, 2s] contiguous, or null
  const double* im_e;
  double* out0;             // y [batch, 2s], or re [batch, s]
  double* out1;             // im [batch, s] (unembedding), or null
  double q_hi;              // Q / scale as a double-double
  double q_lo;
  uint32_t rows;            // k
  uint32_t width;           // 2s
  uint32_t col_blocks;      // blocks along y (no unembedding)
};

__device__ __forceinline__ void batch_offsets(const Batch& b, uint32_t row,
                                              int64_t& o0, int64_t& o1) {
  o0 = 0;
  o1 = 0;
#pragma unroll
  for (int d = kMaxBatchDims - 1; d >= 0; --d) {
    const uint32_t size = b.sizes[d];
    if (size > 1) {
      const int64_t i = row % size;
      row /= size;
      o0 += i * b.strides[0][d];
      o1 += i * b.strides[1][d];
    }
  }
}

__device__ __forceinline__ double ld(const double* a, int64_t i) {
  return __ldg(a + i);
}
__device__ __forceinline__ int64_t ld(const int64_t* a, int64_t i) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(a + i)));
}

// ---- the integer stage of encode (encoding.py integer_residues) ----------

// torch.remainder of int64: the result takes the divisor's sign.
__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t p) {
  const int64_t r = a % p;
  return r != 0 && ((r < 0) != (p < 0)) ? r + p : r;
}

// The residue of the integer-valued y (|y| < 2^60) mod p, in integer_residues'
// operation order: every float64 step below is exact.
__device__ __forceinline__ int64_t residue(double y, int64_t p) {
  const bool neg = y < 0.0;
  const double a = fabs(y);
  const double a1 = floor(__ddiv_rn(a, 0x1p54));
  const double r1 = __dsub_rn(a, __dmul_rn(a1, 0x1p54));
  const double a2 = floor(__ddiv_rn(r1, 0x1p27));
  const double a3 = __dsub_rn(r1, __dmul_rn(a2, 0x1p27));
  const int64_t c54 = floor_mod(int64_t{1} << 54, p);
  const int64_t c27 = floor_mod(int64_t{1} << 27, p);
  const int64_t sum = add64(add64(mul64(static_cast<int64_t>(a1), c54),
                                  floor_mod(mul64(static_cast<int64_t>(a2),
                                                  c27), p)),
                            static_cast<int64_t>(a3));
  const int64_t r = floor_mod(sum, p);
  return neg && r != 0 ? sub64(p, r) : r;
}

// m'_j of the fused entry: (sum_i ReE[i,j] re_i + sum_i ImE[i,j] im_i) / s.
__device__ __forceinline__ double embedded(const EncodeArgs& a, int64_t o0,
                                           int64_t o1, uint32_t j) {
  const uint32_t s = a.width / 2;
  double sr = 0.0;
  for (uint32_t i = 0; i < s; ++i)
    sr = __dadd_rn(sr, __dmul_rn(ld(a.re_e, int64_t{i} * a.width + j),
                                 ld(a.in0, o0 + i * a.in_strides[0])));
  double si = 0.0;
  for (uint32_t i = 0; i < s; ++i)
    si = __dadd_rn(si, __dmul_rn(ld(a.im_e, int64_t{i} * a.width + j),
                                 ld(a.in1, o1 + i * a.in_strides[1])));
  return __ddiv_rn(__dadd_rn(sr, si), static_cast<double>(s));
}

// K11: block b covers kColumnsPerBlock columns of output row
// b / col_blocks, which is (batch row, prime) in that order.
template <bool FUSED>
__global__ void __launch_bounds__(kThreads) encode_residues_kernel(
    const EncodeArgs a) {
  const uint32_t row = blockIdx.x / a.col_blocks;
  const uint32_t c0 = (blockIdx.x % a.col_blocks) * kColumnsPerBlock +
                      threadIdx.x;
  int64_t o0, o1;
  batch_offsets(a.batch, row / a.rows, o0, o1);
  const int64_t p = ld(a.primes, (row % a.rows) * a.prime_stride);
  int64_t* out = a.out + static_cast<int64_t>(row) * a.n;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const uint32_t col = c0 + e * kThreads;
    if (col < a.n) {
      int64_t v = 0;
      if (col % a.stride == 0) {
        const uint32_t j = col / a.stride;
        const double m = FUSED ? embedded(a, o0, o1, j)
                               : ld(a.in0, o0 + j * a.in_strides[0]);
        v = residue(rint(__dmul_rn(m, a.scale)), p);
      }
      out[col] = v;
    }
  }
}

// ---- double-double arithmetic (ckks/dd.py), operation for operation -------

struct DD {
  double hi, lo;
};

__device__ __forceinline__ DD two_sum(double a, double b) {
  const double s = __dadd_rn(a, b);
  const double v = __dsub_rn(s, a);
  return {s, __dadd_rn(__dsub_rn(a, __dsub_rn(s, v)), __dsub_rn(b, v))};
}
__device__ __forceinline__ DD quick_two_sum(double a, double b) {
  const double s = __dadd_rn(a, b);
  return {s, __dsub_rn(b, __dsub_rn(s, a))};
}
__device__ __forceinline__ DD split(double a) {
  const double c = __dmul_rn(134217729.0, a);   // 2^27 + 1
  const double hi = __dsub_rn(c, __dsub_rn(c, a));
  return {hi, __dsub_rn(a, hi)};
}
__device__ __forceinline__ DD two_prod(double a, double b) {
  const double p = __dmul_rn(a, b);
  const DD x = split(a), y = split(b);
  double e = __dsub_rn(__dmul_rn(x.hi, y.hi), p);
  e = __dadd_rn(e, __dmul_rn(x.hi, y.lo));
  e = __dadd_rn(e, __dmul_rn(x.lo, y.hi));
  return {p, __dadd_rn(e, __dmul_rn(x.lo, y.lo))};
}
__device__ __forceinline__ DD dd_add(DD x, DD y) {
  const DD s = two_sum(x.hi, y.hi);
  return quick_two_sum(s.hi, __dadd_rn(__dadd_rn(s.lo, x.lo), y.lo));
}
__device__ __forceinline__ DD dd_add_f(DD x, double b) {
  const DD s = two_sum(x.hi, b);
  return quick_two_sum(s.hi, __dadd_rn(s.lo, x.lo));
}
__device__ __forceinline__ DD dd_mul(DD x, DD y) {
  const DD p = two_prod(x.hi, y.hi);
  const double e = __dadd_rn(__dadd_rn(p.lo, __dmul_rn(x.hi, y.lo)),
                             __dmul_rn(x.lo, y.hi));
  return quick_two_sum(p.hi, e);
}
__device__ __forceinline__ DD dd_div_ff(double a, double b) {
  const double q1 = __ddiv_rn(a, b);
  const DD pe = two_prod(q1, b);
  const double r = __dsub_rn(__dsub_rn(a, pe.hi), pe.lo);
  return quick_two_sum(q1, __ddiv_rn(r, b));
}
__device__ __forceinline__ double dd_round(DD x) {
  const double r = rint(x.hi);
  return __dadd_rn(r, rint(__dadd_rn(__dsub_rn(x.hi, r), x.lo)));
}

// y_j of one batch row (x offset o): crt_values_plain for column j.
template <bool DIGITS>
__device__ __forceinline__ double crt_value(const DecodeArgs& a, int64_t o,
                                            uint32_t j) {
  DD acc{0.0, 0.0};
  for (uint32_t i = 0; i < a.rows; ++i) {
    int64_t c = ld(a.x, o + i * a.row_stride + j * a.col_stride);
    const int64_t p = ld(a.consts[0], i * a.const_strides[0]);
    if constexpr (!DIGITS)
      c = barrett(mul64(c, ld(a.consts[1], i * a.const_strides[1])), p,
                  ld(a.consts[2], i * a.const_strides[2]),
                  ld(a.consts[3], i * a.const_strides[3]));
    acc = dd_add(acc, dd_div_ff(static_cast<double>(c),
                                static_cast<double>(p)));
  }
  const double r = dd_round(acc);
  const DD y = dd_mul(dd_add_f(acc, -r), DD{a.q_hi, a.q_lo});
  return __dadd_rn(y.hi, y.lo);
}

// K12 without the unembedding: one thread a coefficient, y [batch, 2s].
template <bool DIGITS>
__global__ void __launch_bounds__(kThreads) crt_decode_kernel(
    const DecodeArgs a) {
  const uint32_t b = blockIdx.x / a.col_blocks;
  const uint32_t j = (blockIdx.x % a.col_blocks) * kThreads + threadIdx.x;
  if (j >= a.width) return;
  int64_t o, unused;
  batch_offsets(a.batch, b, o, unused);
  a.out0[static_cast<int64_t>(b) * a.width + j] = crt_value<DIGITS>(a, o, j);
}

// K12 with the unembedding (2s <= kMaxUnembedWidth): one block a batch row,
// thread j computes y_j into shared memory, then thread i < s writes re_i and
// thread s + i writes im_i.
template <bool DIGITS>
__global__ void __launch_bounds__(kMaxUnembedWidth) crt_unembed_kernel(
    const DecodeArgs a) {
  __shared__ double ys[kMaxUnembedWidth];
  const uint32_t b = blockIdx.x;
  const uint32_t j = threadIdx.x;
  int64_t o, unused;
  batch_offsets(a.batch, b, o, unused);
  if (j < a.width) ys[j] = crt_value<DIGITS>(a, o, j);
  __syncthreads();
  if (j >= a.width) return;
  const uint32_t s = a.width / 2;
  const bool real = j < s;
  const uint32_t i = real ? j : j - s;
  const double* E = (real ? a.re_e : a.im_e) + int64_t{i} * a.width;
  double acc = 0.0;
  for (uint32_t t = 0; t < a.width; ++t)
    acc = __dadd_rn(acc, __dmul_rn(ld(E, t), ys[t]));
  (real ? a.out0 : a.out1)[int64_t{b} * s + i] = acc;
}

// Fills the batch from the wrapper's merged sizes[nbatch] and strides
// [nops * nbatch]; returns the batch's row count, or 0 where out of range.
int64_t fill_batch(Batch& b, int nbatch, int nops, const int64_t* sizes,
                   const int64_t* strides) {
  if (nbatch < 1 || nbatch > kMaxBatchDims) return 0;
  const int shift = kMaxBatchDims - nbatch;     // right-aligned
  int64_t rows = 1;
  for (int d = 0; d < kMaxBatchDims; ++d) {
    const int src = d - shift;
    const int64_t size = src >= 0 ? sizes[src] : 1;
    if (size < 1) return 0;
    rows *= size;
    if (rows > 0x7fffffffLL) return 0;
    b.sizes[d] = static_cast<uint32_t>(size);
    for (int j = 0; j < 2; ++j)
      b.strides[j][d] = src >= 0 && j < nops ? strides[j * nbatch + src] : 0;
  }
  return rows;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the launch's CUDA error
// (0 on success); it neither allocates nor synchronises.

// K11: in0 / in1 float64 (re, im [batch, s], with re_e and im_e the [s, 2s]
// embedding matrices) or in0 alone (m' [batch, width], re_e null), read
// through bstrides[j * nbatch + d] over the batch and in_stride{0,1} along
// the last dimension; out int64 [batch, rows, n] contiguous.
int hectr_encode_residues(int nbatch, const int64_t* bsizes,
                          const int64_t* bstrides, const void* in0,
                          const void* in1, int64_t in_stride0,
                          int64_t in_stride1, const void* re_e,
                          const void* im_e, int64_t width,
                          const void* primes, int64_t prime_stride,
                          int64_t rows, int64_t n, double scale, void* out,
                          void* stream) {
  EncodeArgs a;
  const bool fused = re_e != nullptr;
  const int64_t batch = fill_batch(a.batch, nbatch, fused ? 2 : 1, bsizes,
                                   bstrides);
  if (batch == 0 || width < 1 || rows < 1 || n < width || n % width ||
      n > 0x7fffffffLL || (fused && (width % 2 || im_e == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.in0 = static_cast<const double*>(in0);
  a.in1 = static_cast<const double*>(in1);
  a.in_strides[0] = in_stride0;
  a.in_strides[1] = in_stride1;
  a.re_e = static_cast<const double*>(re_e);
  a.im_e = static_cast<const double*>(im_e);
  a.primes = static_cast<const int64_t*>(primes);
  a.prime_stride = prime_stride;
  a.out = static_cast<int64_t*>(out);
  a.scale = scale;
  a.rows = static_cast<uint32_t>(rows);
  a.n = static_cast<uint32_t>(n);
  a.width = static_cast<uint32_t>(width);
  a.stride = static_cast<uint32_t>(n / width);
  a.col_blocks = static_cast<uint32_t>((n + kColumnsPerBlock - 1) /
                                       kColumnsPerBlock);
  const int64_t blocks = batch * rows * a.col_blocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused)
    encode_residues_kernel<true><<<static_cast<unsigned>(blocks), kThreads,
                                   0, s>>>(a);
  else
    encode_residues_kernel<false><<<static_cast<unsigned>(blocks), kThreads,
                                    0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K12: x int64 [batch, rows, width] through bstrides[d] over the batch,
// row_stride and col_stride; consts p, inv, mu, k ([rows] through
// const_strides; inv, mu, k null for the digits entry, whose x are the digits
// already); out0 float64 y [batch, width] (re_e null), or out0 = re and
// out1 = im [batch, width / 2] unembedded through re_e, im_e [width / 2,
// width] (width <= 128).
int hectr_crt_decode(int nbatch, const int64_t* bsizes,
                     const int64_t* bstrides, const void* x,
                     int64_t row_stride, int64_t col_stride, int64_t rows,
                     int64_t width, const void* p, const void* inv,
                     const void* mu, const void* k,
                     const int64_t* const_strides, double q_hi, double q_lo,
                     const void* re_e, const void* im_e, void* out0,
                     void* out1, void* stream) {
  DecodeArgs a;
  const int64_t batch = fill_batch(a.batch, nbatch, 1, bsizes, bstrides);
  const bool digits = inv == nullptr;
  const bool unembed = re_e != nullptr;
  if (batch == 0 || rows < 1 || width < 1 || width > 0x7fffffffLL ||
      p == nullptr || (!digits && (mu == nullptr || k == nullptr)) ||
      (unembed && (width % 2 || width > kMaxUnembedWidth ||
                   im_e == nullptr || out1 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const int64_t*>(x);
  a.row_stride = row_stride;
  a.col_stride = col_stride;
  const void* consts[4] = {p, inv, mu, k};
  for (int j = 0; j < 4; ++j) {
    a.consts[j] = static_cast<const int64_t*>(consts[j]);
    a.const_strides[j] = const_strides[j];
  }
  a.re_e = static_cast<const double*>(re_e);
  a.im_e = static_cast<const double*>(im_e);
  a.out0 = static_cast<double*>(out0);
  a.out1 = static_cast<double*>(out1);
  a.q_hi = q_hi;
  a.q_lo = q_lo;
  a.rows = static_cast<uint32_t>(rows);
  a.width = static_cast<uint32_t>(width);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (unembed) {
    a.col_blocks = 1;
    // whole warps of at least 2s threads
    const unsigned threads = static_cast<unsigned>((width + 31) / 32 * 32);
    if (digits)
      crt_unembed_kernel<true><<<static_cast<unsigned>(batch), threads, 0,
                                 s>>>(a);
    else
      crt_unembed_kernel<false><<<static_cast<unsigned>(batch), threads, 0,
                                  s>>>(a);
  } else {
    a.col_blocks = static_cast<uint32_t>((width + kThreads - 1) / kThreads);
    const int64_t blocks = batch * a.col_blocks;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    if (digits)
      crt_decode_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(a);
    else
      crt_decode_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hectr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
