// The scheme ops' modular arithmetic for Hopper (sm_90a): K9, one launch per
// RNS primitive, and K10, the BSGS group sum in one pass.
//
// In the JAX package these are XLA code that jax.jit fuses, inside one
// jitted lax.scan of the whole loop, into a few passes on a TPU: the
// primitives of hectr_tpu/ckks/modmath.py (add_mod :58, sub_mod :64, neg_mod
// :70, _barrett / mul_mod :76-85, mul_mod_shoup :100, mul_mod_shoup_wide
// :115) and the group sum of the baby-step/giant-step gemv
// (hectr_tpu/ckks/gemv.py:430-434, sum_mod(mul_mod(C, w))).  Eager PyTorch
// runs each primitive as 3-14 int64 kernels with a full-size temporary
// apiece, and the group sum as about 16 of them over the [n1, 2, k, N]
// product stack.
//
// Each kernel computes what the plain PyTorch function of the port computes
// (hectr_tpu_torch/ckks/modmath.py, <name>_plain), bit for bit, by the same
// arithmetic: signed 64-bit words that wrap as PyTorch's int64 do, the same
// quotient formulas (Barrett's ((ab >> (k-2)) * mu) >> (k+2), Shoup's
// (a w') >> 32), the same number of corrections and PyTorch's shift rule (a
// shift by 63 or more, or by a negative amount, is a shift by 63).  So they
// agree with the plain versions on every input, also outside the documented
// domain (the lazy [0, 2p) forms, the wide Shoup form on unreduced a).
//
// Layout.  Every operand is an int64 tensor read through its own strides:
// the wrapper (hectr_tpu_torch/ops/rns_cuda.py) broadcasts the operands'
// shapes, so a broadcast dimension has stride 0 (the [R, 1] prime and
// constant columns, a plaintext shared by a batch, a gadget [dnum, lf, 1]),
// and merges the dimensions that every operand lets it merge, up to
// kMaxDims.  A non-contiguous view (ct.data[..., 0, :, :], the first rows of
// a key, a limb shard's rows) is read in place, with no copy.  The output is
// contiguous.  K9 may read its first operand through a permutation of the
// last dimension (a Galois automorphism in the evaluation domain), so that
// add_mod(c0.index_select(-1, perm), ks0) is one launch.
//
// What bounds them on this card: device memory.  K9 moves 8 bytes for each
// element of each distinct operand and 8 out for 0-5 integer multiplies;
// K10 reads each word of C and of the plaintexts once and writes only the
// [..., 2, k, N] sum (never the product stack) for about 5 multiplies a
// product.  At 3.35 TB/s against the integer multiply rate that is 10-40
// times below the multiply peak (bench.rns_bound counts both).  So each is
// one pass, each thread on a few columns of one row: the row's per-row
// constants are one broadcast load, neighbouring threads read neighbouring
// words, and the grid decomposes a row index once per block, not per word.

#include <cstdint>
#include <cuda_runtime.h>

#include "modmath.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;              // columns a thread walks
constexpr int kColumnsPerBlock = kThreads * kPerThread;
constexpr int kMaxDims = 6;
constexpr int kMaxOperands = 6;

enum Op : int {
  kAdd = 0,          // (a, b, p)
  kSub = 1,          // (a, b, p)
  kNeg = 2,          // (a, p)
  kMul = 3,          // (a, b, p, mu, k)             Barrett
  kShoup = 4,        // (a, w, w_shoup, p)           one correction
  kShoupWide = 5,    // (a, w, w_shoup, p)           two corrections
  kShoupLazy = 6,    // (a, w, w_shoup, p)           none
  kMulAdd = 7,       // (a, b, c, p, mu, k)          add_mod(mul_mod(a, b), c)
};

// The operands' addresses and the merged iteration space: rows of `cols`
// columns, the row index spread over kMaxDims - 1 outer dimensions
// (innermost last; unused ones of size 1), strides in elements.  Every array
// is indexed by compile-time constants only, so the kernels read it from the
// parameter bank and never copy it to local memory.  K10's reduction axis has
// its own size and per-operand stride.
struct Args {
  const int64_t* in[kMaxOperands];
  int64_t* out;
  const int64_t* perm;
  int64_t cols;
  int64_t col_strides[kMaxOperands];
  uint32_t outer_sizes[kMaxDims - 1];
  int64_t outer_strides[kMaxOperands][kMaxDims - 1];
  int64_t red_strides[kMaxOperands];
  int64_t red_size;
  uint32_t col_blocks;                     // blocks along a row
};

template <int OP>
__device__ __forceinline__ int64_t apply(const int64_t (&v)[kMaxOperands]) {
  if constexpr (OP == kAdd) {
    return correct(add64(v[0], v[1]), v[2]);
  } else if constexpr (OP == kSub) {
    return correct(sub64(add64(v[0], v[2]), v[1]), v[2]);
  } else if constexpr (OP == kNeg) {
    return v[0] == 0 ? 0 : sub64(v[1], v[0]);
  } else if constexpr (OP == kMul) {
    return barrett(mul64(v[0], v[1]), v[2], v[3], v[4]);
  } else if constexpr (OP == kMulAdd) {
    return correct(add64(barrett(mul64(v[0], v[1]), v[3], v[4], v[5]), v[2]),
                   v[3]);
  } else {
    // Shoup: q = (a w') >> 32, r = a w - q p
    const int64_t q = mul64(v[0], v[2]) >> 32;
    const int64_t r = sub64(mul64(v[0], v[1]), mul64(q, v[3]));
    if constexpr (OP == kShoupLazy) return r;
    if constexpr (OP == kShoup) return correct(r, v[3]);
    return correct(correct(r, v[3]), v[3]);
  }
}

__host__ __device__ constexpr int arity(int op) {
  return op == kNeg ? 2 : op == kAdd || op == kSub ? 3
       : op == kMul ? 5 : op == kMulAdd ? 6 : 4;
}

// Each operand's offset of the first column of this block's row: the row
// index decomposed over the outer dimensions once, in 32 bits (the grid has
// fewer than 2^31 blocks).
__device__ __forceinline__ void row_offsets(const Args& a, uint32_t row,
                                            int64_t (&base)[kMaxOperands]) {
#pragma unroll
  for (int j = 0; j < kMaxOperands; ++j) base[j] = 0;
#pragma unroll
  for (int d = kMaxDims - 2; d >= 0; --d) {
    const uint32_t size = a.outer_sizes[d];
    if (size > 1) {
      const int64_t i = row % size;
      row /= size;
#pragma unroll
      for (int j = 0; j < kMaxOperands; ++j)
        base[j] += i * a.outer_strides[j][d];
    }
  }
}

// K9: out[row, col] = OP(in_0[row, perm ? perm[col] : col], in_1[row, col],
// ...) over the merged [rows..., columns] space.  Block b covers kThreads *
// kPerThread columns of row b / col_blocks; thread t takes columns t, t +
// kThreads, ..., so each load of a warp is 256 contiguous bytes (or one
// broadcast word for a stride-0 operand).
template <int OP>
__global__ void __launch_bounds__(kThreads) rns_map_kernel(const Args a) {
  constexpr int NOPS = arity(OP);
  const uint32_t row = blockIdx.x / a.col_blocks;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x % a.col_blocks) *
                     kColumnsPerBlock + threadIdx.x;
  int64_t base[kMaxOperands];
  row_offsets(a, row, base);
  int64_t* out = a.out + static_cast<int64_t>(row) * a.cols;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int64_t col = c0 + e * kThreads;
    if (col < a.cols) {
      int64_t v[kMaxOperands] = {};
#pragma unroll
      for (int j = 0; j < NOPS; ++j) {
        const int64_t c = j == 0 && a.perm ? __ldg(reinterpret_cast<
            const long long*>(a.perm + col)) : col;
        v[j] = __ldg(reinterpret_cast<const long long*>(
            a.in[j] + base[j] + c * a.col_strides[j]));
      }
      out[col] = apply<OP>(v);
    }
  }
}

// K10: out = _barrett(sum_j _barrett(C_j * w_j)) over the reduction axis j,
// operands (C, w, p, mu, k); p, mu, k do not vary along j.  One thread per
// output word walks j: each word of C and w is read once, the n1 products
// and the [..., n1, 2, k, N] stack the plain form writes stay in registers.
// The int64 sum wraps as PyTorch's does, so it is exact in any order.
__global__ void __launch_bounds__(kThreads) mod_product_sum_kernel(
    const Args a) {
  const uint32_t row = blockIdx.x / a.col_blocks;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x % a.col_blocks) *
                     kColumnsPerBlock + threadIdx.x;
  int64_t base[kMaxOperands];
  row_offsets(a, row, base);
  const int64_t rc = a.red_strides[0], rw = a.red_strides[1];
  int64_t* out = a.out + static_cast<int64_t>(row) * a.cols;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int64_t col = c0 + e * kThreads;
    if (col < a.cols) {
      int64_t v[5];
#pragma unroll
      for (int j = 2; j < 5; ++j)
        v[j] = __ldg(reinterpret_cast<const long long*>(
            a.in[j] + base[j] + col * a.col_strides[j]));
      const int64_t* C = a.in[0] + base[0] + col * a.col_strides[0];
      const int64_t* w = a.in[1] + base[1] + col * a.col_strides[1];
      int64_t acc = 0;
#pragma unroll 4
      for (int64_t j = 0; j < a.red_size; ++j) {
        const int64_t x = __ldg(reinterpret_cast<const long long*>(C + j * rc));
        const int64_t y = __ldg(reinterpret_cast<const long long*>(w + j * rw));
        acc = add64(acc, barrett(mul64(x, y), v[2], v[3], v[4]));
      }
      out[col] = barrett(acc, v[2], v[3], v[4]);
    }
  }
}

// Fills Args from the wrapper's plan (sizes[ndim], the last dimension the
// columns; strides[j * ndim + d]); returns the grid's block count, or 0 where
// the plan is out of range.
unsigned prepare(Args& a, int ndim, int nops, const int64_t* sizes,
                 const int64_t* strides, const void* const* in, void* out,
                 const void* perm) {
  if (ndim < 1 || ndim > kMaxDims || nops < 1 || nops > kMaxOperands)
    return 0;
  const int last = ndim - 1;
  const int shift = (kMaxDims - 1) - last;   // outer dims right-aligned
  int64_t rows = 1;
  for (int d = 0; d < kMaxDims - 1; ++d) {
    const int src = d - shift;
    const int64_t size = src >= 0 ? sizes[src] : 1;
    if (size < 1 || size > 0xffffffffLL) return 0;
    a.outer_sizes[d] = static_cast<uint32_t>(size);
    rows *= size;
    if (rows > 0x7fffffffLL) return 0;
    for (int j = 0; j < kMaxOperands; ++j)
      a.outer_strides[j][d] = src >= 0 && j < nops ? strides[j * ndim + src]
                                                    : 0;
  }
  a.cols = sizes[last];
  if (a.cols < 1) return 0;
  for (int j = 0; j < kMaxOperands; ++j) {
    a.in[j] = j < nops ? static_cast<const int64_t*>(in[j]) : nullptr;
    a.col_strides[j] = j < nops ? strides[j * ndim + last] : 0;
    a.red_strides[j] = 0;
  }
  a.out = static_cast<int64_t*>(out);
  a.perm = static_cast<const int64_t*>(perm);
  a.red_size = 0;
  const int64_t col_blocks = (a.cols + kColumnsPerBlock - 1) /
                             kColumnsPerBlock;
  const int64_t blocks = rows * col_blocks;
  if (blocks > 0x7fffffffLL) return 0;
  a.col_blocks = static_cast<uint32_t>(col_blocks);
  return static_cast<unsigned>(blocks);
}

template <int OP>
cudaError_t launch_map(const Args& a, unsigned blocks, cudaStream_t s) {
  rns_map_kernel<OP><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the launch's CUDA error
// (0 on success); it neither allocates nor synchronises.

// K9: op (the Op codes above) over `nops` operands in[j], each read through
// strides[j * ndim + d] (elements) over sizes[ndim], perm null or an int64
// permutation of the last dimension read for operand 0; out contiguous.
int hectr_rns_map(int op, int ndim, int nops, const int64_t* sizes,
                  const int64_t* strides, const void* in0, const void* in1,
                  const void* in2, const void* in3, const void* in4,
                  const void* in5, void* out, const void* perm,
                  void* stream) {
  if (op < kAdd || op > kMulAdd || nops != arity(op))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* in[kMaxOperands] = {in0, in1, in2, in3, in4, in5};
  Args a;
  const unsigned blocks = prepare(a, ndim, nops, sizes, strides, in, out,
                                  perm);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAdd: return static_cast<int>(launch_map<kAdd>(a, blocks, s));
    case kSub: return static_cast<int>(launch_map<kSub>(a, blocks, s));
    case kNeg: return static_cast<int>(launch_map<kNeg>(a, blocks, s));
    case kMul: return static_cast<int>(launch_map<kMul>(a, blocks, s));
    case kShoup: return static_cast<int>(launch_map<kShoup>(a, blocks, s));
    case kShoupWide:
      return static_cast<int>(launch_map<kShoupWide>(a, blocks, s));
    case kShoupLazy:
      return static_cast<int>(launch_map<kShoupLazy>(a, blocks, s));
    default: return static_cast<int>(launch_map<kMulAdd>(a, blocks, s));
  }
}

// K10: operands (C, w, p, mu, k) read through strides[j * ndim + d] over the
// output's sizes[ndim] and red_strides[j] along the reduction axis of
// red_size; out contiguous over sizes.
int hectr_mod_product_sum(int ndim, const int64_t* sizes,
                          const int64_t* strides, const int64_t* red_strides,
                          int64_t red_size, const void* C, const void* w,
                          const void* p, const void* mu, const void* k,
                          void* out, void* stream) {
  const void* in[kMaxOperands] = {C, w, p, mu, k, nullptr};
  Args a;
  const unsigned blocks = prepare(a, ndim, 5, sizes, strides, in, out,
                                  nullptr);
  if (blocks == 0 || red_size < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < 5; ++j) a.red_strides[j] = red_strides[j];
  if (a.red_strides[2] || a.red_strides[3] || a.red_strides[4])
    return static_cast<int>(cudaErrorInvalidValue);
  a.red_size = red_size;
  mod_product_sum_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* hectr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
