"""Measurements on the card.  Each needs a CUDA device and fails
without one: a time taken on the CPU is not a device time."""

from __future__ import annotations

import subprocess

import torch

# NVIDIA's H100 SXM data sheet: device memory bandwidth
HBM_BYTES_PER_S = 3.35e12
# CUDA Programming Guide, arithmetic instruction throughput, compute
# capability 9.0: 64 32-bit integer multiply(-add)s per clock per SM; a
# lazy Shoup multiply is three of them (IMAD.HI, IMUL, IMAD)
IMAD_PER_CLOCK_PER_SM = 64
IMAD_PER_LAZY_MULT = 3


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps`
    calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_graph_time_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one fn() in ms, without the host's share: `reps`
    calls captured into a CUDA graph (after warm-up calls on a side
    stream), the graph replayed `replays` times between CUDA events.
    fn must launch on the current stream, as the kernels' wrappers do."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0].split()[0]) * 1e6


def lazy_mult_peak_per_s() -> float:
    """Lazy Shoup multiplies per second at the card's integer multiply
    peak: SMs x 64 IMADs per clock x the maximum SM clock / 3."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * IMAD_PER_CLOCK_PER_SM * max_sm_clock_hz() / IMAD_PER_LAZY_MULT


def ntt_bound(rows: int, limbs: int, logn: int, mult_peak: float
              ) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one NTT kernel call over
    `rows` int64 rows of 2^logn on `limbs` primes: each input read once
    (the rows, the limbs' twiddle and companion tables, the primes), each
    output written once, against its N log2 N / 2 lazy Shoup multiplies
    a row at the multiply peak."""
    n = 1 << logn
    nbytes = rows * n * 8 * 2 + limbs * (n * 4 * 2 + 4)
    mults = rows * logn * (n // 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mults / mult_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def encrypt_work(batch: int, limbs: int, logn: int) -> tuple[int, int]:
    """(bytes, lazy multiplies) of one K14 launch (``ops.encrypt_cuda``)
    over `batch` ciphertexts of `limbs` limbs at 2^logn, each input read
    once (the three int64 draws of a batch row, the plaintext's rows, the
    key's two rows a limb, the limbs' twiddle and companion tables and
    primes) and the ciphertext's two rows a limb written once, against three
    forward NTTs a row (N log2 N / 2 lazy multiplies each) and the two key
    products an element (one multiply each)."""
    n = 1 << logn
    words = 3 * batch + batch * limbs + 2 * limbs + 2 * batch * limbs
    nbytes = 8 * n * words + limbs * (n * 4 * 2 + 4)
    mults = batch * limbs * (3 * logn * (n // 2) + 2 * n)
    return nbytes, mults


def encrypt_bound(batch: int, limbs: int, logn: int, mult_peak: float
                  ) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one K14 launch over
    ``encrypt_work``'s bytes and multiplies."""
    nbytes, mults = encrypt_work(batch, limbs, logn)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mults / mult_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def exchange_bound(rows: int, limbs: int, logn: int, D: int, form: str,
                   mult_peak: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one launch of the
    cross-shard exchange kernels K4/K5 over `rows` int64 rows of a ring of
    2^logn on `limbs` primes split into D shards, with ``ntt_bound``'s
    conventions.  form "local": every shard in one tensor, all log2 D
    stages (each element read and written once, the limbs' D - 1
    twiddles and companions and the primes read once; log2 D * N/2 lazy
    multiplies a row).  form "received": one shard's chunk of N/D a row,
    one stage (its own chunk read, the partner's read as the wire's int32
    words, the result written; one twiddle and companion a limb; one
    multiply an element, the most either half of the butterfly does)."""
    n = 1 << logn
    if form == "local":
        nbytes = rows * n * 8 * 2 + limbs * ((D - 1) * 4 * 2 + 4)
        mults = rows * (D.bit_length() - 1) * (n // 2)
    elif form == "received":
        chunk = n // D
        nbytes = rows * chunk * (8 + 4 + 8) + limbs * (4 * 2 + 4)
        mults = rows * chunk
    else:
        raise ValueError(f"form {form!r}: 'local' or 'received'")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mults / mult_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def keyswitch_work(kernel: str, shape, targets: int = 0, key_words: int = 4,
                   perm: bool = False) -> tuple[int, int]:
    """(bytes, lazy multiplies) of one launch of the key-switch kernels
    K6-K8 on an int64 input of `shape`, each input read once (the
    per-row constants included) and each output written once:

      * "base_convert" (K6): x [..., G, A, C] -> [..., G, targets, C]
        (G = 1 for the one-group form, ``ckks.basecvt.base_convert``);
        constants inv, its companion and q [G, A], M and its companion
        [G, A, targets], Qmod and its companion [G, targets], p
        [targets]; A + A * targets + targets multiplies a column and
        group (the float64 correction's A divisions not counted).
      * "key_inner_product" (K7): digits [..., dnum, R, C], the key
        [dnum, key_words, R, C] (4: companions stored, 2: compact) read
        once for every leading row, out [..., 2, R, C], p [R], perm [C]
        if given; 2 multiplies a digit word.
      * "mod_down_tail" (K8): acc and ext [..., R, C] -> [..., R, C],
        P^-1, its companion and p [R]; one multiply an element."""
    *lead, C = shape
    n = 1
    for d in lead:
        n *= d
    if kernel == "base_convert":
        G, A = lead[-2:]
        outer = n // (G * A)
        nbytes = (n * C + outer * G * targets * C + 3 * G * A
                  + 2 * G * A * targets + 2 * G * targets + targets) * 8
        mults = outer * G * C * (A + A * targets + targets)
    elif kernel == "key_inner_product":
        dnum, R = lead[-2:]
        outer = n // (dnum * R)
        nbytes = (n * C + dnum * key_words * R * C + outer * 2 * R * C + R
                  + (C if perm else 0)) * 8
        mults = 2 * n * C
    elif kernel == "mod_down_tail":
        R = lead[-1]
        nbytes = (3 * n * C + 3 * R) * 8
        mults = n * C
    else:
        raise ValueError(f"kernel {kernel!r}: 'base_convert', "
                         f"'key_inner_product' or 'mod_down_tail'")
    return nbytes, mults


def keyswitch_bound(kernel: str, shape, mult_peak: float, targets: int = 0,
                    key_words: int = 4, perm: bool = False
                    ) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one launch of K6-K8 over
    ``keyswitch_work``'s bytes and multiplies, with ``ntt_bound``'s
    conventions."""
    nbytes, mults = keyswitch_work(kernel, shape, targets, key_words, perm)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mults / mult_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def keyswitch_launch_work(key) -> tuple[int, int]:
    """``keyswitch_work`` of one launch counted in
    ``ops.keyswitch_cuda.LAUNCH_SHAPES`` under `key`."""
    kernel, shape, *rest = key
    if kernel == "base_convert":
        return keyswitch_work(kernel, shape, targets=rest[0])
    if kernel == "key_inner_product":
        key_shape, perm = rest
        return keyswitch_work(kernel, shape, key_words=key_shape[1], perm=perm)
    return keyswitch_work(kernel, shape)


# 64-bit multiplies a K9 primitive does per output word, as its formulas
# (ckks/modmath.py) write them: Barrett a*b, (.)*mu, q*p; Shoup a*w',
# a*w, q*p.  K10 does mul_mod's three per product and Barrett's two per
# output word.  A 64-bit multiply is three 32-bit IMADs (IMAD.WIDE.U32 and
# two IMADs for the cross terms).
RNS_MULTIPLIES = {"add_mod": 0, "sub_mod": 0, "neg_mod": 0, "mul_mod": 3,
                  "mul_add_mod": 3, "mul_mod_shoup": 3,
                  "mul_mod_shoup_wide": 3, "mul_mod_shoup_lazy": 3}
IMAD_PER_MUL64 = 3


def imad_peak_per_s() -> float:
    """32-bit integer multiply(-add)s per second at the card's peak: SMs x
    64 IMADs per clock x the maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * IMAD_PER_CLOCK_PER_SM * max_sm_clock_hz()


def rns_work(op: str, in_numels, out_numel: int, products: int = 0
             ) -> tuple[int, int]:
    """(bytes, IMADs) of one launch of K9 (op a key of RNS_MULTIPLIES) or
    K10 (op "mod_product_sum") over int64 operands of `in_numels`
    elements each (an operand's own elements: a broadcast column or a
    shared plaintext is read once) and an output of `out_numel`: each
    input read once, the output written once.  K10's `products` is the
    number of products it sums (output words x the summed dimension)."""
    nbytes = 8 * (sum(in_numels) + out_numel)
    if op == "mod_product_sum":
        mults = 3 * products + 2 * out_numel
    elif op in RNS_MULTIPLIES:
        mults = RNS_MULTIPLIES[op] * out_numel
    else:
        raise ValueError(f"op {op!r}: a K9 primitive or 'mod_product_sum'")
    return nbytes, IMAD_PER_MUL64 * mults


def rns_bound(op: str, in_numels, out_numel: int, imad_peak: float,
              products: int = 0) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one launch of K9 or K10
    over ``rns_work``'s bytes and IMADs, with ``ntt_bound``'s
    conventions (IMADs at `imad_peak` per second)."""
    nbytes, imads = rns_work(op, in_numels, out_numel, products)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / imad_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# NVIDIA's H100 SXM data sheet: float64 outside the tensor cores (an FMA
# counted as two operations; K11/K12 issue no FMA, so this rate is above
# what they could reach)
FP64_FLOP_PER_S = 34e12
SECTOR_BYTES = 32      # what the card reads for a word at a stride


def codec_work(kernel: str, batch: int, rows: int, width: int, n: int = 0,
               fused: bool = False, in_numels=(), col_stride: int = 1,
               digits: bool = False, unembed: bool = False
               ) -> tuple[int, int]:
    """(bytes, float64 operations) of one launch of K11 ("encode_residues")
    or K12 ("crt_decode") over `batch` rows of `width` = 2s coefficients,
    each input read once and each output written once:

      * K11: the data operands' own elements (`in_numels`: re and im [...,
        s], a broadcast zero vector counted once, or m' [..., 2s]), the
        embedding matrices [s, 2s] twice if `fused`, `rows` primes in;
        int64 [batch, rows, n] out.  Operations: the embedding's 2s
        products and 2s sums, a sum and a division a coefficient (fused),
        then the product by the scale, rint and the split's six a
        coefficient and prime.
      * K12: x int64 [batch, rows, width] read at `col_stride` words (a
        32-byte sector a word from a stride of 4 words on), the rows'
        constants (p, and inv, mu, k unless `digits`), the embedding
        matrices if `unembed`; float64 [batch, width] out (y, or re and
        im).  Operations: 35 a word and row (dd_div_ff 24, dd_add 11), 40
        a word (dd_round 5, dd_add_f 10, dd_mul 24, the sum 1), 2 x 2s a
        slot value if `unembed`."""
    if kernel == "encode_residues":
        s = width // 2
        nbytes = 8 * (sum(in_numels) + (2 * s * width if fused else 0) + rows
                      + batch * rows * n)
        flops = batch * width * ((4 * s + 2) if fused else 0) \
            + batch * width * rows * 8
    elif kernel == "crt_decode":
        word = SECTOR_BYTES if col_stride >= SECTOR_BYTES // 8 else 8
        s = width // 2
        nbytes = (batch * rows * width * word
                  + 8 * rows * (1 if digits else 4)
                  + (8 * 2 * s * width if unembed else 0)
                  + 8 * batch * width)
        flops = batch * width * (35 * rows + 40 + (2 * width if unembed
                                                    else 0))
    else:
        raise ValueError(f"kernel {kernel!r}: 'encode_residues' or "
                         f"'crt_decode'")
    return nbytes, flops


def codec_bound(kernel: str, batch: int, rows: int, width: int, **kw
                ) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one launch of K11 or K12 over
    ``codec_work``'s bytes and float64 operations (at FP64_FLOP_PER_S)."""
    nbytes, flops = codec_work(kernel, batch, rows, width, **kw)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
