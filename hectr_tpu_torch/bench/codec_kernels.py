"""K11 and K12 on the card at the shapes the encrypted loops give them.

    python -m hectr_tpu_torch.bench.codec_kernels

K11 (``ops.codec_cuda``: encode's float64 pass) with the embedding fused at
FLAGSHIP (s = 16 slots, 22 rows of 2^15) and over the FLAGSHIP_QP batch of 4
(32 rows, the imaginary parts a zero vector broadcast over the batch, the
QP's compensating scale: a product of two primes), and its m' entry at
MEDIUM's 8192 slots (12 rows of 2^14, after the FFT embedding).  K12 (the
double-double CRT decode) on the two base rows after K2 at the same three
shapes, read through the stride N/2s of ``intt(...)[..., ::N/2s]``
(unembedded in the kernel for 16 slots; for MEDIUM's FFT branch the
values y, the kernel's output, timed without the FFT unembedding that
follows it), on real encodings and on random residues, and its digits
entry (a limb mesh's gathered digits).

Each case is held to its plain version first:

  * K11's m' entry bit-equal to ``encoding.coefficient_rows_plain``; the
    fused entry bit-equal to the plain integer stage of the embedding
    summed in the kernel's order (``embed_in_kernel_order``, elementwise
    float64 operations on the card), and against the plain composition
    (``coefficient_rows_plain`` of ``embed_ri``, whose matrix product sums
    in cuBLAS's order) different only at coefficients whose y differ,
    each by at most one: those are counted.
  * K12's y bit-equal to ``scheme.crt_values_plain`` run on the CPU: on
    the card, PyTorch divides by a CPU scalar through its reciprocal, so
    the plain chain on the card rounds its quotients otherwise than the
    JAX package's IEEE division, which the CPU and the kernel do.  The
    unembedded values bit-equal to ``unembed_in_kernel_order`` of that y,
    and within 1e-12 x max(1, |plain|) of the plain ``unembed``.

Then its device time (``bench.cuda_graph_time_ms``), the plain composition's
time on the card (CUDA events), the bound (``bench.codec_bound``) and the
kernel's share of it, and the dispatching function's host us per call
beside the plain composition's (back to back, host clock).  One JSON line
per case, the card's name and power limit last.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from hectr_tpu_torch.bench import codec_bound, cuda_graph_time_ms, cuda_time_ms

HEADLINE = "flagship"      # the kernels line's case for K11 and K12
UNEMBED_RTOL = 1e-12


def embed_in_kernel_order(vre, vim, ReE, ImE) -> torch.Tensor:
    """embed_ri's matrix branch summed as K11 sums it: for each coefficient
    sum_i ReE[i, j] re_i over i ascending, then the same with ImE, their
    sum over s; every product and sum its own elementwise operation."""
    s = ReE.shape[0]
    sr = torch.zeros((*vre.shape[:-1], 2 * s), dtype=torch.float64,
                     device=vre.device)
    si = torch.zeros_like(sr)
    for i in range(s):
        sr = sr + ReE[i] * vre[..., i, None]
    for i in range(s):
        si = si + ImE[i] * vim[..., i, None]
    return (sr + si) / s


def unembed_in_kernel_order(y, ReE, ImE) -> tuple[torch.Tensor, torch.Tensor]:
    """unembed's matrix branch summed as K12 sums it: sum_j E[i, j] y_j over
    j ascending, each product and sum its own elementwise operation."""
    out = []
    for E in (ReE, ImE):
        acc = torch.zeros((*y.shape[:-1], E.shape[0]), dtype=torch.float64,
                          device=y.device)
        for j in range(E.shape[1]):
            acc = acc + E[:, j] * y[..., j, None]
        out.append(acc)
    return out[0], out[1]


@dataclasses.dataclass
class Case:
    label: str
    kernel: str                 # "encode_residues" or "crt_decode"
    call: object                # the dispatching function, on the card
    plain: object               # the plain composition, on the card
    check: object               # -> (max |kernel - plain|, rounded apart)
    work: dict                  # bench.codec_bound's arguments


def _slots(gen, shape, device, scale=1.0):
    return (torch.rand(shape, generator=gen, dtype=torch.float64,
                       device=device) * 2 - 1) * scale


def _encode_case(label, ctx, vre, vim, k, scale) -> Case:
    from hectr_tpu_torch.ckks import encoding as E

    s, n = ctx.slots, ctx.n
    t = ctx.tables(k, vre.device)
    sc = float(scale)
    fused = s <= E.MATRIX_MAX_SLOTS
    if fused:
        ReE, ImE = E.device_embedding(s, vre.device)

        def call():
            return E.encode_rows(vre, vim, s, sc, t.p, n)

        def plain():
            return E.coefficient_rows_plain(E.embed_ri(vre, vim, s), sc, t.p,
                                            n)

        def check(got):
            m_order = embed_in_kernel_order(vre, vim, ReE, ImE)
            want = E.coefficient_rows_plain(m_order, sc, t.p, n)
            if not torch.equal(got, want):
                raise AssertionError(f"K11 {label}: {int((got != want).sum())}"
                                     f" words differ from the kernel-order "
                                     f"embedding's plain residues")
            y_order = torch.round(m_order * sc)
            y_plain = torch.round(E.embed_ri(vre, vim, s) * sc)
            apart = y_order != y_plain
            err = float((y_order - y_plain).abs().max())
            if err > 1:
                raise AssertionError(f"K11 {label}: y off the plain "
                                     f"composition's by {err}")
            same = plain()[..., ::n // (2 * s)] == got[..., ::n // (2 * s)]
            if not bool(same.all(dim=-2)[~apart].all()):
                raise AssertionError(f"K11 {label}: residues differ where "
                                     f"y agrees")
            return err, int(apart.sum())
        in_numels = [vre.untyped_storage().nbytes() // 8,
                     vim.untyped_storage().nbytes() // 8]
    else:
        m = E.embed_ri(vre, vim, s)

        def call():
            return E.coefficient_rows(m, sc, t.p, n)

        def plain():
            return E.coefficient_rows_plain(m, sc, t.p, n)

        def check(got):
            if not torch.equal(got, plain()):
                raise AssertionError(f"K11 {label}: m' entry != plain")
            return 0.0, 0
        in_numels = [m.numel()]
    batch = vre.numel() // s
    return Case(label, "encode_residues", call, plain, check,
                dict(kernel="encode_residues", batch=batch, rows=k,
                     width=2 * s, n=n, fused=fused, in_numels=in_numels))


def _decode_case(label, ctx, x, scale, digits=False) -> Case:
    """K12 on the base rows x [..., k, N] (coefficient domain, as K2 gives
    them) read at the stride N/2s, or (`digits`) on their digits."""
    from hectr_tpu_torch.ckks import encoding as E
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.modmath import mul_mod_plain
    from hectr_tpu_torch.ops import codec_cuda

    s, n = ctx.slots, ctx.n
    k = x.shape[-2]
    device = x.device
    t = ctx.tables(k, device)
    dc = ctx.decode_constants(k, scale, device)
    xs = x[..., ::n // (2 * s)]
    c = mul_mod_plain(xs, dc.inv, t.p, t.mu, t.k).contiguous()
    unembed = s <= E.MATRIX_MAX_SLOTS
    q = (dc.q_over_scale_hi, dc.q_over_scale_lo)

    if not unembed:
        # the FFT branch: K12 gives y, the FFT unembedding that follows is
        # not the kernel's
        def call():
            return codec_cuda.crt_decode(xs, t.p, *q, (dc.inv, t.mu, t.k))

        def plain():
            return S.crt_values_plain(
                mul_mod_plain(xs, dc.inv, t.p, t.mu, t.k), dc)
    elif digits:
        def call():
            return S.crt_decode(ctx, c, dc)

        def plain():
            return S.crt_decode_plain(ctx, c, dc)
    else:
        def call():
            return S._crt_decode_card(ctx, xs, t.p, dc, (dc.inv, t.mu, t.k))

        def plain():
            return S.crt_decode_plain(
                ctx, mul_mod_plain(xs, dc.inv, t.p, t.mu, t.k), dc)

    def check(got):
        y_cpu = S.crt_values_plain(c.cpu(), dc)
        y = codec_cuda.crt_decode(c if digits else xs, t.p, *q,
                                  None if digits else (dc.inv, t.mu, t.k))
        if not torch.equal(y.cpu(), y_cpu):
            raise AssertionError(f"K12 {label}: y differs from the plain "
                                 f"chain in {int((y.cpu() != y_cpu).sum())} "
                                 f"words")
        if not unembed:
            return 0.0, 0
        ReE, ImE = E.device_embedding(s, device)
        err = 0.0
        for g, o, w in zip(got, unembed_in_kernel_order(y_cpu.to(device),
                                                         ReE, ImE),
                           plain()):
            if not torch.equal(g, o):
                raise AssertionError(f"K12 {label}: unembedding differs from "
                                     f"the kernel-order sum")
            d = (g - w).abs()
            if bool((d > UNEMBED_RTOL * w.abs().clamp(min=1)).any()):
                raise AssertionError(f"K12 {label}: unembedded values off "
                                     f"the plain ones by {float(d.max())}")
            err = max(err, float(d.max()))
        return err, 0

    return Case(label, "crt_decode", call, plain, check,
                dict(kernel="crt_decode", batch=xs.numel() // (k * 2 * s),
                     rows=k, width=2 * s, col_stride=xs.stride(-1),
                     digits=digits, unembed=unembed))


def cases(device, gen) -> list[Case]:
    """Every case, its operands made on `device`."""
    from hectr_tpu_torch import config
    from hectr_tpu_torch.bench.keyswitch_kernels import _residues
    from hectr_tpu_torch.ckks import encoding as E
    from hectr_tpu_torch.ckks.context import make_context

    flag = make_context(config.FLAGSHIP)
    qp = make_context(config.FLAGSHIP_QP)
    medium = make_context(config.MEDIUM)
    out = []

    # encode: the regulators' shapes
    vre = _slots(gen, (flag.slots,), device)
    zeros = torch.zeros(flag.slots, dtype=torch.float64, device=device)
    out.append(_encode_case("flagship", flag, vre, zeros, flag.max_limbs,
                            flag.delta))
    vre4 = _slots(gen, (4, qp.slots), device, 3.0)
    out.append(_encode_case("flagship-qp batch of 4", qp, vre4,
                            zeros.expand(4, -1), qp.max_limbs,
                            qp.pair_scale(qp.max_limbs)))
    vre_m = _slots(gen, (medium.slots,), device, 5.0)
    vim_m = _slots(gen, (medium.slots,), device, 5.0)
    out.append(_encode_case("medium m'", medium, vre_m, vim_m,
                            medium.max_limbs, medium.delta))

    # decode: the base rows of encodings, and random residues
    kb = len(flag.base_primes)
    pb = flag.tables(kb, device).p
    x = E.coefficient_rows_plain(E.embed_ri(vre, zeros, flag.slots),
                                 float(flag.delta), pb, flag.n)
    out.append(_decode_case("flagship", flag, x, flag.delta))
    out.append(_decode_case("flagship random residues", flag,
                            _residues(flag.base_primes, (), flag.n, gen,
                                      device), flag.delta))
    out.append(_decode_case("flagship digits", flag, x, flag.delta,
                            digits=True))
    x4 = E.coefficient_rows_plain(E.embed_ri(vre4, zeros.expand(4, -1),
                                             qp.slots),
                                  float(qp.delta), qp.tables(kb, device).p,
                                  qp.n)
    out.append(_decode_case("flagship-qp batch of 4", qp, x4, qp.delta))
    xm = E.coefficient_rows_plain(E.embed_ri(vre_m, vim_m, medium.slots),
                                  float(medium.delta),
                                  medium.tables(kb, device).p, medium.n)
    out.append(_decode_case("medium", medium, xm, medium.delta))
    return out


def check(device) -> dict:
    """Every case against its plain version (raises on a difference the
    module docstring does not allow): for K11 ("encode_residues") the
    largest |y - y_plain| and the coefficients rounded apart from the plain
    composition, for K12 ("crt_decode") the largest |kernel - plain| of
    the unembedded values."""
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    err = {"encode_residues": 0.0, "crt_decode": 0.0}
    apart = 0
    for case in cases(device, gen):
        e, a = case.check(case.call())
        torch.cuda.synchronize(device)
        err[case.kernel] = max(err[case.kernel], e)
        apart += a
    return {"max_abs_err": err, "rounded_apart": apart}


def _host_us(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def measure(device, calls: int = 100) -> list[dict]:
    """Each case held to its plain version, then its device ms beside the
    bound and the plain composition's ms, and the host us a call of the
    dispatching function and of the plain composition."""
    gen = torch.Generator(device=device)
    gen.manual_seed(18)
    out = []
    for case in cases(device, gen):
        err, apart = case.check(case.call())
        bound, by = codec_bound(**case.work)
        ms = cuda_graph_time_ms(case.call)
        out.append({"case": case.label, "kernel": case.kernel, "ms": ms,
                    "plain_ms": cuda_time_ms(case.plain, reps=5),
                    "bound_ms": bound, "bound_by": by,
                    "share_of_bound": bound / ms, "max_abs_err": err,
                    "rounded_apart": apart,
                    "host_us": _host_us(case.call, calls),
                    "plain_host_us": _host_us(case.plain, calls // 10)})
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: the kernels run on the card")
    from hectr_tpu_torch.bench.ntt_kernels import card_line

    device = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps(check(device)))
    for rec in measure(device):
        print(json.dumps(rec))
    print(card_line())


if __name__ == "__main__":
    main()
