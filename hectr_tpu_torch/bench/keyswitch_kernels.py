"""K6-K8 on the card at the shapes the encrypted loops give them.

    python -m hectr_tpu_torch.bench.keyswitch_kernels

For each case (a preset's level, its leading rows, its key layout, the
columns of a coefficient-mesh rank or the rows of a limb shard) and each
kernel: the kernel held bit-equal to its plain version on residues with 0
and p - 1 planted, its device time (``bench.cuda_graph_time_ms``: launches
replayed from a CUDA graph, so the wrappers' host time is left out), the
plain version's time (CUDA events), the bound (``bench.keyswitch_bound``)
and the kernel's share of it.  K7 is taken without and with a Galois
permutation, and beside it the permuted digits materialised by
``index_select`` and then K7 without one (what the hoisted rotations did
before the kernel read the permutation).  One JSON line per case and
kernel, the card's name and power limit last.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import torch

from hectr_tpu_torch.bench import (cuda_graph_time_ms, cuda_time_ms,
                                   keyswitch_bound, lazy_mult_peak_per_s)


@dataclasses.dataclass(frozen=True)
class Case:
    label: str
    preset: str             # a name in hectr_tpu_torch.config
    drop: int               # data limbs below the top level
    lead: tuple             # leading rows (batched loops)
    compact: bool           # the key layout without Shoup companions
    shards: int = 1         # a coefficient-mesh rank's columns: N / shards
    limb: tuple | None = None   # (D, s): limb shard s of D's rows


# The key switches of the loops: REFERENCE_HEMPC (alpha = 1, one special)
# alone and over the batch phase's 64 loops; FLAGSHIP at the top level
# (the headline), one limb below it (an odd k: the last digit group
# truncated), over 4 loops; FLAGSHIP_QP's compact keys at the top level and
# an odd level over 4 loops; MEDIUM's compact keys; FLAGSHIP on a
# coefficient-mesh rank of 4 and on limb shard 1 of 2 over 4 loops.
CASES = (
    Case("reference", "REFERENCE_HEMPC", 0, (), False),
    Case("reference batch of 64", "REFERENCE_HEMPC", 0, (64,), False),
    Case("flagship", "FLAGSHIP", 0, (), False),
    Case("flagship odd level", "FLAGSHIP", 1, (), False),
    Case("flagship batch of 4", "FLAGSHIP", 0, (4,), False),
    Case("flagship-qp", "FLAGSHIP_QP", 0, (), True),
    Case("flagship-qp odd level, batch of 4", "FLAGSHIP_QP", 1, (4,), True),
    Case("medium", "MEDIUM", 0, (), True),
    Case("flagship coefficient rank of 4", "FLAGSHIP", 0, (), False,
         shards=4),
    Case("flagship limb shard 1 of 2, batch of 4", "FLAGSHIP", 0, (4,),
         False, limb=(2, 1)),
)
HEADLINE = "flagship"     # the kernels line's case


def _residues(primes, lead, n, gen, device):
    """Uniform residues [*lead, len(primes), n], 0 and p - 1 planted in
    columns 0 and 1 of every row."""
    p = torch.tensor(primes, dtype=torch.int64, device=device).reshape(-1, 1)
    a = (torch.rand((*lead, len(primes), n), generator=gen, device=device,
                    dtype=torch.float64) * p).to(torch.int64)
    a[..., 0] = 0
    a[..., 1] = p[:, 0] - 1
    return torch.minimum(a, p - 1)


def inputs(case: Case, device, gen) -> dict:
    """Every kernel's operands at this case, with its plain function and
    its wrapper's dispatching function: name -> (kernel call, plain call,
    ``keyswitch_bound`` arguments)."""
    from hectr_tpu_torch import config
    from hectr_tpu_torch.ckks import basecvt as BC
    from hectr_tpu_torch.ckks import keyswitch as K
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.ntt import ntt_tables
    from hectr_tpu_torch.parallel import LimbRows

    ctx = make_context(getattr(config, case.preset))
    k = ctx.max_limbs - case.drop
    S = len(ctx.special_primes)
    n = ctx.n // case.shards
    data, special = ctx.data_primes[:k], ctx.special_primes
    rows = slice(0, k)
    if case.limb is not None:
        D, s = case.limb
        lr = LimbRows(ctx.max_limbs, S, D)
        rows = slice(*lr.data_rows(s, k))
        data = ctx.data_primes[rows]
        special = ctx.special_primes[slice(*lr.special_rows(s))]
    dnum, alpha = ctx.dnum(k), ctx.alpha
    lead = case.lead

    # K6, ModUp: the data chain's digit groups (dummy rows zero)
    x = _residues(ctx.data_primes[:k], lead, n, gen, device)
    if dnum * alpha > k:
        x = torch.cat([x, x.new_zeros((*lead, dnum * alpha - k, n))], -2)
    grouped = x.unflatten(-2, (dnum, alpha))
    gc = BC.grouped_conv_constants(ctx.digit_groups(k), data + special,
                                   device)
    # K6, mod-down: both components' special rows to the data rows
    last = _residues(ctx.special_primes, lead + (2,), n, gen, device)
    bc = BC.base_conv_constants(ctx.special_primes, data, device)
    # K6, rescale: both components' last data row to the rows below it
    top = _residues(ctx.data_primes[k - 1:k], lead + (2,), n, gen, device)
    rc = BC.base_conv_constants(ctx.data_primes[k - 1:k],
                                ctx.data_primes[:k - 1], device)
    # K7: the digits and a random key over this case's rows
    R = len(data) + len(special)
    t = ntt_tables(ctx.n, data + special, device)
    digits = _residues(t.primes, lead + (dnum,), n, gen, device)
    ba = _residues(t.primes, (dnum, 2), n, gen, device)
    key = ba if case.compact else torch.cat(
        [ba, torch.div(ba << 32, t.p, rounding_mode="floor")], dim=1)
    words = key.shape[1]
    # K8: the data rows of the extended result against the converted
    # special rows
    acc = _residues(t.primes, lead + (2,), n, gen, device)
    ext = _residues(data, lead + (2,), n, gen, device)
    pinv, pinv_sh = (c[rows] for c in K._ks_constants(ctx, k, device))
    p = ntt_tables(ctx.n, data, device).p
    acc_k = acc[..., :len(data), :]

    out = {
        "base_convert": (
            lambda: BC.grouped_convert(grouped, gc),
            lambda: BC.grouped_convert_plain(grouped, gc),
            dict(shape=tuple(grouped.shape), targets=R)),
        "base_convert mod-down": (
            lambda: BC.base_convert(last, bc),
            lambda: BC.base_convert_plain(last, bc),
            dict(shape=tuple(last.shape[:-2]) + (1, S, n), targets=len(data))),
        "base_convert rescale": (
            lambda: BC.base_convert(top, rc),
            lambda: BC.base_convert_plain(top, rc),
            dict(shape=tuple(top.shape[:-2]) + (1, 1, n), targets=k - 1)),
        "key_inner_product": (
            lambda: K.key_inner_product(digits, key, t),
            lambda: K.key_inner_product_plain(digits, key, t),
            dict(shape=tuple(digits.shape), key_words=words)),
        "mod_down_tail": (
            lambda: K.mod_down_tail(acc_k, ext, pinv, pinv_sh, p),
            lambda: K.mod_down_tail_plain(acc_k, ext, pinv, pinv_sh, p),
            dict(shape=tuple(ext.shape))),
    }
    if case.shards == 1 and case.limb is None:
        perm = K.permutation(ctx.n, K.galois_element(1, ctx.n), device)
        out["key_inner_product perm"] = (
            lambda: K.key_inner_product(digits, key, t, perm),
            lambda: K.key_inner_product_plain(digits.index_select(-1, perm),
                                              key, t),
            dict(shape=tuple(digits.shape), key_words=words, perm=True))
        out["index_select + key_inner_product"] = (
            lambda: K.key_inner_product(digits.index_select(-1, perm), key,
                                        t),
            None, dict(shape=tuple(digits.shape), key_words=words))
    return out


def kernel_of(name: str) -> str:
    """The LAUNCHES name of a row of ``inputs``."""
    return next(k for k in ("base_convert", "key_inner_product",
                            "mod_down_tail") if k in name)


def check(device, cases=CASES) -> dict:
    """Every kernel at every case against its plain version: the largest
    |kernel - plain| by kernel name; raises on any difference."""
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    err = {"base_convert": 0, "key_inner_product": 0, "mod_down_tail": 0}
    for case in cases:
        for name, (kernel, plain, _) in inputs(case, device, gen).items():
            if plain is None:
                continue
            got, want = kernel(), plain()
            torch.cuda.synchronize(device)
            e = int((got - want).abs().max())
            err[kernel_of(name)] = max(err[kernel_of(name)], e)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} != plain at {case.label}: "
                                     f"max |kernel - plain| {e}")
    return err


def measure(device, cases=CASES) -> list[dict]:
    """Device ms of each kernel at each case beside its bound and the
    plain version's ms, each held bit-equal to plain first."""
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    peak = lazy_mult_peak_per_s()
    out = []
    for case in cases:
        for name, (kernel, plain, work) in inputs(case, device, gen).items():
            if plain is not None and not torch.equal(kernel(), plain()):
                raise AssertionError(f"{name} != plain at {case.label}")
            kw = dict(work)
            shape = kw.pop("shape")
            bound, by = keyswitch_bound(kernel_of(name), shape, peak, **kw)
            ms = cuda_graph_time_ms(kernel)
            out.append({
                "case": case.label, "kernel": name, "shape": list(shape),
                "ms": ms, "plain_ms": (cuda_time_ms(plain, reps=5)
                                       if plain is not None else None),
                "bound_ms": bound, "bound_by": by,
                "share_of_bound": bound / ms})
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: the kernels run on the card")
    from hectr_tpu_torch.bench.ntt_kernels import card_line

    device = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"max_abs_err": check(device)}))
    for rec in measure(device):
        print(json.dumps(rec))
    print(card_line())


if __name__ == "__main__":
    main()
