"""K9 and K10 on the card at the shapes the encrypted loops give them.

    python -m hectr_tpu_torch.bench.rns_kernels

K9 (``ops.rns_cuda.rns_map``) in every primitive of ``ckks.modmath`` at
FLAGSHIP's [2, 22, 2^15] and at the smoke's FLAGSHIP_QP batch [4, 2, 32,
2^15], its operands as the paths pass them: non-contiguous halves of a
ciphertext (``ct.data[..., 0, :, :]``), a plaintext or the first rows of a
key shared by the batch, the [R, 1] prime and constant columns, a gadget
[dnum, lf, 1], the permuted form of the rotations.  Then on operands
outside the documented domain (every int64 word random): the arithmetic
is the plain version's, so it is bit-equal there too.  K10
(``ops.rns_cuda.mod_product_sum``) at FLAGSHIP's n1 = 4, over the
FLAGSHIP_QP batch of 4 and at MEDIUM's dense n1 = 91.

For each: the kernel held bit-equal to its plain version (residues 0 and
p - 1 planted), its device time (``bench.cuda_graph_time_ms``: launches
replayed from a CUDA graph, so the wrappers' host time is left out), the
plain version's time (CUDA events), the bound (``bench.rns_bound``) and
the kernel's share of it.  ``host_costs`` times the dispatching function's
host work per call beside the plain composition's and counts the aten
kernels that composition launches.  One JSON line per case, the card's
name and power limit last.
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch

from hectr_tpu_torch.bench import (cuda_graph_time_ms, cuda_time_ms,
                                   imad_peak_per_s, rns_bound)
from hectr_tpu_torch.bench.keyswitch_kernels import _residues

HEADLINE = ("flagship", "mul_mod")          # the kernels line's K9 case
SUM_HEADLINE = "flagship n1 = 4"            # ... and K10's


def _shoup(w, p):
    return torch.div(w << 32, p, rounding_mode="floor")


def _map_cases(ctx, k, lead, halves, device, gen):
    """Every K9 primitive at level k of ctx: on ciphertexts [*lead, 2, k,
    N] and on the halves c0, c1 = ct.data[..., 0 or 1, :, :] of `halves`
    ciphertexts (non-contiguous [halves, k, N]): name -> (primitive,
    operands, perm)."""
    from hectr_tpu_torch.ckks import keyswitch as K

    t = ctx.tables(k, device)
    n = ctx.n
    primes = ctx.data_primes[:k]
    ct = _residues(primes, lead + (2,), n, gen, device)      # [..., 2, k, N]
    other = _residues(primes, lead + (2,), n, gen, device)
    pt = _residues(primes, (), n, gen, device)               # shared [k, N]
    sk = _residues(ctx.full_primes, (), n, gen, device)[:k]  # first k rows
    src = _residues(primes, (halves, 2), n, gen, device)
    c0, c1 = src[..., 0, :, :], src[..., 1, :, :]            # non-contiguous
    e = _residues(primes, (halves,), n, gen, device)
    perm = K.permutation(n, K.galois_element(1, n), device)
    pt_sh = _shoup(pt, t.p)
    return {
        "add_mod": ("add_mod", (ct, other, t.p), None),
        "add_mod perm": ("add_mod", (c0, e, t.p), perm),
        "sub_mod": ("sub_mod", (ct, other, t.p), None),
        "neg_mod": ("neg_mod", (ct, t.p), None),
        "mul_mod": ("mul_mod", (c1, sk, t.p, t.mu, t.k), None),
        "mul_add_mod": ("mul_add_mod", (c1, sk, c0, t.p, t.mu, t.k), None),
        "mul_mod_shoup": ("mul_mod_shoup", (ct, pt, pt_sh, t.p), None),
        "mul_mod_shoup_wide": ("mul_mod_shoup_wide", (c0, pt, pt_sh, t.p),
                               None),
        "mul_mod_shoup_lazy": ("mul_mod_shoup_lazy", (c0, pt, pt_sh, t.p),
                               None),
    }


def _gadget_case(ctx, device, gen):
    """The switching key's gadget term: s' [lf, N] against [dnum, lf, 1]."""
    from hectr_tpu_torch.ckks.keyswitch import _gadget_np
    from hectr_tpu_torch.ckks.modmath import i64

    t = ctx.tables_ks(ctx.max_limbs, device)
    s = _residues(t.primes, (), ctx.n, gen, device)
    gad = i64(_gadget_np(ctx), device)
    return {"mul_mod gadget": ("mul_mod", (s[None], gad, t.p, t.mu, t.k),
                               None)}


def _wild_cases(device, gen, n=1 << 15, rows=22):
    """Every primitive on int64 words drawn from the whole range (the
    constants too, k from 2 to 30): outside every domain, where only the
    same arithmetic agrees."""
    def words(*shape):
        return torch.randint(-2 ** 63, 2 ** 63 - 1, shape, generator=gen,
                             device=device, dtype=torch.int64)

    a, b, c = words(2, rows, n), words(2, rows, n), words(2, rows, n)
    p, mu, w, ws = (words(rows, 1) for _ in range(4))
    k = torch.randint(2, 31, (rows, 1), generator=gen, device=device)
    return {
        "add_mod wild": ("add_mod", (a, b, p), None),
        "sub_mod wild": ("sub_mod", (a, b, p), None),
        "neg_mod wild": ("neg_mod", (a, p), None),
        "mul_mod wild": ("mul_mod", (a, b, p, mu, k), None),
        "mul_add_mod wild": ("mul_add_mod", (a, b, c, p, mu, k), None),
        "mul_mod_shoup wild": ("mul_mod_shoup", (a, w, ws, p), None),
        "mul_mod_shoup_wide wild": ("mul_mod_shoup_wide", (a, w, ws, p),
                                    None),
        "mul_mod_shoup_lazy wild": ("mul_mod_shoup_lazy", (a, w, ws, p),
                                    None),
    }


def _sum_case(ctx, k, n1, lead, device, gen):
    """The BSGS group sum: C [*lead, n1, 2, k, N] against a group's
    plaintexts [n1, k, N]."""
    t = ctx.tables(k, device)
    primes = ctx.data_primes[:k]
    C = _residues(primes, lead + (n1, 2), ctx.n, gen, device)
    pts = _residues(primes, (n1,), ctx.n, gen, device)
    return C, pts[:, None], t


def cases(device, gen) -> list[tuple]:
    """(case label, row name, kernel call, plain call, rns_bound
    arguments) at every case, operands made on `device`."""
    from hectr_tpu_torch import config
    from hectr_tpu_torch.ckks import modmath as MM
    from hectr_tpu_torch.ckks.context import make_context

    out = []

    def add_map(label, table):
        for name, (op, operands, perm) in table.items():
            fn = getattr(MM, "add_mod_perm" if perm is not None else op)
            plain = getattr(MM, ("add_mod_perm" if perm is not None else op)
                            + "_plain")
            args = ((operands[0], perm, *operands[1:]) if perm is not None
                    else operands)
            shape = torch.broadcast_shapes(*(x.shape for x in operands))
            out.append((label, name, lambda f=fn, a=args: f(*a),
                        lambda f=plain, a=args: f(*a),
                        dict(op=op, in_numels=[x.numel() for x in args],
                             out_numel=math.prod(shape))))

    flag = make_context(config.FLAGSHIP)
    qp = make_context(config.FLAGSHIP_QP)
    add_map("flagship", _map_cases(flag, flag.max_limbs, (), 2, device,
                                   gen))
    add_map("flagship", _gadget_case(flag, device, gen))
    add_map("flagship-qp batch of 4", _map_cases(qp, qp.max_limbs, (4,), 4,
                                                 device, gen))
    add_map("wild words", _wild_cases(device, gen))

    medium = make_context(config.MEDIUM)
    for label, ctx, n1, lead in (("flagship n1 = 4", flag, 4, ()),
                                 ("flagship-qp batch of 4, n1 = 4", qp, 4,
                                  (4,)),
                                 ("medium n1 = 91", medium, 91, ())):
        k = ctx.max_limbs
        C, w, t = _sum_case(ctx, k, n1, lead, device, gen)
        out_numel = C.numel() // n1
        out.append((label, "mod_product_sum",
                    lambda C=C, w=w, t=t: MM.mod_product_sum(
                        C, w, -4, t.p, t.mu, t.k),
                    lambda C=C, w=w, t=t: MM.mod_product_sum_plain(
                        C, w, -4, t.p, t.mu, t.k),
                    dict(op="mod_product_sum",
                         in_numels=[C.numel(), w.numel()] + [k] * 3,
                         out_numel=out_numel, products=C.numel())))
    return out


def check(device) -> dict:
    """Every case against its plain version: the largest |kernel - plain|
    for K9 ("rns_map") and K10 ("mod_product_sum"); raises on any
    difference."""
    gen = torch.Generator(device=device)
    gen.manual_seed(14)
    err = {"rns_map": 0, "mod_product_sum": 0}
    for label, name, kernel, plain, _ in cases(device, gen):
        got, want = kernel(), plain()
        torch.cuda.synchronize(device)
        key = "mod_product_sum" if name == "mod_product_sum" else "rns_map"
        if not torch.equal(got, want):
            raise AssertionError(f"{name} != plain at {label}: "
                                 f"{int((got != want).sum())} words differ")
        err[key] = max(err[key], int((got - want).abs().max()))
    return err


def measure(device) -> list[dict]:
    """Device ms of each case beside its bound and the plain version's
    ms, each held bit-equal to plain first."""
    gen = torch.Generator(device=device)
    gen.manual_seed(15)
    peak = imad_peak_per_s()
    out = []
    for label, name, kernel, plain, work in cases(device, gen):
        if not torch.equal(kernel(), plain()):
            raise AssertionError(f"{name} != plain at {label}")
        kw = dict(work)
        bound, by = rns_bound(kw.pop("op"), kw.pop("in_numels"),
                              kw.pop("out_numel"), peak, **kw)
        ms = cuda_graph_time_ms(kernel)
        out.append({"case": label, "kernel": name, "ms": ms,
                    "plain_ms": cuda_time_ms(plain, reps=5),
                    "bound_ms": bound, "bound_by": by,
                    "share_of_bound": bound / ms})
    return out


def aten_launches(fn) -> int:
    """The aten operators fn() runs (each a kernel launch of its own for
    the plain compositions on the card), counted on the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def host_costs(device, calls: int = 200) -> list[dict]:
    """Host us per call of each K9 primitive through its dispatching
    function (``ckks.modmath``) at FLAGSHIP's [2, 22, 2^15], beside the
    plain composition's host us and its aten launches: calls enqueued
    back to back (`calls` of the kernel, fewer of the plain composition:
    at most `calls` launches in all, fewer than the launch queue holds),
    the host clock stopped before the synchronize."""
    gen = torch.Generator(device=device)
    gen.manual_seed(16)
    out = []
    for label, name, kernel, plain, _ in cases(device, gen):
        if label != "flagship":
            continue
        launches = aten_launches(plain)
        row = {"kernel": name, "plain_aten_launches": launches}
        for key, fn, n in (("host_us", kernel, calls),
                           ("plain_host_us", plain, max(10, calls // launches))):
            fn()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            row[key] = (time.perf_counter() - t0) / n * 1e6
            torch.cuda.synchronize(device)
        out.append(row)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: the kernels run on the card")
    from hectr_tpu_torch.bench.ntt_kernels import card_line

    device = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"max_abs_err": check(device)}))
    for rec in measure(device):
        print(json.dumps(rec))
    for rec in host_costs(device):
        print(json.dumps(rec))
    print(card_line())


if __name__ == "__main__":
    main()
