"""What surrounds the CUDA NTT kernels (csrc/ntt.cu), on the CPU.

The launch geometry (``ops.ntt_cuda.geometry``) is pure Python and is
held to the card's limits here.  The kernels' pass schedule is modelled
in numpy, index for index as the CUDA code computes it (which elements a
thread holds in each pass, which CTA's shared memory and which swizzled
word each lands in, which twiddle each butterfly takes, the lazy [0, 2p)
arithmetic), and the model is held bit-equal to ``ntt_plain`` /
``intt_plain`` for every cluster size the kernels accept.  Index errors
show up here before a chip run.
"""

import numpy as np
import pytest
import torch

from hectr_tpu_torch.ckks import ntt as T
from hectr_tpu_torch.ckks.primes import find_ntt_primes
from hectr_tpu_torch.ops import ntt_cuda as K

CPU = torch.device("cpu")
ROW_COUNTS = (1, 3, 4, 22, 44, 264, 544)
M32 = np.uint64(0xFFFFFFFF)


def swz(a):
    h = (a >> 5) & 31
    return a ^ h ^ ((h << 1) & 24)


# ---- the geometry ---------------------------------------------------------


@pytest.mark.parametrize("logn", range(1, 16))
def test_geometry_within_card_limits(logn):
    for rows in ROW_COUNTS:
        g = K.geometry(rows, logn)
        assert g.logn == logn and g.passes == K.pass_widths(logn)
        assert sum(g.passes) == logn
        assert all(1 <= r <= K.MAX_PASS_BITS for r in g.passes)
        assert g.smem == 4 << (logn - g.logc) <= K.SMEM_LIMIT
        assert 32 <= g.threads <= min(1024, K.MAX_THREADS)
        assert g.threads % 32 == 0
        assert g.grid(rows) % g.cluster == 0
        assert g.grid(rows) // g.cluster == rows
        assert g.cluster <= 8
        assert g.smem <= 64 * 1024          # two CTAs an SM
        if g.cluster > 1:
            assert g.logc <= g.passes[0] and logn - g.passes[0] - 1 >= g.logc
        # the plan packs the widths, 4 bits each, first pass lowest
        assert [(g.plan >> (4 * j)) & 15 for j in range(len(g.passes))] == \
            list(g.passes)
        assert g.plan >> (4 * len(g.passes)) == 0


def test_geometry_covers_the_sms_on_sub_wave_launches():
    """The cluster is a function of (rows, logN): a launch gets more CTAs
    than two for each SM where the ring allows, so few rows get 8 CTAs a
    row, MEDIUM's digit stack 4 and the FLAGSHIP digit stack 2 (of 256
    threads, two CTAs an SM).  A 2^15 row takes 2 CTAs of 64 KB however
    many rows there are (FLAGSHIP_QP's stacks of 364 and 544 rows)."""
    g = K.geometry(264, 15)
    assert (g.cluster, g.threads, g.passes, g.columns) == (2, 256, (5, 5, 5), 1)
    for rows in (4, 22, 44):
        assert K.geometry(rows, 15).cluster == 8
    assert K.geometry(84, 14).cluster == 4
    assert K.geometry(20, 12).cluster == 8
    for rows in (364, 544, 600):
        g = K.geometry(rows, 15)
        assert (g.cluster, g.threads, g.smem) == (2, 256, 64 * 1024)
    assert K.geometry(600, 14).cluster == 1
    for logn in range(1, 9):
        assert K.geometry(1, logn).cluster == 1


@pytest.mark.parametrize("logn", range(1, 16))
def test_every_pass_meets_distinct_banks(logn):
    """Each warp's shared-memory access in a local pass, and in the copy
    between device and shared memory, hits 32 distinct banks."""
    for logc in range(K.max_log_cluster(logn) + 1):
        g = K.launch_geometry(logn, logc)
        slice_log = logn - logc
        lo = logn - g.passes[0]
        for R in g.passes[1:]:
            lo -= R
            q = np.arange(min(32, 1 << (slice_log - R)))
            at = ((q >> lo) << (lo + R)) | (q & ((1 << lo) - 1))
            for v in range(1 << R):
                banks = swz(at + (v << lo)) % 32
                assert len(set(banks)) == len(q), (logn, logc, R, v)
        q = np.arange(min(32, 1 << (slice_log - 1)))
        for c in (0, 1):
            assert len(set(swz(2 * q + c) % 32)) == len(q)


def test_launch_geometry_refuses_what_the_kernel_refuses():
    with pytest.raises(ValueError):
        K.launch_geometry(16, 0)
    with pytest.raises(ValueError):
        K.launch_geometry(4, 1)            # one pass: no cluster
    with pytest.raises(ValueError):
        K.launch_geometry(15, 4)


# ---- a numpy model of the kernels' schedule --------------------------------


class Lazy:
    """The lazy arithmetic of csrc/modmath.cuh on uint64 arrays, with
    its range held at every step."""

    def __init__(self, p):
        self.p = np.uint64(p)
        self.p2 = np.uint64(2 * p)

    def check(self, x):
        assert (x < self.p2).all()
        return x

    def mul(self, a, w, wsh):
        assert (a < 2**32).all()
        q = (a * wsh) >> np.uint64(32)
        return self.check((a * w - q * self.p) & M32)

    def add(self, a, b):
        s = a + b
        assert (s < 2**32).all()
        return self.check(np.where(s >= self.p2, s - self.p2, s))

    def sub(self, a, b):
        d = a + self.p2 - b
        assert (d < 2**32).all()
        return self.check(np.where(d >= self.p2, d - self.p2, d))


def ct_stages(x, idx, w, wsh, base, R, hb, ar, used):
    """ntt_passes.cuh::ct_stages on lists of arrays x[v] (element v of each
    thread's column), idx[v] their row indices."""
    for S in range(R):
        half = 1 << (R - 1 - S)
        for g in range(1 << S):
            tw = (base << S) + g
            for j in range(half):
                iu, iv = g * 2 * half + j, g * 2 * half + j + half
                used.update(zip([hb + S] * len(tw), idx[iu].tolist(),
                                idx[iv].tolist(), tw.tolist()))
                t = ar.mul(x[iv], w[tw], wsh[tw])
                u = x[iu]
                x[iu], x[iv] = ar.add(u, t), ar.sub(u, t)


def gs_stages(x, idx, w, wsh, base, R, lo, ar, used):
    """ntt_passes.cuh::gs_stages, numbered as ct_stages."""
    for S in range(R):
        half = 1 << S
        for g in range(1 << (R - 1 - S)):
            tw = (base << (R - 1 - S)) + g
            for j in range(half):
                iu, iv = g * 2 * half + j, g * 2 * half + j + half
                used.update(zip([lo + S] * len(tw), idx[iu].tolist(),
                                idx[iv].tolist(), tw.tolist()))
                u, v = x[iu], x[iv]
                x[iu] = ar.add(u, v)
                x[iv] = ar.mul(u + ar.p2 - v, w[tw], wsh[tw])


def columns(g, rank):
    """The first / last pass's columns l of CTA `rank` (g.columns per
    thread)."""
    lo = g.logn - g.passes[0]
    V = g.columns
    per_cta = ((1 << lo) // V) >> g.logc
    q = np.arange(per_cta)
    return [V * (rank * per_cta + q) + c for c in range(V)]


def local_items(logn, logc, R, lo, rank):
    """(row index of element v of each item, twiddle base) of a local
    pass over index bits [lo, lo + R) of CTA `rank`."""
    slice_log = logn - logc
    hb = logn - lo - R
    q = np.arange(1 << (slice_log - R))
    at = ((q >> lo) << (lo + R)) | (q & ((1 << lo) - 1))
    base = (1 << hb) + (rank << (hb - logc)) + (q >> lo)
    return [at + (v << lo) for v in range(1 << R)], base


def fwd_model(x, w, wsh, p, g, used):
    """K1 on one row x (uint64 [N]) over geometry g."""
    logn, logc = g.logn, g.logc
    ar = Lazy(p)
    slice_log = logn - logc
    mask = (1 << slice_log) - 1
    smem = np.full((g.cluster, 1 << slice_log), 2**40, dtype=np.uint64)
    R = g.passes[0]
    lo = logn - R
    seen = []
    for rank in range(g.cluster):
        for l in columns(g, rank):
            idx = [(v << lo) + l for v in range(1 << R)]
            vals = [x[i] for i in idx]
            ct_stages(vals, idx, w, wsh, np.ones_like(l), R, 0, ar, used)
            for i, val in zip(idx, vals):
                smem[i >> slice_log, swz(i & mask)] = val
                seen.append(i)
    assert sorted(np.concatenate(seen).tolist()) == list(range(1 << logn))
    for R in g.passes[1:]:
        lo -= R
        seen = []
        for rank in range(g.cluster):
            local, base = local_items(logn, logc, R, lo, rank)
            vals = [smem[rank, swz(a)] for a in local]
            idx = [(rank << slice_log) + a for a in local]
            ct_stages(vals, idx, w, wsh, base, R, logn - lo - R, ar, used)
            for a, val in zip(local, vals):
                smem[rank, swz(a)] = val
            seen += idx
        assert sorted(np.concatenate(seen).tolist()) == list(range(1 << logn))
    out = smem[:, swz(np.arange(1 << slice_log))].reshape(-1)
    return np.where(out >= ar.p, out - ar.p, out)


def inv_model(x, w, wsh, p, ni, ni_sh, g, used):
    """K2 on one row x (uint64 [N]) over geometry g."""
    logn, logc = g.logn, g.logc
    ar = Lazy(p)
    slice_log = logn - logc
    mask = (1 << slice_log) - 1
    smem = np.empty((g.cluster, 1 << slice_log), dtype=np.uint64)
    for rank in range(g.cluster):
        smem[rank, swz(np.arange(1 << slice_log))] = \
            x[rank << slice_log:(rank + 1) << slice_log]
    lo = 0
    for R in reversed(g.passes[1:]):
        for rank in range(g.cluster):
            local, base = local_items(logn, logc, R, lo, rank)
            vals = [smem[rank, swz(a)] for a in local]
            idx = [(rank << slice_log) + a for a in local]
            gs_stages(vals, idx, w, wsh, base, R, lo, ar, used)
            for a, val in zip(local, vals):
                smem[rank, swz(a)] = val
        lo += R
    R = g.passes[0]
    assert lo == logn - R
    out = np.full(1 << logn, 2**40, dtype=np.uint64)
    for rank in range(g.cluster):
        for l in columns(g, rank):
            idx = [(v << lo) + l for v in range(1 << R)]
            vals = [smem[i >> slice_log, swz(i & mask)] for i in idx]
            gs_stages(vals, idx, w, wsh, np.ones_like(l), R, lo, ar, used)
            for i, val in zip(idx, vals):
                val = ar.mul(val, ni, ni_sh)
                out[i] = np.where(val >= ar.p, val - ar.p, val)
    assert (out < ar.p).all()
    return out


def plain_twiddles(logn, forward):
    """(stage, iu, iv, twiddle index) of every butterfly as the plain
    transforms (one stage at a time) take them."""
    n = 1 << logn
    out = set()
    for st in range(logn):
        if forward:                   # stage m = 2^st, half = n / 2m
            lh = logn - 1 - st
            for b in range(n // 2):
                g = b >> lh
                iu = (g << (lh + 1)) + (b & ((1 << lh) - 1))
                out.add((st, iu, iu + (1 << lh), (1 << st) + g))
        else:                         # stage lh = st, h = n >> (lh + 1)
            for b in range(n // 2):
                g = b >> st
                iu = (g << (st + 1)) + (b & ((1 << st) - 1))
                out.add((st, iu, iu + (1 << st), (n >> (st + 1)) + g))
    return out


@pytest.mark.parametrize("logn", range(1, 13))
def test_schedule_model_bit_equal_plain(logn):
    n = 1 << logn
    primes = tuple(find_ntt_primes(30, 2, 2 * n) + find_ntt_primes(25, 1, 2 * n))
    t = T.ntt_tables(n, primes, CPU)
    h = T.build_ntt_tables(n, primes)
    rng = np.random.default_rng(logn)
    a = np.stack([rng.integers(0, p, (2, n)) for p in primes], axis=1)
    a[..., 0] = 0
    a[..., 1] = np.array(primes)[None, :] - 1
    want_f = T.ntt_plain(torch.from_numpy(a), t).numpy()
    want_i = T.intt_plain(torch.from_numpy(want_f), t).numpy()
    u64 = np.uint64
    for logc in range(K.max_log_cluster(logn) + 1):
        g = K.launch_geometry(logn, logc)
        for b in range(2):
            for li, p in enumerate(primes):
                used_f, used_i = set(), set()
                fwd = fwd_model(a[b, li].astype(u64), h.psi_rev[li].astype(u64),
                                h.psi_rev_shoup[li].astype(u64), p, g, used_f)
                assert np.array_equal(fwd, want_f[b, li].astype(u64)), (logc, li)
                inv = inv_model(fwd, h.psi_inv_rev[li].astype(u64),
                                h.psi_inv_rev_shoup[li].astype(u64), p,
                                u64(h.n_inv[li, 0]), u64(h.n_inv_shoup[li, 0]),
                                g, used_i)
                assert np.array_equal(inv, want_i[b, li].astype(u64)), (logc, li)
                assert np.array_equal(inv, a[b, li].astype(u64))
                if b == 0 and li == 0:
                    assert used_f == plain_twiddles(logn, True), logc
                    assert used_i == plain_twiddles(logn, False), logc
