"""Public-key encryption as one launch of K14 (``ops.encrypt_cuda``) and
its composition (``ckks.scheme.encrypt_composed``).

On the CPU: which path ``scheme.encrypt`` takes (K14 for a card ring up to
2^15, the composition above it, counted, and on the CPU), with a stand-in
for the launch that follows the kernel's arithmetic (its floor-mod, then
the plain transform and the plain primitives), bit-equal to the
composition; the wrapper's refusals before anything is built; the
kernel's floor-mod against ``signed_to_residues`` at the edges; and the
bytes behind K14's bound.  On the card (marked ``cuda``; they skip
elsewhere): K14 bit-equal to the plain version
(``ckks.scheme.encrypt_plain``: the plain transform and primitives, no
kernel of the port) at the benchmark's ring and at FLAGSHIP over one,
three and 1,024 ciphertexts, with ``TorchSampler`` draws and with numpy
draws handed over as host tensors; and the regulator's replayed step
bit-equal to its uncaptured step with K14's launches counted on each
replay.  The file imports neither jax nor the JAX package, so it runs where
the card is (which has no jax: the JAX package's own draws go through K14's
route in tests/test_torch_scheme.py, on the CPU with the stand-in):

    python -m pytest tests/test_torch_encrypt_kernel.py --noconftest -o addopts="" -q
"""

import math
import types

import numpy as np
import pytest
import torch

from hectr_tpu_torch import cli
from hectr_tpu_torch import config as cfg
from hectr_tpu_torch.bench import (HBM_BYTES_PER_S, encrypt_bound,
                                   encrypt_kernels, encrypt_work)
from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.ckks.context import make_context
from hectr_tpu_torch.hempc import make_hempc_regulator
from hectr_tpu_torch.ops import encrypt_cuda as EC
from hectr_tpu_torch.ops import launches, ntt_cuda
from hectr_tpu_torch.utils import pmu
from encrypt_model import floor_mod_model, kernel_model
from loop_cases import (HORIZON, assert_bit_equal, card,  # noqa: F401
                        disturbances, episodes, secure)

CPU = torch.device("cpu")
SMALL = cfg.CKKSPreset(name="encrypt-test", logn=10, slots=16, scale_bits=50,
                       limb_bits=25, mult_depth=2)
INT64_MAX = 2 ** 63 - 1


def edges(p: int) -> list[int]:
    """The floor-mod's edge words for the prime p."""
    return [-p - 1, -p, -1, 0, p - 1, p, 2 ** 40, -2 ** 40, INT64_MAX,
            -INT64_MAX, -INT64_MAX - 1]


class EdgeDraws:
    """A sampler of numpy draws handed over as host tensors (as the JAX
    replay of tests/test_torch_scheme.py hands them), ternary v and
    gaussian e's with every prime's edge words planted in row 0."""

    def __init__(self, seed: int, primes):
        self.rng = np.random.default_rng(seed)
        self.planted = sorted({w for p in primes for w in edges(p)})

    def encryption(self, ctx, k, batch, device):
        rows = math.prod(batch)
        r = self.rng.integers(0, 4, (3, rows, ctx.n))
        draws = np.round(3.2 * self.rng.normal(size=(3, rows, ctx.n))
                         ).astype(np.int64)
        draws[0] = (r[0] == 3).astype(np.int64) - (r[0] == 0)
        for d in draws:
            at = self.rng.choice(ctx.n, len(self.planted), replace=False)
            d[0, at] = self.planted
        return tuple(torch.from_numpy(d).reshape(*batch, ctx.n)
                     for d in draws)


@pytest.fixture(scope="module")
def small():
    ctx = make_context(SMALL)
    return ctx, S.keygen(ctx, S.TorchSampler(0, CPU), CPU)


def plaintext(ctx, k, batch, seed=1) -> S.Plaintext:
    t = ctx.tables(k, CPU)
    gen = torch.Generator().manual_seed(seed)
    return S.Plaintext(encrypt_kernels.uniform_plaintext(t, batch, gen),
                       ctx.delta)


@pytest.fixture
def counters():
    """Every launch counter and ``pmu.COUNTS`` zeroed, restored after."""
    held = launches.counters()
    before = [dict(c) for c in held]
    counts = dict(pmu.COUNTS)
    launches.reset()
    pmu.reset_counts()
    yield
    for c, b in zip(held, before):
        c.clear()
        c.update(b)
    pmu.reset_counts()
    pmu.COUNTS.update(counts)


# ---- the path scheme.encrypt takes ------------------------------------------


@pytest.mark.parametrize("batch", [(), (1,), (3,), (2, 3)])
@pytest.mark.parametrize("limbs", ["top", 2])
def test_card_ring_takes_k14_once_a_call(small, monkeypatch, counters, batch,
                                         limbs):
    """A card ciphertext of a ring up to 2^15 (the CPU standing in for the
    card, the launch for K14's arithmetic): one launch a call, counted by
    (batch rows, k, logN), nothing in K1's counters or as composed;
    bit-equal to the composition from the same seed, also with edge words
    in the draws."""
    ctx, keys = small
    k = ctx.max_limbs if limbs == "top" else limbs
    pt = plaintext(ctx, k, batch)
    want = [S.encrypt(ctx, keys, pt, S.TorchSampler(7, CPU)),
            S.encrypt(ctx, keys, pt, EdgeDraws(8, ctx.data_primes[:k]))]
    monkeypatch.setattr(S, "on_card", lambda x: True)
    monkeypatch.setattr(EC, "_launch", kernel_model)
    got = [S.encrypt(ctx, keys, pt, S.TorchSampler(7, CPU)),
           S.encrypt(ctx, keys, pt, EdgeDraws(8, ctx.data_primes[:k]))]
    for g, w in zip(got, want):
        assert g.data.shape == (*batch, 2, k, ctx.n)
        assert torch.equal(g.data, w.data) and g.scale == w.scale
    assert EC.LAUNCHES == {"encrypt": 2}
    assert dict(EC.LAUNCH_SHAPES) == {(math.prod(batch), k, 10): 2}
    assert not ntt_cuda.LAUNCH_SHAPES and not pmu.COUNTS


def test_larger_card_rings_and_the_cpu_take_the_composition(small,
                                                            monkeypatch,
                                                            counters):
    """A card ring above K14's rows (its limit lowered below the test
    ring) takes the composition, counted as ``scheme.encrypt.composed``
    once a call and launching no K14; the CPU takes it uncounted."""
    ctx, keys = small
    pt = plaintext(ctx, ctx.max_limbs, (2,))
    want = S.encrypt(ctx, keys, pt, S.TorchSampler(3, CPU))
    assert not pmu.COUNTS and EC.LAUNCHES == {"encrypt": 0}

    def no_launch(*args):
        raise AssertionError("K14 launched above its largest ring")

    monkeypatch.setattr(S, "on_card", lambda x: True)
    monkeypatch.setattr(EC, "_launch", no_launch)
    monkeypatch.setattr(EC, "MAX_LOGN", 9)
    for _ in range(2):
        got = S.encrypt(ctx, keys, pt, S.TorchSampler(3, CPU))
        assert torch.equal(got.data, want.data)
    assert dict(pmu.COUNTS) == {"scheme.encrypt.composed": 2}
    assert EC.LAUNCHES == {"encrypt": 0} and not EC.LAUNCH_SHAPES


# ---- the wrapper's refusals -------------------------------------------------


def refusal_cases(ctx, keys):
    t = ctx.tables(3, CPU)
    pt = plaintext(ctx, 3, (2,)).data
    draws = S.TorchSampler(1, CPU).encryption(ctx, 3, (2,), CPU)
    meta = torch.empty(2, ctx.n, dtype=torch.int64, device="meta")
    big = types.SimpleNamespace(n=1 << 16, primes=t.primes, device=CPU)
    short_key = keys.pk[:, :2]
    return {
        "off the card": ((*draws, pt, keys.pk, t), ValueError),
        "int32 draw": ((draws[0].int(), *draws[1:], pt, keys.pk, t),
                       TypeError),
        "draw of another batch": ((draws[0][:1], *draws[1:], pt, keys.pk, t),
                                  ValueError),
        "plaintext of other limbs": ((*draws, pt[:, :2], keys.pk, t),
                                     ValueError),
        "k above the key's limbs": ((*draws, pt, short_key, t), ValueError),
        "key of one half": ((*draws, pt, keys.pk[:1], t), ValueError),
        "ring above 2^15": ((*draws, pt, keys.pk, big), ValueError),
        "tensors on two devices": ((meta, *draws[1:], pt, keys.pk, t),
                                   ValueError),
        "empty batch": ((*(d[:0] for d in draws), pt[:0], keys.pk, t),
                        ValueError),
        "a draw off 16-byte alignment": (
            (torch.zeros(2 * ctx.n + 1, dtype=torch.int64)[1:].view(2, ctx.n),
             *draws[1:], pt, keys.pk, t), ValueError),
    }


CASES = ["off the card", "int32 draw", "draw of another batch",
         "plaintext of other limbs", "k above the key's limbs",
         "key of one half", "ring above 2^15", "tensors on two devices",
         "empty batch", "a draw off 16-byte alignment"]


@pytest.mark.parametrize("case", CASES)
def test_wrapper_refuses_before_building(small, monkeypatch, counters, case):
    """What K14 does not take raises before the library is built, and
    counts no launch."""
    ctx, keys = small
    args, error = refusal_cases(ctx, keys)[case]

    def build():
        raise AssertionError("built the library")

    monkeypatch.setattr(EC, "library", build)
    with pytest.raises(error):
        EC.encrypt(*args)
    assert EC.LAUNCHES == {"encrypt": 0} and not EC.LAUNCH_SHAPES


def test_refusal_cases_are_all_named(small):
    """Each refusal case above is one of the parametrised ones."""
    assert sorted(refusal_cases(*small)) == sorted(CASES)


# ---- the floor-mod and the bound ---------------------------------------------


@pytest.mark.parametrize("preset", [cfg.REFERENCE_HEMPC_SECURE, cfg.FLAGSHIP])
def test_floor_mod_matches_signed_to_residues_at_the_edges(preset):
    """The kernel's floor-mod (``floor_mod_model``) gives
    ``signed_to_residues``' words (torch.remainder) at -p-1, -p, -1, 0,
    p-1, p, +-2^40 and +-(2^63-1) and -2^63, for every prime of the
    chain."""
    primes = make_context(preset).data_primes
    words = torch.tensor(sorted({w for p in primes for w in edges(p)}),
                         dtype=torch.int64)
    pcol = torch.tensor(primes, dtype=torch.int64).reshape(-1, 1)
    want = S.signed_to_residues(words, pcol)
    got = torch.stack([floor_mod_model(words, p) for p in primes])
    assert torch.equal(got, want)
    assert bool(((want >= 0) & (want < pcol)).all())


def test_encrypt_work_counts_each_word_once():
    """K14's bytes at the serving cell's call (1,024 ciphertexts of 4
    limbs at 2^13): the draws 201,326,592, the plaintext 268,435,456 and
    the ciphertext 536,870,912 bytes, the key's rows 524,288 and the
    tables 262,160; bytes bind there (0.3007 ms at 3.35 TB/s) and at one
    ciphertext."""
    n = 1 << 13
    nbytes, mults = encrypt_work(1024, 4, 13)
    parts = {"draws": 3 * 1024 * n * 8, "plaintext": 1024 * 4 * n * 8,
             "ciphertext": 2 * 1024 * 4 * n * 8, "key": 2 * 4 * n * 8,
             "tables": 4 * (2 * n * 4 + 4)}
    assert parts == {"draws": 201_326_592, "plaintext": 268_435_456,
                     "ciphertext": 536_870_912, "key": 524_288,
                     "tables": 262_160}
    assert nbytes == sum(parts.values()) == 1_007_419_408
    assert mults == 1024 * 4 * (3 * 13 * n // 2 + 2 * n)
    peak = 5.58e12
    ms, by = encrypt_bound(1024, 4, 13, peak)
    assert by == "bytes" and ms == pytest.approx(nbytes / HBM_BYTES_PER_S
                                                 * 1e3)
    assert round(ms, 4) == 0.3007
    assert encrypt_bound(1, 4, 13, peak)[1] == "bytes"


# ---- on the card ------------------------------------------------------------


def plain_in_chunks(t, pk, m, draws, rows: int = 128) -> list:
    """The plain version over the batch rows in chunks of `rows` (a
    FLAGSHIP batch of 1,024 whole would hold some 60 GB of
    intermediates)."""
    if m.dim() == 2:
        return [S.encrypt_plain(t, pk, m, *draws)]
    return [S.encrypt_plain(t, pk, m[i:i + rows],
                            *(d[i:i + rows] for d in draws))
            for i in range(0, m.shape[0], rows)]


@pytest.fixture(scope="module")
def card_keys(card):
    """Keys on the card at the benchmark's ring and at FLAGSHIP."""
    out = {}
    for preset in (cfg.REFERENCE_HEMPC_SECURE, cfg.FLAGSHIP):
        ctx = make_context(preset)
        out[preset.name] = ctx, S.keygen(ctx, S.TorchSampler(0, card), card)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["torch", "recorded"])
@pytest.mark.parametrize("batch", [(), (1,), (3,), (1024,)])
@pytest.mark.parametrize("shape", ["secure k4", "secure k2", "flagship k22"])
def test_kernel_bit_equal_to_composition(card, card_keys, shape, batch,
                                         sampler):
    """``scheme.encrypt`` on the card (one K14 launch) against the plain
    composition (``scheme.encrypt_plain``: torch.remainder, the plain
    transform, the plain primitives, a stack) on the same draws (the same
    sampler made again): every word equal, at reference-hempc-secure (N
    2^13, k 4 and 2) and FLAGSHIP (N 2^15, k 22), with ``TorchSampler``
    draws and with host draws holding each prime's edge words."""
    name, k = {"secure k4": ("reference-hempc-secure", 4),
               "secure k2": ("reference-hempc-secure", 2),
               "flagship k22": ("flagship", 22)}[shape]
    ctx, keys = card_keys[name]
    t = ctx.tables(k, card)
    gen = torch.Generator(device=card).manual_seed(len(batch) + k)
    pt = S.Plaintext(encrypt_kernels.uniform_plaintext(t, batch, gen),
                     ctx.delta)

    def make():
        if sampler == "torch":
            return S.TorchSampler(11, card)
        return EdgeDraws(11, ctx.data_primes[:k])

    before = EC.LAUNCHES["encrypt"]
    got = S.encrypt(ctx, keys, pt, make()).data
    torch.cuda.synchronize()
    assert EC.LAUNCHES["encrypt"] == before + 1
    assert got.shape == (*batch, 2, k, ctx.n)
    draws = [d.to(card) for d in make().encryption(ctx, k, batch, card)]
    want = plain_in_chunks(t, keys.pk, pt.data, draws)
    assert torch.equal(got.reshape(-1, 2, k, ctx.n),
                       torch.cat([w.reshape(-1, 2, k, ctx.n) for w in want]))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [(), (1024,)])
def test_regulator_replay_bit_equal_with_encrypt_launches(card, secure,
                                                          batch):
    """The regulator's replayed step against its uncaptured step at one
    plant and 1,024, two 4-step episodes on the same seed: moves, states
    and canaries bit-equal; four K14 launches a step counted on every
    replay, by (plants, 4, 13), and every counter as the uncaptured path
    left it."""
    ctx, keys, rk = secure
    reg = make_hempc_regulator(ctx, keys, rk, *cli.cstr_setup(), HORIZON)
    p = disturbances(2, 4, batch)
    launches.reset()
    want = episodes(p, card, reg.uncaptured, S.TorchSampler(5, card))
    torch.cuda.synchronize()
    want_launches = [dict(c) for c in launches.counters()]
    launches.reset()
    pmu.reset_counts()
    got = episodes(p, card, reg, S.TorchSampler(5, card))
    torch.cuda.synchronize()
    assert_bit_equal(got, want)
    assert {k: v for k, v in pmu.COUNTS.items()
            if k.startswith("regulator.")} == {
        "regulator.capture": 1, "regulator.replay": 7,
        "regulator.uncaptured": 1}
    assert EC.LAUNCHES["encrypt"] == 4 * 8
    assert dict(EC.LAUNCH_SHAPES) == {(math.prod(batch), 4, 13): 4 * 8}
    assert [dict(c) for c in launches.counters()] == want_launches
