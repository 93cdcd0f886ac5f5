"""The port's ctypes binding of csrc/hectr_host.cpp, held against the JAX
package's binding, against pure Python (modmath.to_rns / from_rns) and
against the port's NTT (mirrors tests/test_native.py)."""

import random

import numpy as np
import pytest
import torch

from hectr_tpu import native as jnative
from hectr_tpu.ckks import ntt as JT
from hectr_tpu.ckks.ntt import build_ntt_tables as jbuild_ntt_tables
from hectr_tpu_torch import native
from hectr_tpu_torch.ckks import modmath as TM
from hectr_tpu_torch.ckks import ntt as TT
from hectr_tpu_torch.ckks.primes import find_ntt_primes, root_of_unity

CPU = torch.device("cpu")


def _residues(primes, n, seed):
    rng = np.random.default_rng(seed)
    pcol = np.array(primes, dtype=np.int64).reshape(-1, 1)
    return torch.from_numpy(rng.integers(0, pcol, size=(len(primes), n)))


def test_library_builds_into_the_port_tree():
    assert native.available()
    assert native.LIBRARY.parent.parts[-3:] == ("hectr_tpu_torch", "csrc",
                                                "build")
    assert native.library().hectr_host_abi_version() == native.ABI_VERSION == 1


def test_crt_centered_matches_python_and_jax():
    primes = find_ntt_primes(30, 8, 1 << 9)
    res = _residues(primes, 64, 0)
    got = native.crt_centered(res, primes)
    want = TM.from_rns(res, primes)
    jwant = jnative.crt_centered(res.numpy().astype(np.uint32), primes)
    assert all(int(a) == int(b) == int(c) for a, b, c in zip(got, want, jwant))


def test_to_rns_roundtrip():
    random.seed(1)
    primes = find_ntt_primes(30, 5, 1 << 9)
    q = 1
    for p in primes:
        q *= p
    coeffs = np.array([random.randint(-(q // 2) + 1, q // 2)
                       for _ in range(32)] + [0, q // 2, -(q // 2) + 1],
                      dtype=object)
    res = native.to_rns(coeffs, primes)
    assert res.dtype == torch.int64 and res.shape == (5, 35)
    assert torch.equal(res, TM.to_rns(coeffs, primes))
    assert np.array_equal(res.numpy(), jnative.to_rns(coeffs, primes))
    for back in (native.crt_centered(res, primes), TM.from_rns(res, primes)):
        assert all(int(a) == int(b) for a, b in zip(back, coeffs))


def test_ntt_oracle_matches_plain_ntt():
    n = 512
    primes = tuple(find_ntt_primes(30, 2, 2 * n))
    t = TT.ntt_tables(n, primes, CPU)
    a = _residues(primes, n, 2)
    fwd = TT.ntt_plain(a, t)
    for i, p in enumerate(primes):
        psi = root_of_unity(p, 2 * n)
        assert torch.equal(native.ntt_ref(a[i], p, psi), fwd[i])
        assert torch.equal(native.intt_ref(fwd[i], p, psi), a[i])


@pytest.mark.parametrize("logn", [4, 6])
def test_negacyclic_mul_matches_oracle_and_jax(logn):
    n = 1 << logn
    primes = tuple(find_ntt_primes(30, 2, 2 * n))
    t = TT.ntt_tables(n, primes, CPU)
    x = _residues(primes, n, 3 + logn)
    y = _residues(primes, n, 4 + logn)
    got = TT.negacyclic_mul(x, y, t)
    want = JT.negacyclic_mul(x.numpy().astype(np.uint32),
                             y.numpy().astype(np.uint32),
                             jbuild_ntt_tables(n, primes))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    for i, p in enumerate(primes):
        assert torch.equal(native.negacyclic_mul_ref(x[i], y[i], p), got[i])
    # X * X^(n-1) = X^n = -1 mod X^n + 1
    e1 = torch.zeros((len(primes), n), dtype=torch.int64)
    e1[:, 1] = 1
    en = torch.zeros_like(e1)
    en[:, n - 1] = 1
    minus_one = torch.zeros_like(e1)
    minus_one[:, 0] = torch.tensor(primes) - 1
    assert torch.equal(TT.negacyclic_mul(e1, en, t), minus_one)


def test_binding_rejects_bad_input():
    primes = find_ntt_primes(30, 2, 1 << 9)
    with pytest.raises(ValueError, match="residue rows"):
        native.crt_centered(_residues(primes, 8, 5), primes[:1])
    with pytest.raises(ValueError, match="outside"):
        native.crt_centered(-_residues(primes, 8, 5) - 1, primes)
    with pytest.raises(ValueError, match="budget"):
        native.to_rns(np.array([1 << 200], dtype=object), primes)


@pytest.fixture
def fresh_library():
    native.library.cache_clear()
    yield
    native.library.cache_clear()


def test_raises_where_it_cannot_build(fresh_library, monkeypatch, tmp_path):
    """No fallback: without a buildable source every call raises."""
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "build" / "lib.so")
    assert not native.available()
    with pytest.raises(RuntimeError, match="cannot build|failed"):
        native.crt_centered(_residues([97], 4, 0), [97])


def test_raises_on_abi_mismatch(fresh_library, monkeypatch):
    monkeypatch.setattr(native, "ABI_VERSION", 2)
    with pytest.raises(RuntimeError, match="ABI version 1, expected 2"):
        native.library()
    assert not native.available()
