"""The CUDA kernels (NTT, multiply-ceiling probe) and the port on a CUDA
device, held to the plain PyTorch versions and to the port on the CPU.

Every test here needs an NVIDIA GPU and skips elsewhere.  The file
imports neither jax nor the JAX package, so it runs where the card is:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from hectr_tpu_torch import config as cfg
from hectr_tpu_torch.ckks import keyswitch as K
from hectr_tpu_torch.ckks import ntt as T
from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.ckks import gemv as G
from hectr_tpu_torch.ckks.context import make_context
from hectr_tpu_torch.ckks.primes import find_ntt_primes
from hectr_tpu_torch.ops import ntt_cuda

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def chain(logn):
    """A 34-prime chain at this ring size (32 data + 2 special primes,
    30-bit and 25-bit mixed), as FLAGSHIP_QP has at logN=15."""
    return make_context(cfg.CKKSPreset(
        name=f"cuda-test-{logn}", logn=logn, slots=16, scale_bits=50,
        limb_bits=25, mult_depth=15, special_limbs=2,
        digit_width=2)).full_primes


def residues(primes, shape, seed):
    rng = np.random.default_rng(seed)
    pcol = np.array(primes, dtype=np.int64).reshape(-1, 1)
    a = rng.integers(0, pcol, size=shape)
    a[..., 0] = 0
    a[..., 1] = pcol[:, 0] - 1
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("logn", [8, 12, 15])
@pytest.mark.parametrize("batch", [(), (2,), (11,)])
def test_kernels_bit_equal_plain(cuda_device, logn, batch):
    primes = chain(logn)
    for L in (1, 5, 24, 34):
        t = T.ntt_tables(1 << logn, primes[:L], cuda_device)
        a = residues(primes[:L], batch + (L, 1 << logn), logn + L).to(cuda_device)
        before = dict(ntt_cuda.LAUNCHES)
        fwd = T.ntt(a, t)
        inv = T.intt(fwd, t)
        torch.cuda.synchronize()
        assert ntt_cuda.LAUNCHES == {"ntt": before["ntt"] + 1,
                                     "intt": before["intt"] + 1}
        assert torch.equal(fwd, T.ntt_plain(a, t)), L
        assert torch.equal(inv, T.intt_plain(fwd, t)), L
        assert torch.equal(inv, a), L


def test_plain_path_counts_no_launch(cuda_device):
    t = T.ntt_tables(1 << 10, chain(10)[:3], cuda_device)
    a = residues(t.primes, (3, 1 << 10), 1).to(cuda_device)
    before = dict(ntt_cuda.LAUNCHES)
    T.intt_plain(T.ntt_plain(a, t), t)
    assert ntt_cuda.LAUNCHES == before


def test_noncontiguous_input_goes_through_dispatch(cuda_device):
    """ntt() hands the kernel a contiguous copy; the wrapper itself
    refuses a strided view."""
    primes = chain(10)[:2]
    t = T.ntt_tables(1 << 10, primes, cuda_device)
    a = residues(primes, (3, 2, 1 << 10), 2).to(cuda_device)
    a = a.transpose(0, 1).contiguous().transpose(0, 1)   # same values, strided
    assert not a.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.ntt_cuda(a, t)
    assert torch.equal(T.ntt(a, t), T.ntt_plain(a.contiguous(), t))


def test_wrapper_rejects_what_it_does_not_take(cuda_device):
    primes = chain(10)[:2]
    t = T.ntt_tables(1 << 10, primes, cuda_device)
    a = torch.zeros((2, 1 << 10), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        ntt_cuda.ntt_cuda(a.to(torch.int32), t)
    with pytest.raises(ValueError):
        ntt_cuda.intt_cuda(a[:1], t)
    with pytest.raises(ValueError, match="tables on"):
        ntt_cuda.ntt_cuda(a, T.ntt_tables(1 << 10, primes, CPU))
    big = T.ntt_tables(1 << 16, tuple(find_ntt_primes(30, 1, 1 << 17)),
                       cuda_device)
    with pytest.raises(ValueError, match="supports"):
        ntt_cuda.ntt_cuda(torch.zeros((1, 1 << 16), dtype=torch.int64,
                                      device=cuda_device), big)


class NumpySampler:
    """Draws from a numpy generator, so the CPU and the CUDA runs get
    the same samples."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def _tern(self, n):
        r = self.rng.integers(0, 4, n)
        return torch.from_numpy((r == 3).astype(np.int64) - (r == 0))

    def _gauss(self, *shape):
        return torch.from_numpy(np.round(3.2 * self.rng.normal(size=shape))
                                .astype(np.int64))

    def _uniform(self, primes, *lead, n):
        pcol = np.array(primes, dtype=np.int64).reshape(-1, 1)
        return torch.from_numpy(self.rng.integers(0, pcol, (*lead, len(primes), n)))

    def keygen(self, ctx, device):
        return (self._tern(ctx.n), self._uniform(ctx.data_primes, n=ctx.n),
                self._gauss(ctx.n))

    def encryption(self, ctx, k, device):
        return self._tern(ctx.n), self._gauss(ctx.n), self._gauss(ctx.n)

    def switching_key(self, ctx, dnum, primes, device):
        return self._uniform(primes, dnum, n=ctx.n), self._gauss(dnum, ctx.n)


@pytest.mark.parametrize("hybrid", [False, True])
def test_scheme_on_cuda_bit_equal_cpu(cuda_device, monkeypatch, hybrid):
    """Keygen, encryption, rotation, gemv (both methods) and rescale give
    the same residues on the card as on the CPU, from the same draws
    and the same plaintexts.  The gemv diagonals are encoded on the CPU
    for both: the embedding's float64 matrix product may round in the
    last ulp differently on the card, and after scaling by 2^50 that
    is one unit of a plaintext coefficient."""
    encode_diag = G._encode_diag
    monkeypatch.setattr(G, "_encode_diag", lambda ctx, d, k, scale, device:
                        encode_diag(ctx, d, k, scale, CPU).to(device))
    preset = cfg.CKKSPreset(name="cuda-scheme", logn=10, slots=16,
                            scale_bits=50, limb_bits=25, mult_depth=2,
                            special_limbs=2 if hybrid else 1,
                            digit_width=2 if hybrid else 1)
    ctx = make_context(preset)
    out = {}
    M = np.random.default_rng(3).normal(size=(8, 3))
    pt = S.encode(ctx, (torch.linspace(-1, 1, 16, dtype=torch.float64),
                        torch.zeros(16, dtype=torch.float64)), ctx.max_limbs)
    for dev in (CPU, cuda_device):
        keys = S.keygen(ctx, NumpySampler(0), dev)
        rk = K.gen_rotation_keys(ctx, keys, NumpySampler(1))
        ct = S.encrypt(ctx, keys, S.Plaintext(pt.data.to(dev), pt.scale),
                       NumpySampler(2))
        rk_bs = {r: rk[r] for r in G.bsgs_rotations(ctx.slots)}
        res = [keys.sk, keys.pk, rk[5], ct.data,
               K.rotate(ctx, ct, 5, rk).data,
               G.gemv(ctx, M, ct, rk, method="diag").data,
               G.gemv(ctx, M, ct, rk_bs, method="bsgs").data]
        out[dev.type] = [r.cpu() for r in res]
    for i, (a, b) in enumerate(zip(out["cpu"], out["cuda"])):
        assert torch.equal(a, b), i


def test_reference_loop_on_cuda(cuda_device):
    """REFERENCE_HEMPC, 40 steps on the card, through the CLI's
    functions: the plaintext twin to 5e-10 per channel, canary < 1e-5,
    both kernels launched."""
    from hectr_tpu_torch import cli

    ctx, keys, rk = cli.hempc_keys(cfg.REFERENCE_HEMPC, 0, cuda_device)
    ntt_cuda.reset_launches()
    x, u, canary = cli.run_cstr_hempc(ctx, keys, rk, 40, 0, cuda_device)
    assert ntt_cuda.LAUNCHES["ntt"] > 0 and ntt_cuda.LAUNCHES["intt"] > 0
    x_pt, u_pt = cli.run_cstr_mpc(40, cuda_device)
    assert np.all(np.max(np.abs(x - x_pt), axis=0) < 5e-10)
    assert np.all(np.max(np.abs(u - u_pt), axis=0) < 5e-10)
    assert canary < 1e-5


# ---- K3: the multiply-ceiling probe ----------------------------------------


def test_mulmod_chain_kernel_bit_equal_plain(cuda_device):
    from hectr_tpu_torch.bench import vpu_ceiling as V
    from hectr_tpu_torch.ops import mulmod_cuda

    x0, c = V.probe_inputs(cuda_device)
    for r in (0, 1, 7, 64):
        before = mulmod_cuda.LAUNCHES["mulmod_chain"]
        got = V.chain(x0, c, r)
        torch.cuda.synchronize()
        assert mulmod_cuda.LAUNCHES["mulmod_chain"] == before + 1
        assert torch.equal(got, V.chain_plain(x0, c, r)), r
    out = V.dispatch(x0[:256], c, r=128, calls=4)
    assert torch.equal(out, V.dispatch(x0[:256], c, r=128, calls=4,
                                       step=V.chain_plain))
    assert V.pow_probe_ok(x0[:256], out, c, 512)


def test_mulmod_chain_wrapper_rejects_what_it_does_not_take(cuda_device):
    from hectr_tpu_torch.bench import vpu_ceiling as V
    from hectr_tpu_torch.ops import mulmod_cuda

    x0, c = V.probe_inputs(cuda_device, rows=8)
    with pytest.raises(ValueError):
        mulmod_cuda.mulmod_chain_cuda(x0.to(torch.int32), c.w32,
                                      c.w_shoup32, c.p32, 2)
    with pytest.raises(ValueError):
        mulmod_cuda.mulmod_chain_cuda(x0[:, :64].contiguous(), c.w32,
                                      c.w_shoup32, c.p32, 2)
    with pytest.raises(ValueError):
        mulmod_cuda.mulmod_chain_cuda(x0, c.w, c.w_shoup32, c.p32, 2)


# ---- ct x ct multiplication ------------------------------------------------


@pytest.mark.parametrize("hybrid", [False, True])
def test_mul_ct_and_compact_key_switch_on_cuda_bit_equal_cpu(cuda_device,
                                                             hybrid):
    """Relinearisation keys (full and compact), mul_ct with each, rescale,
    and a key switch with a compact rotation key give the same residues
    on the card as on the CPU, from the same draws."""
    preset = cfg.CKKSPreset(name="cuda-mul", logn=10, slots=16,
                            scale_bits=50, limb_bits=25, mult_depth=2,
                            special_limbs=2 if hybrid else 1,
                            digit_width=2 if hybrid else 1)
    ctx = make_context(preset)
    pts = [S.encode(ctx, (torch.linspace(-1, 1, 16, dtype=torch.float64) * f,
                          torch.zeros(16, dtype=torch.float64)), ctx.max_limbs)
           for f in (1.0, -0.5)]
    out = {}
    for dev in (CPU, cuda_device):
        keys = S.keygen(ctx, NumpySampler(0), dev)
        cts = [S.encrypt(ctx, keys, S.Plaintext(pt.data.to(dev), pt.scale),
                         NumpySampler(2 + i)) for i, pt in enumerate(pts)]
        res = []
        for compact in (False, True):
            relin = K.gen_relin_key(ctx, keys, NumpySampler(5),
                                    compact=compact)
            prod = K.mul_ct(ctx, cts[0], cts[1], relin)
            res += [relin, prod.data, S.rescale_pair(ctx, prod).data]
        rk = K.gen_rotation_keys(ctx, keys, NumpySampler(6), rotations=[3],
                                 compact=True)
        res.append(K.rotate(ctx, cts[0], 3, rk).data)
        out[dev.type] = [r.cpu() for r in res]
    for i, (a, b) in enumerate(zip(out["cpu"], out["cuda"])):
        assert torch.equal(a, b), i


def test_flagship_qp_sized_mul_ct(cuda_device):
    """One ct x ct product at k = 30 of FLAGSHIP_QP's chain (logN=15,
    compact relinearisation key over 34 primes, 15 digits), rescaled and
    decoded."""
    ctx = make_context(cfg.FLAGSHIP_QP)
    keys = S.keygen(ctx, S.TorchSampler(1, cuda_device), cuda_device)
    relin = K.gen_relin_key(ctx, keys, S.TorchSampler(2, cuda_device),
                            compact=True)
    assert relin.shape == (16, 2, 34, 1 << 15)
    v = torch.linspace(-2, 2, 16, dtype=torch.float64, device=cuda_device)
    w = torch.cos(torch.arange(16, dtype=torch.float64, device=cuda_device))
    zeros = torch.zeros_like(v)
    sampler = S.TorchSampler(3, cuda_device)
    a = S.encrypt(ctx, keys, S.encode(ctx, (v, zeros), 30), sampler)
    b = S.encrypt(ctx, keys, S.encode(ctx, (w, zeros), 30), sampler)
    ntt_cuda.reset_launches()
    prod = S.rescale_pair(ctx, K.mul_ct(ctx, a, b, relin))
    re, im = S.decode_ri(ctx, S.decrypt(ctx, keys, prod))
    assert ntt_cuda.LAUNCHES["ntt"] > 0 and ntt_cuda.LAUNCHES["intt"] > 0
    assert prod.limbs == 28 and prod.scale == ctx.delta**2 / ctx.pair_scale(30)
    assert float((re - v * w).abs().max()) < 1e-6
    assert float(im.abs().max()) < 1e-5
