"""The CUDA kernels (NTT, multiply-ceiling probe) and the port on a CUDA
device, held to the plain PyTorch versions and to the port on the CPU.

Every test here needs an NVIDIA GPU and skips elsewhere.  The file
imports neither jax nor the JAX package, so it runs where the card is:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import ROW_SHAPES, facade_problem, sweep_chain
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


@pytest.mark.parametrize("logn", range(1, 16))
def test_kernels_bit_equal_plain_every_logn_and_row_count(cuda_device, logn):
    """K1/K2 at every ring size over 1, 3, 4, 22, 44 and 264 rows of a
    mixed 30/25-bit chain (with 0 and p-1 planted): the row counts cover
    every cluster size the wrapper picks; each call is one launch."""
    primes = sweep_chain(logn)
    for shape in ROW_SHAPES:
        L = shape[-1]
        t = T.ntt_tables(1 << logn, primes[:L], cuda_device)
        a = residues(primes[:L], shape + (1 << logn,), 100 * logn + L)
        a = a.to(cuda_device)
        before = dict(ntt_cuda.LAUNCHES)
        shapes = dict(ntt_cuda.LAUNCH_SHAPES)
        fwd = T.ntt(a, t)
        inv = T.intt(fwd, t)
        torch.cuda.synchronize()
        assert ntt_cuda.LAUNCHES == {"ntt": before["ntt"] + 1,
                                     "intt": before["intt"] + 1}
        for name in ("ntt", "intt"):
            key = (name, tuple(a.shape))
            assert ntt_cuda.LAUNCH_SHAPES[key] == shapes.get(key, 0) + 1
        assert torch.equal(fwd, T.ntt_plain(a, t)), shape
        assert torch.equal(inv, T.intt_plain(fwd, t)), shape
        assert torch.equal(inv, a), shape


@pytest.mark.parametrize("logn", [6, 11, 12, 14, 15])
def test_every_cluster_size_bit_equal_plain(cuda_device, logn):
    """Every geometry the kernels accept, not only the one the wrapper
    picks, and each fits the card (cudaOccupancyMaxActiveClusters)."""
    primes = sweep_chain(logn)[:3]
    t = T.ntt_tables(1 << logn, primes, cuda_device)
    a = residues(primes, (2, 3, 1 << logn), logn).to(cuda_device)
    want = T.ntt_plain(a, t)
    for logc in range(ntt_cuda.max_log_cluster(logn) + 1):
        g = ntt_cuda.launch_geometry(logn, logc)
        assert ntt_cuda.max_active_clusters(True, g) >= 1
        assert ntt_cuda.max_active_clusters(False, g) >= 1
        fwd = ntt_cuda.launch_fwd(a, t, g)
        assert torch.equal(fwd, want), logc
        assert torch.equal(ntt_cuda.launch_inv(fwd, t, g), a), logc


def test_wrapper_refuses_a_misaligned_view(cuda_device):
    primes = chain(10)[:2]
    t = T.ntt_tables(1 << 10, primes, cuda_device)
    buf = torch.zeros(2 * (1 << 10) + 1, dtype=torch.int64, device=cuda_device)
    a = buf[1:].view(2, 1 << 10)
    assert a.is_contiguous() and a.data_ptr() % 16 == 8
    before = dict(ntt_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="aligned"):
        ntt_cuda.ntt_cuda(a, t)
    with pytest.raises(ValueError, match="aligned"):
        ntt_cuda.intt_cuda(a, t)
    assert ntt_cuda.LAUNCHES == before


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
    encode_diags = G._encode_diags
    monkeypatch.setattr(G, "_encode_diags", lambda ctx, D, k, scale, device:
                        encode_diags(ctx, D, k, scale, CPU).to(device))
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


# ---- full packing, negacyclic_mul, the he facade ---------------------------


@pytest.mark.parametrize("s", [128, 8192])
def test_fft_embedding_on_cuda_matches_cpu(cuda_device, s):
    from hectr_tpu_torch.ckks import encoding as E

    rng = np.random.default_rng(s)
    vre = torch.from_numpy(rng.uniform(-5, 5, (3, s)))
    vim = torch.from_numpy(rng.uniform(-5, 5, (3, s)))
    m = E.embed_ri(vre, vim, s)
    md = E.embed_ri(vre.to(cuda_device), vim.to(cuda_device), s)
    assert md.device == cuda_device
    assert float((md.cpu() - m).abs().max()) <= 1e-12
    for got, want in zip(E.unembed(md, s), E.unembed(m, s)):
        assert float((got.cpu() - want).abs().max()) <= 1e-12
    re, im = E.unembed(md, s)
    assert float((re.cpu() - vre).abs().max()) <= 1e-12
    assert float((im.cpu() - vim).abs().max()) <= 1e-12


def test_negacyclic_mul_on_cuda_bit_equal_cpu(cuda_device):
    primes = chain(12)[:5]
    a = residues(primes, (2, 5, 1 << 12), 7)
    b = residues(primes, (2, 5, 1 << 12), 8)
    want = T.negacyclic_mul(a, b, T.ntt_tables(1 << 12, primes, CPU))
    ntt_cuda.reset_launches()
    got = T.negacyclic_mul(a.to(cuda_device), b.to(cuda_device),
                           T.ntt_tables(1 << 12, primes, cuda_device))
    torch.cuda.synchronize()
    assert ntt_cuda.LAUNCHES == {"ntt": 2, "intt": 1}
    assert torch.equal(got.cpu(), want)


def test_medium_digit_stack_bit_equal_plain(cuda_device):
    """K1/K2 at MEDIUM's digit stack [6, 14, 2^14] (12 data + 2 special
    primes, width-2 digits)."""
    ctx = make_context(cfg.MEDIUM)
    assert ctx.dnum(ctx.max_limbs) == 6 and ctx.max_limbs == 12
    t = ctx.tables_ks(ctx.max_limbs, cuda_device)
    a = residues(t.primes, (6, 14, 1 << 14), 14).to(cuda_device)
    fwd = T.ntt(a, t)
    assert torch.equal(fwd, T.ntt_plain(a, t))
    assert torch.equal(T.intt(fwd, t), T.intt_plain(fwd, t))
    assert torch.equal(T.intt(fwd, t), a)


def test_he_facade_on_cuda(cuda_device):
    """The reference's he_* call sequence (tests/test_he_facade.py) on the
    card at logn=12: the control law to 1e-8, canary < 1e-5."""
    from hectr_tpu_torch import he

    xhat, xr, uhat, ur, K_A, K_B = facade_problem()
    hc = he.hectx_init(12, 109, 16, 50, seed=0, device=cuda_device)
    he.he_keypair(hc)
    he.he_genrk(hc)
    ntt_cuda.reset_launches()
    cts = [he.he_enc_pk(hc, he.he_ecd(hc, v)) for v in (xhat, uhat, xr, ur)]
    du = he.he_neg(hc, he.he_add(
        hc, he.he_gemv(hc, K_A, he.he_sub(hc, cts[0], cts[2])),
        he.he_gemv(hc, K_B, he.he_sub(hc, cts[1], cts[3]))))
    u = he.he_add(hc, he.he_moddown(hc, he.he_copy_ct(hc, cts[1])), du)
    got = he.he_dcd(hc, he.he_dec(hc, u))
    assert got.device == cuda_device
    assert ntt_cuda.LAUNCHES["ntt"] > 0 and ntt_cuda.LAUNCHES["intt"] > 0
    got = got.cpu().numpy()
    want = uhat - (K_A @ (xhat - xr) + K_B @ (uhat - ur))
    assert np.max(np.abs(got.real - want.real)) <= 1e-8
    assert np.max(np.abs(got.imag)) < 1e-5
