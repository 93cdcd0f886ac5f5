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
from hectr_tpu_torch import bench
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

    def _tern(self, *shape):
        r = self.rng.integers(0, 4, shape)
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

    def encryption(self, ctx, k, batch, device):
        return (self._tern(*batch, ctx.n), self._gauss(*batch, ctx.n),
                self._gauss(*batch, ctx.n))

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


# ---- the coefficient mesh on the card (hectr_tpu_torch.parallel) ---------


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("logn", [4, 8, 15])
def test_stacked_kernels_bit_equal_plain_local_stages(cuda_device, logn, size):
    """K1/K2 on the stacked [..., L*D, C] view over the gathered local
    tables (row l*D + s holds limb l of shard s) against the plain local
    stages, one launch each; and the whole sharded transform against the
    kernels on whole rows."""
    from hectr_tpu_torch.parallel import LocalMesh
    from hectr_tpu_torch.parallel.ntt_shard import (local_ntt_fns,
                                                    local_tables)

    primes = sweep_chain(logn)[:5]
    t = T.ntt_tables(1 << logn, primes, cuda_device)
    a = residues(primes, (2, 5, 1 << logn), logn + size).to(cuda_device)
    mesh = LocalMesh(size)
    lt = local_tables(t, mesh)
    rows = mesh.shard(a).flatten(-3, -2)
    assert rows.shape == (2, 5 * size, (1 << logn) // size)
    before = dict(ntt_cuda.LAUNCHES)
    fwd = T.ntt(rows, lt)
    inv = T.intt(rows, lt)
    torch.cuda.synchronize()
    assert ntt_cuda.LAUNCHES == {"ntt": before["ntt"] + 1,
                                 "intt": before["intt"] + 1}
    assert torch.equal(fwd, T.ntt_plain(rows, lt))
    assert torch.equal(inv, T.intt_plain(rows, lt))
    fwd_fn, inv_fn = local_ntt_fns(t, mesh)
    got = fwd_fn(mesh.shard(a))
    assert torch.equal(mesh.gather(got), T.ntt(a, t))
    assert torch.equal(mesh.gather(inv_fn(got)), a)


@pytest.mark.parametrize("logn,size", [(16, 2), (17, 4), (17, 8)])
def test_large_ring_on_a_local_mesh(cuda_device, logn, size):
    """Rings above one kernel row: the local mesh carries them (ntt
    itself routes them there, test_ntt_above_2_15_on_cuda_bit_equal_cpu),
    bit-equal to the plain transform."""
    from hectr_tpu_torch.parallel import LocalMesh
    from hectr_tpu_torch.parallel.ntt_shard import local_ntt_fns

    primes = tuple(find_ntt_primes(30, 3, 2 << logn))
    t = T.ntt_tables(1 << logn, primes, cuda_device)
    a = residues(primes, (3, 1 << logn), logn).to(cuda_device)
    mesh = LocalMesh(size)
    fwd_fn, inv_fn = local_ntt_fns(t, mesh)
    before = dict(ntt_cuda.LAUNCHES)
    got = fwd_fn(mesh.shard(a))
    back = inv_fn(got)
    torch.cuda.synchronize()
    assert ntt_cuda.LAUNCHES == {"ntt": before["ntt"] + 1,
                                 "intt": before["intt"] + 1}
    assert torch.equal(mesh.gather(got), T.ntt_plain(a, t))
    assert torch.equal(mesh.gather(back), a)


def test_coeff_ops_on_cuda_bit_equal_single_device(cuda_device):
    """rescale_pair, rotate and the hoisted gemv over 4 shards on the card
    against the single-device ops there (hybrid preset, logN = 10)."""
    from hectr_tpu_torch.parallel import LocalMesh
    from hectr_tpu_torch.parallel.coeff_ops import CoeffOps

    ctx = make_context(cfg.CKKSPreset(
        name="cuda-coeff", logn=10, slots=16, scale_bits=50, limb_bits=25,
        mult_depth=2, special_limbs=2, digit_width=2))
    k = ctx.max_limbs
    keys = S.keygen(ctx, S.TorchSampler(0, cuda_device), cuda_device)
    rk = K.gen_rotation_keys(ctx, keys, S.TorchSampler(1, cuda_device),
                             rotations=[1, 3])
    v = torch.linspace(-1, 1, 16, dtype=torch.float64, device=cuda_device)
    ct = S.encrypt(ctx, keys, S.encode(ctx, (v, torch.zeros_like(v)), k),
                   S.TorchSampler(2, cuda_device))
    ops = CoeffOps(ctx, LocalMesh(4))
    assert torch.equal(ops.rotate(ct, 1, rk).data, K.rotate(ctx, ct, 1, rk).data)
    M = np.zeros((16, 16))
    idx = np.arange(16)
    M[idx, idx] = 0.5
    M[idx, (idx + 3) % 16] = -0.25
    got = ops.make_gemv(M, k, rk, cuda_device)(ct)
    want = G.make_gemv(ctx, M, k, rk, cuda_device, "diag")(ct)
    assert torch.equal(got.data, want.data) and got.scale == want.scale
    dec = S.decode(ctx, S.decrypt(ctx, keys, got)).cpu().numpy()
    assert np.max(np.abs(dec.real - M @ v.cpu().numpy())) < 1e-6
    pt2 = S.encode(ctx, (torch.full_like(v, 2.0), torch.zeros_like(v)), k,
                   scale=ctx.pair_scale(k))
    prod = S.mul_pt(ctx, ct, pt2)
    assert torch.equal(ops.rescale_pair(prod).data,
                       S.rescale_pair(ctx, prod).data)


# ---- the cross-shard stages: K4 / K5 (ops/ntt_exchange_cuda.py) ----------

# (batch + (L,), logN, D): the sharded_ring routes of 2^16 and 2^17,
# FLAGSHIP's digit stack over 8 shards, and chunks of 2
EXCHANGE_CASES = [((22,), 16, 2), ((22,), 17, 4), ((11, 24), 15, 8),
                  ((2, 3), 4, 8)]


def exchange_problem(device, lead, logn, seed):
    primes = tuple(find_ntt_primes(30, lead[-1], 2 << logn))
    t = T.ntt_tables(1 << logn, primes, device)
    a = residues(primes, lead + (1 << logn,), seed).to(device)
    return t, a


@pytest.mark.parametrize("lead,logn,D", EXCHANGE_CASES)
def test_exchange_local_form_bit_equal_plain(cuda_device, lead, logn, D):
    """K4 / K5's local form (every stage, one launch) against
    cross_stages_plain on the same tensor, and the counters move by one
    launch under (name, "local", shape)."""
    from hectr_tpu_torch.ops import ntt_exchange_cuda as EX
    from hectr_tpu_torch.parallel import LocalMesh
    from hectr_tpu_torch.parallel.ntt_shard import cross_stages_plain

    t, a = exchange_problem(cuda_device, lead, logn, logn + D)
    x = LocalMesh(D).shard(a)
    for inverse, name in ((False, "exchange_fwd"), (True, "exchange_inv")):
        before = dict(EX.LAUNCHES)
        shapes = EX.LAUNCH_SHAPES[name, "local", tuple(x.shape)]
        got = EX.exchange_local_cuda(x, t, inverse)
        torch.cuda.synchronize()
        assert EX.LAUNCHES[name] == before[name] + 1
        assert EX.LAUNCH_SHAPES[name, "local", tuple(x.shape)] == shapes + 1
        assert torch.equal(got, cross_stages_plain(x, t, LocalMesh(D),
                                                   inverse))


@pytest.mark.parametrize("lead,logn,D", EXCHANGE_CASES)
def test_exchange_received_form_bit_equal_plain(cuda_device, lead, logn, D):
    """K4 / K5's received form (one stage of one shard against its
    partner's chunk, int32 as it travels) against exchange_stage_plain,
    for every shard of every stage."""
    from hectr_tpu_torch.ops import ntt_exchange_cuda as EX
    from hectr_tpu_torch.parallel import LocalMesh
    from hectr_tpu_torch.parallel.ntt_shard import (_exchange_constants,
                                                    exchange_stage_plain)

    t, a = exchange_problem(cuda_device, lead, logn, logn + D + 1)
    mesh = LocalMesh(D)
    x = mesh.shard(a)
    pcol = t.p[..., None]
    launches = 0
    for s in range(D):
        own = x[..., s:s + 1, :].contiguous()
        stages = _exchange_constants(t.n, t.primes, D, (s,), cuda_device)
        for d, is_u, w, wsh, wi, wish in stages:
            recv = mesh.ppermute(x, d)[..., s:s + 1, :].contiguous()
            wire = recv.to(torch.int32)
            for inverse, tw in ((False, (w, wsh)), (True, (wi, wish))):
                got = EX.exchange_recv_cuda(own, wire, t, s, d, inverse)
                launches += 1
                want = exchange_stage_plain(own, recv, *tw, is_u, pcol,
                                            inverse)
                assert torch.equal(got, want), (s, d, inverse)
    torch.cuda.synchronize()
    assert launches == D * (D.bit_length() - 1) * 2
    assert EX.LAUNCH_SHAPES["exchange_fwd", "received",
                            tuple(own.shape)] >= launches // 2


@pytest.mark.parametrize("lead,logn,D", EXCHANGE_CASES)
def test_sharded_transform_through_the_exchange_kernels(cuda_device, lead,
                                                        logn, D):
    """The whole sharded transform on a local mesh of the card (K4 then
    K1; K2 then K5, one launch each) gives ntt_plain / intt_plain."""
    from hectr_tpu_torch.ops import ntt_exchange_cuda as EX
    from hectr_tpu_torch.parallel import LocalMesh
    from hectr_tpu_torch.parallel.ntt_shard import local_ntt_fns

    t, a = exchange_problem(cuda_device, lead, logn, logn + D + 2)
    mesh = LocalMesh(D)
    fwd_fn, inv_fn = local_ntt_fns(t, mesh)
    before = {**ntt_cuda.LAUNCHES, **EX.LAUNCHES}
    fwd = mesh.gather(fwd_fn(mesh.shard(a)))
    inv = mesh.gather(inv_fn(mesh.shard(a)))
    torch.cuda.synchronize()
    after = {**ntt_cuda.LAUNCHES, **EX.LAUNCHES}
    assert {k: after[k] - before[k] for k in after} == {
        "ntt": 1, "intt": 1, "exchange_fwd": 1, "exchange_inv": 1}
    assert torch.equal(fwd, T.ntt_plain(a, t))
    assert torch.equal(inv, T.intt_plain(a, t))


def test_exchange_kernels_raise_on_what_they_do_not_take(cuda_device):
    """A table on the CPU, int32 residues, a D the local form does not
    take (1, 16), several shards given to the received form, an int64
    received chunk: each raises before a launch."""
    from hectr_tpu_torch.ops import ntt_exchange_cuda as EX
    from hectr_tpu_torch.parallel import LocalMesh

    t, a = exchange_problem(cuda_device, (3,), 10, 0)
    x = LocalMesh(4).shard(a)
    t_cpu = T.ntt_tables(t.n, t.primes, CPU)
    before = dict(EX.LAUNCHES)
    with pytest.raises(ValueError, match="tables on cpu"):
        EX.exchange_local_cuda(x, t_cpu)
    with pytest.raises(TypeError, match="int64"):
        EX.exchange_local_cuda(x.to(torch.int32), t)
    with pytest.raises(ValueError, match="D = 2..8"):
        EX.exchange_local_cuda(LocalMesh(16).shard(a), t)
    with pytest.raises(ValueError, match="D = 2..8"):
        EX.exchange_local_cuda(LocalMesh(1).shard(a), t)
    own = x[..., :1, :].contiguous()
    wire = own.to(torch.int32)
    with pytest.raises(ValueError, match="one shard"):
        EX.exchange_recv_cuda(x, x.to(torch.int32), t, 0, 1)
    with pytest.raises(TypeError, match="the wire's int32"):
        EX.exchange_recv_cuda(own, own, t, 0, 1)
    with pytest.raises(ValueError, match="tables on cpu"):
        EX.exchange_recv_cuda(own, wire, t_cpu, 0, 1)
    assert EX.LAUNCHES == before


# ---- the batch axis and rings above 2^15 on the card -----------------------


@pytest.mark.parametrize("logn", [16, 17])
def test_ntt_above_2_15_on_cuda_bit_equal_cpu(cuda_device, logn):
    """ntt / intt of a ring above one kernel row on the card (routed to
    the sharded transform on a local mesh of N / 2^15 shards, K1/K2 on
    its local stages) give the CPU's plain transform, bit for bit, over
    22 limbs (30-bit primes: 2^18 leaves too few 25-bit ones)."""
    primes = tuple(find_ntt_primes(30, 22, 2 << logn))
    a = residues(primes, (22, 1 << logn), logn)
    t_cpu = T.ntt_tables(1 << logn, primes, CPU)
    t = T.ntt_tables(1 << logn, primes, cuda_device)
    before = dict(ntt_cuda.LAUNCHES)
    fwd = T.ntt(a.to(cuda_device), t)
    inv = T.intt(fwd, t)
    torch.cuda.synchronize()
    assert ntt_cuda.LAUNCHES["ntt"] > before["ntt"]
    assert ntt_cuda.LAUNCHES["intt"] > before["intt"]
    want = T.ntt_plain(a, t_cpu)
    assert torch.equal(fwd.cpu(), want)
    assert torch.equal(inv.cpu(), T.intt_plain(want, t_cpu))
    assert torch.equal(inv.cpu(), a)


def test_hectx_init_16_chain_round_trip_on_cuda(cuda_device):
    """The chain he.hectx_init(16, 109, 16, 50) asks for, on the card:
    encrypt -> mul_pt -> rescale_pair -> decrypt to 1e-6, every transform
    a ring of 2^16.  hectx_init itself refuses logN=16 on every device,
    as the JAX package's does: the HE standard's table that sizes its
    security report stops at 2^15."""
    from hectr_tpu_torch import he

    with pytest.raises(ValueError, match="no HE-standard row"):
        he.hectx_init(16, 109, 16, 50, seed=0, device=cuda_device)
    ctx = make_context(cfg.CKKSPreset(name="he-16-109", logn=16, slots=16,
                                      scale_bits=50, limb_bits=25,
                                      mult_depth=1))
    k = ctx.max_limbs
    keys = S.keygen(ctx, S.TorchSampler(0, cuda_device), cuda_device)
    v = torch.linspace(-1, 1, 16, dtype=torch.float64, device=cuda_device)
    w = torch.linspace(0.5, -0.5, 16, dtype=torch.float64, device=cuda_device)
    zero = torch.zeros_like(v)
    before = dict(ntt_cuda.LAUNCHES)
    ct = S.encrypt(ctx, keys, S.encode(ctx, (v, zero), k),
                   S.TorchSampler(1, cuda_device))
    pt = S.encode(ctx, (w, zero), k, ctx.pair_scale(k))
    out = S.rescale_pair(ctx, S.mul_pt(ctx, ct, pt))
    re, im = S.decode_ri(ctx, S.decrypt(ctx, keys, out))
    assert ntt_cuda.LAUNCHES["ntt"] > before["ntt"]
    assert re.device == cuda_device and ctx.n == 1 << 16
    assert float((re - v * w).abs().max()) < 1e-6
    assert float(im.abs().max()) < 1e-6
    # the route caches the local tables of every (ring, primes) it met;
    # clearing them gives their device memory back
    from hectr_tpu_torch.parallel.ntt_shard import clear_local_tables

    del ct, pt, out, re, im
    held = torch.cuda.memory_allocated(cuda_device)
    clear_local_tables()
    assert torch.cuda.memory_allocated(cuda_device) < held


def test_batched_flagship_gemv_on_cuda_equals_rows(cuda_device, monkeypatch):
    """A batch of 4 FLAGSHIP ciphertexts through one BSGS gemv on the
    card gives each row's 1-D gemv residues bit for bit (diagonals
    encoded on the CPU, as test_scheme_on_cuda_bit_equal_cpu does), with
    as many NTT launches as one 1-D gemv."""
    encode_diags = G._encode_diags
    monkeypatch.setattr(G, "_encode_diags", lambda ctx, D, k, scale, device:
                        encode_diags(ctx, D, k, scale, CPU).to(device))
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.hempc.fused import make_fused_materials

    ctx, keys, rk = cli.hempc_keys(cfg.FLAGSHIP, 0, cuda_device,
                                   G.bsgs_rotations(cfg.FLAGSHIP.slots))
    model, plant = cli.cstr_setup()
    mats = make_fused_materials(ctx, rk, model, plant, 4, cuda_device)
    vals = torch.from_numpy(np.random.default_rng(8).uniform(
        -0.01, 0.01, (4, ctx.slots))).to(cuda_device)
    ct = S.encrypt(ctx, keys, S.encode(ctx, (vals, torch.zeros_like(vals)),
                                       ctx.max_limbs), NumpySampler(4))
    ntt_cuda.reset_launches()
    got = G.gemv_apply(ctx, mats, ct).data
    batched = dict(ntt_cuda.LAUNCHES)
    for i in range(4):
        ntt_cuda.reset_launches()
        one = G.gemv_apply(ctx, mats, S.Ciphertext(ct.data[i], ct.scale)).data
        assert dict(ntt_cuda.LAUNCHES) == batched
        assert torch.equal(got[i], one), i


@pytest.mark.parametrize("slots", [2, 4, 8, 16, 32, 64])
def test_matrix_embedding_of_one_row_on_cuda_keeps_its_bits(cuda_device, slots):
    """A 1-D matrix-branch embed on the card is the row-times-matrix
    product a batch takes; it gives the transposed matrix-vector product
    ``(ReE.T @ re + ImE.T @ im) / s`` bit for bit, so 1-D encodes on the
    card are what they were before the batch axis."""
    from hectr_tpu_torch.ckks import encoding as E

    ReE, ImE = E._device_embedding(slots, cuda_device)
    rng = np.random.default_rng(slots)
    for _ in range(20):
        re, im = (torch.from_numpy(rng.uniform(-3, 3, slots)).to(cuda_device)
                  for _ in range(2))
        assert torch.equal(E.embed_ri(re, im, slots),
                           (ReE.T @ re + ImE.T @ im) / slots)


def test_batched_matvec_on_cuda_is_one_product_near_each_row(cuda_device):
    """On the card a batch of rows goes through one product; each row
    lies within 1e-12 of its own 1-D product."""
    from hectr_tpu_torch.utils.rows import matvec

    rng = np.random.default_rng(3)
    M = torch.from_numpy(rng.normal(size=(5, 7))).to(cuda_device)
    x = torch.from_numpy(rng.normal(size=(64, 7))).to(cuda_device)
    got = matvec(M, x)
    assert got.shape == (64, 5)
    for i in range(64):
        assert float((got[i] - M @ x[i]).abs().max()) <= 1e-12


# ---- the limb axis on the card ----------------------------------------------


@pytest.fixture(scope="module")
def flagship_card():
    """FLAGSHIP keys (6 BSGS rotation keys) and a ciphertext on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    device = torch.device("cuda", torch.cuda.current_device())
    ctx = make_context(cfg.FLAGSHIP)
    keys = S.keygen(ctx, S.TorchSampler(0, device), device)
    rk = K.gen_rotation_keys(ctx, keys, S.TorchSampler(1, device),
                             rotations=G.bsgs_rotations(ctx.slots))
    v = torch.linspace(-1, 1, ctx.slots, dtype=torch.float64, device=device)
    ct = S.encrypt(ctx, keys, S.encode(ctx, (v, torch.zeros_like(v)),
                                       ctx.max_limbs),
                   S.TorchSampler(2, device))
    return ctx, keys, rk, v, ct, device


@pytest.mark.parametrize("size", [2, 3])
def test_limb_ops_on_cuda_bit_equal_single_device(flagship_card, size):
    """LimbOps at FLAGSHIP (22 + 2 rows) on a local limb mesh on the card:
    rescale_pair, the digit decomposition, key_switch, rotate and the
    BSGS gemv bit-equal to the single-device ops there; decrypted and
    decoded to 1e-6."""
    from hectr_tpu_torch.parallel import make_mesh
    from hectr_tpu_torch.parallel.limb_ops import LimbOps

    ctx, keys, rk, v, ct, device = flagship_card
    k = ctx.max_limbs
    ops = LimbOps(ctx, make_mesh(limb=size, device=device))
    lct = ops.shard_ct(ct)
    pt2 = S.encode(ctx, (torch.full_like(v, 2.0), torch.zeros_like(v)), k,
                   scale=ctx.pair_scale(k))
    prod = S.mul_pt(ctx, ct, pt2)
    got = ops.rescale_pair(ops.shard_ct(prod))
    assert torch.equal(ops.gather_ct(got).data, S.rescale_pair(ctx, prod).data)
    digits = ops.decompose(ops.shard_data(ct.data[1]), k)
    want = K.decompose_digits(ctx, ct.data[1])
    for s, part in zip(ops.held, digits):
        rows = torch.cat([torch.arange(*ops.rows.data_rows(s, k)),
                          k + torch.arange(*ops.rows.special_rows(s))])
        assert torch.equal(part, want.index_select(-2, rows.to(device)))
    keys_l = ops.shard_keys(rk)
    ks = ops.key_switch(ops.shard_data(ct.data[1]), keys_l[1], k)
    assert torch.equal(torch.cat(ks, dim=-2),
                       K.key_switch(ctx, ct.data[1], rk[1]))
    rot = ops.rotate(lct, 1, keys_l)
    assert torch.equal(ops.gather_ct(rot).data, K.rotate(ctx, ct, 1, rk).data)
    M = np.random.default_rng(3).normal(size=(16, 16)) / 4
    mat = ops.gemv_materials(M, k, rk, device, "bsgs")
    gv = ops.gemv_apply(mat, lct)
    want_gv = G.gemv_apply(ctx, G.gemv_materials(ctx, M, k, rk, device, "bsgs"),
                           ct)
    assert torch.equal(ops.gather_ct(gv).data, want_gv.data)
    lk = ops.shard_keyset(keys)
    dec = ops.decode(ops.decrypt(lk, gv)).cpu().numpy()
    assert np.max(np.abs(dec.real - M @ v.cpu().numpy())) < 1e-6
    assert set(ops.gathered) == {"rescale row", "digit stack",
                                 "special rows", "decode digits"}


def test_limb_regulator_on_cuda_equals_unsharded(flagship_card):
    """Two closed-loop steps over two loops with the FLAGSHIP regulator on
    LocalLimbMesh(2) on the card: x and u exactly the unsharded batched
    regulator's on the same draws."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.control.simulate import simulate_batch
    from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
    from hectr_tpu_torch.parallel import make_mesh
    from hectr_tpu_torch.parallel.limb_ops import LimbOps

    ctx, keys, rk, _, _, device = flagship_card
    model, plant = cli.cstr_setup()
    p = np.stack([cli.disturbance(2) + 0.01 * b for b in range(2)])
    out = []
    for ops in (LimbOps(ctx, make_mesh(limb=2, device=device)), None):
        reg = make_hempc_regulator(ctx, keys, rk, model, plant, 4, ops=ops)
        out.append(simulate_batch(
            model, plant, p, 1.0, 2, device, reg,
            hempc_init_state(S.TorchSampler(9, device), device, (2,)), 4))
    (x, u, (_, c)), (x1, u1, (_, c1)) = out
    assert np.array_equal(x, x1) and np.array_equal(u, u1)
    assert torch.equal(c, c1) and bool((c < 1e-5).all())


# ---- the batched encrypted QP and the bench entry point on the card ---------


def test_batched_qp_on_cuda_rows_equal_cpu(cuda_device, monkeypatch):
    """The constrained regulator over 3 loops, two steps with u fed back,
    at a logN=8 ring of 18 + 2 limbs (degree 3, one iteration), on the
    card and on the CPU from the same draws, the gemv diagonals and the
    QP's constants encoded on the CPU for both: every uploaded and
    decrypted ciphertext bit-equal wherever the row's input encodes
    agree (the card's float64 embedding may round an ulp apart), u
    within 1e-12 everywhere."""
    from chip_smoke import RowDraws, spy_regulator
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.bench import batch as BB
    from hectr_tpu_torch.control.mpc import MPCBounds
    from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
    from hectr_tpu_torch.hempc import qp_enc as Q

    encode_diags = G._encode_diags
    monkeypatch.setattr(G, "_encode_diags", lambda ctx, D, k, scale, device:
                        encode_diags(ctx, D, k, scale, CPU).to(device))
    const_pt = Q._const_pt

    def const_on_cpu(ctx, v, k, scale, device):
        pt = const_pt(ctx, v, k, scale, CPU)
        return S.Plaintext(pt.data.to(device), pt.scale)

    monkeypatch.setattr(Q, "_const_pt", const_on_cpu)
    ctx = make_context(cfg.CKKSPreset(name="cuda-qp", logn=8, slots=16,
                                      scale_bits=50, limb_bits=25,
                                      mult_depth=8, special_limbs=2,
                                      digit_width=2))
    model, plant = cli.cstr_setup()
    bounds = MPCBounds(dumin=np.array([-0.25, -0.004]),
                       dumax=np.array([0.25, 0.004]))
    xs, u0 = BB.protocol_inputs(3, 2, CPU, seed=5)
    out = {}
    for dev in (CPU, cuda_device):
        keys = S.keygen(ctx, NumpySampler(0), dev)
        relin = K.gen_relin_key(ctx, keys, NumpySampler(1), compact=True)
        rk = K.gen_rotation_keys(ctx, keys, NumpySampler(2),
                                 rotations=G.bsgs_rotations(16), compact=True)
        reg = make_hempc_regulator(ctx, keys, rk, model, plant, 4,
                                   bounds=bounds, relin_key=relin, qp_iters=1,
                                   qp_degree=3, qp_input_bound=4.0)
        state = hempc_init_state(RowDraws([10, 11, 12], dev), dev, (3,))
        (us, _), rec = spy_regulator(lambda: BB.run_rounds(
            reg, state, xs.to(dev), u0.to(dev), 1))
        out[dev.type] = (us.cpu(), {k: [t.cpu() for t in v]
                                    for k, v in rec.items()})
    (us, rec), (us_c, rec_c) = out["cpu"], out["cuda"]
    assert float((us - us_c).abs().max()) <= 1e-12
    agree = 0
    for i in range(2):
        enc = range(4 * i, 4 * i + 4)
        for b in range(3):
            if all(torch.equal(rec["pt"][j][b], rec_c["pt"][j][b])
                   for j in enc):
                agree += 1
                assert all(torch.equal(rec["ct"][j][b], rec_c["ct"][j][b])
                           for j in enc)
                assert torch.equal(rec["dec"][i][b], rec_c["dec"][i][b])
    assert agree > 0


def test_suite_sections_on_cuda(cuda_device, capsys):
    """`python -m hectr_tpu_torch.bench.suite --sections
    ntt_logn15,kernel_parity` through its main(): its last line is the
    record main() returns, each section with its value, unit, gate and
    result."""
    import json

    from hectr_tpu_torch.bench import suite

    rec = suite.main(["--sections", "ntt_logn15,kernel_parity"])
    last = capsys.readouterr().out.splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(rec))
    assert list(rec["sections"]) == ["ntt_logn15", "kernel_parity"]
    for r in rec["sections"].values():
        assert r["ok"] is True and r["value"] > 0 and r["unit"] and r["gate"]
    assert rec["sections"]["ntt_logn15"]["launches"]["ntt"] > 0


# ---- the key-switch kernels: K6-K8 (ops/keyswitch_cuda.py) ----------------


def test_keyswitch_kernels_bit_equal_plain_at_the_smokes_cases(cuda_device):
    """K6-K8 against their plain versions at every case the smoke holds
    them at (bench.keyswitch_kernels.CASES), each launched."""
    from hectr_tpu_torch.bench import keyswitch_kernels as KK
    from hectr_tpu_torch.ops import keyswitch_cuda as KC

    KC.reset_launches()
    err = KK.check(cuda_device)
    assert err == {"base_convert": 0, "key_inner_product": 0,
                   "mod_down_tail": 0}
    assert all(n > 0 for n in KC.LAUNCHES.values()), KC.LAUNCHES


KS_PATHS = ("key_switch", "rotate", "mul_ct", "mul_ct compact", "diag gemv",
            "bsgs gemv", "dense gemv", "coefficient mesh rotate",
            "limb mesh key_switch")


@pytest.fixture(scope="module")
def hybrid_keys():
    """A FLAGSHIP-shaped chain at logN = 10 (two specials, width-2 digit
    groups), its keys, rotation keys and relinearisation keys (both
    layouts) from numpy draws, on the CPU."""
    ctx = make_context(cfg.CKKSPreset(
        name="cuda-ks-paths", logn=10, slots=16, scale_bits=50,
        limb_bits=25, mult_depth=3, special_limbs=2, digit_width=2))
    keys = S.keygen(ctx, NumpySampler(0), CPU)
    rk = K.gen_rotation_keys(ctx, keys, NumpySampler(1))
    relin = {c: K.gen_relin_key(ctx, keys, NumpySampler(2), compact=c)
             for c in (False, True)}
    return ctx, keys, rk, relin


def _ks_path(name, ctx, keys, rk, relin, device):
    from hectr_tpu_torch.parallel import LocalMesh, make_mesh
    from hectr_tpu_torch.parallel.coeff_ops import CoeffOps
    from hectr_tpu_torch.parallel.limb_ops import LimbOps

    k = ctx.max_limbs
    rk = {r: key.to(device) for r, key in rk.items()}
    v = torch.linspace(-1, 1, 16, dtype=torch.float64)
    pt = S.encode(ctx, (v, torch.zeros_like(v)), k)
    keys = S.KeySet(sk=keys.sk.to(device), pk=keys.pk.to(device))
    ct = S.encrypt(ctx, keys, S.Plaintext(pt.data.to(device), pt.scale),
                   NumpySampler(3))
    M = np.random.default_rng(4).normal(size=(16, 16)) / 4
    band = np.where(np.abs(np.subtract.outer(range(16), range(16))) <= 1, M, 0)
    if name == "key_switch":
        return K.key_switch(ctx, ct.data[1, :k - 1], rk[3])
    if name == "rotate":
        return K.rotate(ctx, ct, 5, rk).data
    if name.startswith("mul_ct"):
        return K.mul_ct(ctx, ct, ct, relin[name.endswith("compact")]
                        .to(device)).data
    if name == "diag gemv":
        return G.gemv(ctx, band, ct, rk, method="diag").data
    if name in ("bsgs gemv", "dense gemv"):
        m = band if name == "bsgs gemv" else M
        return G.gemv(ctx, m, ct, {r: rk[r] for r in G.bsgs_rotations(16)},
                      method="bsgs").data
    if name == "coefficient mesh rotate":
        return CoeffOps(ctx, LocalMesh(2)).rotate(ct, 1, rk).data
    ops = LimbOps(ctx, make_mesh(limb=2, device=device))
    return torch.cat(ops.key_switch(ops.shard_data(ct.data[1]),
                                    ops.shard_keys(rk)[1], k), dim=-2)


@pytest.mark.parametrize("path", KS_PATHS)
def test_every_key_switch_path_reaches_k6_k8_and_equals_cpu(
        cuda_device, monkeypatch, hybrid_keys, path):
    """Each op that switches keys, on the card, launches K6, K7 and K8 and
    gives the CPU's residues bit for bit (the gemv diagonals encoded on
    the CPU for both, as in test_scheme_on_cuda_bit_equal_cpu)."""
    from hectr_tpu_torch.ops import keyswitch_cuda as KC

    encode_diags = G._encode_diags
    monkeypatch.setattr(G, "_encode_diags", lambda ctx, D, k, scale, device:
                        encode_diags(ctx, D, k, scale, CPU).to(device))
    ctx, keys, rk, relin = hybrid_keys
    want = _ks_path(path, ctx, keys, rk, relin, CPU)
    KC.reset_launches()
    got = _ks_path(path, ctx, keys, rk, relin, cuda_device)
    torch.cuda.synchronize()
    assert all(n > 0 for n in KC.LAUNCHES.values()), KC.LAUNCHES
    assert torch.equal(got.cpu(), want)
    # every launch counted under a key that prices it
    assert sum(KC.LAUNCH_SHAPES.values()) == sum(KC.LAUNCHES.values())
    for key in KC.LAUNCH_SHAPES:
        assert bench.keyswitch_launch_work(key)[0] > 0, key


def test_keyswitch_wrappers_refuse_on_the_card(cuda_device):
    """int32 residues, mismatched shapes, a tensor left on the CPU and a
    key's strided view are refused before any launch."""
    from hectr_tpu_torch.ckks import basecvt as BC
    from hectr_tpu_torch.ops import keyswitch_cuda as KC

    ctx = make_context(cfg.FLAGSHIP)
    k, dev = ctx.max_limbs, cuda_device
    t = ctx.tables_ks(k, dev)
    gc = BC.grouped_conv_constants(ctx.digit_groups(k), t.primes, dev)
    n, R, dnum = 1 << 15, len(t.primes), ctx.dnum(k)
    x = residues(ctx.data_primes[:k], (k, n), 0).to(dev).unflatten(
        -2, (dnum, ctx.alpha))
    digits = residues(t.primes, (dnum, R, n), 1).to(dev)
    key = residues(t.primes, (dnum, 4, R, n), 2).to(dev)
    acc = residues(t.primes, (2, R, n), 3).to(dev)
    ext = acc[:, :k].contiguous()
    pinv, pinv_sh = K._ks_constants(ctx, k, dev)
    p = ctx.tables(k, dev).p
    before = dict(KC.LAUNCHES)
    bad = [
        (lambda: KC.base_convert_cuda(x.int(), gc, True), TypeError),
        (lambda: KC.base_convert_cuda(x[:, :1].contiguous(), gc, True),
         ValueError),
        (lambda: KC.key_inner_product_cuda(digits, key.cpu(), t.p),
         ValueError),
        (lambda: KC.key_inner_product_cuda(digits[:-1], key, t.p),
         ValueError),
        (lambda: KC.key_inner_product_cuda(digits, key[:, :3], t.p),
         ValueError),
        (lambda: KC.mod_down_tail_cuda(acc[:, :k], ext.int(), pinv, pinv_sh,
                                       p), TypeError),
        (lambda: KC.mod_down_tail_cuda(acc, ext, pinv, pinv_sh, p),
         ValueError),
        (lambda: KC.mod_down_tail_cuda(acc[:, :k], ext, pinv.cpu(), pinv_sh,
                                       p), ValueError),
    ]
    for call, err in bad:
        with pytest.raises(err):
            call()
    assert KC.LAUNCHES == before


# ---- the scheme ops' kernels: K9/K10 (ops/rns_cuda.py) ---------------------


def test_rns_kernels_bit_equal_plain_at_the_smokes_cases(cuda_device):
    """K9 in every primitive at FLAGSHIP [2, 22, 2^15] and the FLAGSHIP_QP
    batch [4, 2, 32, 2^15] (broadcast, non-contiguous and permuted
    operands, random int64 words) and K10 at FLAGSHIP n1 = 4, over 4 loops
    and at MEDIUM n1 = 91, against their plain versions
    (bench.rns_kernels), each launched."""
    from hectr_tpu_torch.bench import rns_kernels as RK
    from hectr_tpu_torch.ops import rns_cuda as RC

    RC.reset_launches()
    assert RK.check(cuda_device) == {"rns_map": 0, "mod_product_sum": 0}
    assert RC.LAUNCHES["mod_product_sum"] == 3
    assert set(RC.OP_LAUNCHES) == set(RC.OPS), RC.OP_LAUNCHES


@pytest.mark.parametrize("lead", [(), (1,), (3,), (64,)])
def test_k6_spread_grid_bit_equal_plain(cuda_device, lead):
    """K6's one-group form with its target rows spread over the grid: the
    mod-down [.., 2, 2, 2^15] -> 22 rows and a rescale [.., 2, 1, 2^15] ->
    21 rows at FLAGSHIP, from one leading row (the most chunks) to 128
    (one chunk)."""
    from hectr_tpu_torch.ckks import basecvt as BC
    from hectr_tpu_torch.ops import keyswitch_cuda as KC

    ctx = make_context(cfg.FLAGSHIP)
    k = ctx.max_limbs
    for seed, (src, dst) in enumerate(((ctx.special_primes,
                                        ctx.data_primes[:k]),
                                       (ctx.data_primes[k - 1:k],
                                        ctx.data_primes[:k - 1]))):
        x = residues(src, lead + (2, len(src), 1 << 15), seed).to(cuda_device)
        c = BC.base_conv_constants(src, dst, cuda_device)
        before = KC.LAUNCHES["base_convert"]
        got = BC.base_convert(x, c)
        torch.cuda.synchronize()
        assert KC.LAUNCHES["base_convert"] == before + 1
        assert torch.equal(got, BC.base_convert_plain(x, c))


def test_one_regulator_step_launches_k9_and_k10(flagship_card):
    """One FLAGSHIP step of the reference-shaped regulator goes through K9
    and through K10 once for each of its six BSGS group sums (K_A and K_B
    each have groups 0, 2 and 3)."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.control.simulate import simulate
    from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
    from hectr_tpu_torch.ops import rns_cuda as RC

    ctx, keys, rk, _, _, device = flagship_card
    model, plant = cli.cstr_setup()
    reg = make_hempc_regulator(ctx, keys, rk, model, plant, 4)
    state = hempc_init_state(S.TorchSampler(2, device), device)
    RC.reset_launches()
    simulate(model, plant, cli.disturbance(1), 1.0, 1, device, regulator=reg,
             regulator_state=state, horizon=4, return_state=True)
    torch.cuda.synchronize()
    assert RC.LAUNCHES["mod_product_sum"] == 6
    assert RC.LAUNCHES["rns_map"] > 0
    # the decryption, the differences, the gemvs' rotated adds and sums,
    # the negation (the encryptions run through K14, the rescales through
    # K6 and K8, the decode's CRT digits through K12)
    assert set(RC.OP_LAUNCHES) == {"add_mod", "sub_mod", "neg_mod",
                                   "mul_add_mod"}, RC.OP_LAUNCHES


def test_rns_wrappers_refuse_on_the_card(cuda_device):
    """int32 operands, a constant left on the CPU, shapes that do not
    broadcast, seven unmergeable dimensions, a permutation of the wrong
    length and constants that vary along the summed axis are refused
    before any launch."""
    from hectr_tpu_torch.ops import rns_cuda as RC

    ctx = make_context(cfg.FLAGSHIP)
    t = ctx.tables(ctx.max_limbs, cuda_device)
    a = residues(t.primes, (2, len(t.primes), 1 << 15), 0).to(cuda_device)
    y = torch.zeros((2,) * 7, dtype=torch.int64, device=cuda_device)
    yt = y.permute(*reversed(range(7)))
    perm = torch.arange(1 << 14, device=cuda_device)
    C = a[None].expand(4, -1, -1, -1)
    q = torch.ones((4, 1, len(t.primes), 1), dtype=torch.int64,
                   device=cuda_device)
    before = dict(RC.LAUNCHES)
    bad = [
        (lambda: RC.rns_map("add_mod", a.int(), a, t.p), TypeError),
        (lambda: RC.rns_map("add_mod", a, a, t.p.cpu()), ValueError),
        (lambda: RC.rns_map("add_mod", a, a[:, :3], t.p), ValueError),
        (lambda: RC.rns_map("add_mod", y, yt, y), ValueError),
        (lambda: RC.rns_map("add_mod", a, a, t.p, perm=perm), ValueError),
        (lambda: RC.mod_product_sum(C, a, 0, q, t.mu, t.k), ValueError),
    ]
    for call, err in bad:
        with pytest.raises(err):
            call()
    assert RC.LAUNCHES == before


# ---- K11 / K12: encode's float64 pass and the double-double CRT decode ------


def _embedding_inputs(ctx, batch, seed, device, scale=2.0):
    rng = np.random.default_rng(seed)
    vre = torch.from_numpy(rng.uniform(-scale, scale, (*batch, ctx.slots)))
    vim = torch.from_numpy(rng.uniform(-scale, scale, (*batch, ctx.slots)))
    return vre.to(device), vim.to(device)


@pytest.mark.parametrize("preset", ["FLAGSHIP", "MEDIUM"])
def test_k11_m_entry_bit_equal_encode_embedded_plain(cuda_device, preset):
    """K11's m' entry (encode_embedded on the card) bit-equal to
    encode_embedded_plain on the card, 1-D, batched and through a
    non-contiguous m', at Delta and at a pair-of-primes scale."""
    from hectr_tpu_torch.ckks import encoding as E
    from hectr_tpu_torch.ops import codec_cuda

    ctx = make_context(getattr(cfg, preset))
    k = ctx.max_limbs
    for batch in ((), (3,), (2, 3)):
        vre, vim = _embedding_inputs(ctx, batch, len(batch), cuda_device)
        m = E.embed_ri(vre, vim, ctx.slots)
        for mm in (m, torch.cat([m, m], -1)[..., ::2]):
            for scale in (ctx.delta, ctx.pair_scale(k)):
                before = codec_cuda.LAUNCHES["encode_residues"]
                got = S.encode_embedded(ctx, mm, k, scale)
                assert codec_cuda.LAUNCHES["encode_residues"] == before + 1
                want = S.encode_embedded_plain(ctx, mm, k, scale)
                assert torch.equal(got.data, want.data), (batch, scale)


@pytest.mark.parametrize("preset", ["REFERENCE_HEMPC", "FLAGSHIP",
                                    "FLAGSHIP_QP"])
def test_k11_fused_embedding_against_plain_composition(cuda_device, preset):
    """K11 with the embedding fused, on the card: bit-equal to the plain
    integer stage of its fixed-order embedding; against the plain
    composition (cuBLAS's product) equal except at coefficients where the
    two float64 embeddings round apart, each within one unit of y (their
    count is printed); every batch row bit-equal to its 1-D encode."""
    from hectr_tpu_torch.bench.codec_kernels import embed_in_kernel_order
    from hectr_tpu_torch.ckks import encoding as E

    ctx = make_context(getattr(cfg, preset))
    k = ctx.max_limbs
    s, stride = ctx.slots, ctx.n // (2 * ctx.slots)
    ReE, ImE = E.device_embedding(s, cuda_device)
    apart = total = 0
    for batch, scale in (((), ctx.delta), ((4,), ctx.pair_scale(k)),
                         ((2, 3), ctx.delta)):
        vre, vim = _embedding_inputs(ctx, batch, 7 + len(batch), cuda_device)
        got = S.encode(ctx, (vre, vim), k, scale).data
        m_order = embed_in_kernel_order(vre, vim, ReE, ImE)
        assert torch.equal(got, S.encode_embedded_plain(ctx, m_order, k,
                                                        scale).data)
        m_plain = E.embed_ri(vre, vim, s)
        y_order = torch.round(m_order * float(scale))
        y_plain = torch.round(m_plain * float(scale))
        assert float((y_order - y_plain).abs().max()) <= 1
        p = ctx.tables(k, cuda_device).p
        rows = E.encode_rows(vre, vim, s, float(scale), p, ctx.n)
        rows_plain = E.coefficient_rows_plain(m_plain, float(scale), p, ctx.n)
        same = (rows == rows_plain)[..., ::stride].all(dim=-2)
        differ = y_order != y_plain
        assert bool(same[~differ].all()) and not bool(same[differ].any())
        apart += int(differ.sum())
        total += differ.numel()
        for b in np.ndindex(*batch):
            assert torch.equal(S.encode(ctx, (vre[b], vim[b]), k, scale).data,
                               got[b])
    print(f"{preset}: {apart} of {total} coefficients rounded one unit apart "
          f"from the plain composition")


@pytest.mark.parametrize("preset", ["REFERENCE_HEMPC", "FLAGSHIP", "MEDIUM"])
def test_k12_values_bit_equal_plain_chain(cuda_device, preset):
    """K12's y bit-equal to the plain double-double chain (run on the CPU:
    PyTorch on the card divides by a CPU scalar through its reciprocal,
    the JAX package and the kernel by IEEE division), its unembedded
    values within 1e-12 x max(1, |plain|) of the plain unembedding, its
    digits entry equal to the coefficients' entry, batch rows bit-equal to
    their 1-D decode."""
    from hectr_tpu_torch.ckks import encoding as E
    from hectr_tpu_torch.ckks.modmath import mul_mod_plain
    from hectr_tpu_torch.ops import codec_cuda

    ctx = make_context(getattr(cfg, preset))
    stride = ctx.n // (2 * ctx.slots)
    for limbs, batch in ((1, ()), (2, (3,)), (ctx.max_limbs, (2, 3))):
        vre, vim = _embedding_inputs(ctx, batch, limbs, cuda_device)
        pt = S.encode(ctx, (vre, vim), limbs)
        k = min(limbs, len(ctx.base_primes))
        t = ctx.tables(k, cuda_device)
        dc = ctx.decode_constants(k, pt.scale, cuda_device)
        x = T.intt(pt.data[..., :k, :], t)[..., ::stride]
        digits = mul_mod_plain(x, dc.inv, t.p, t.mu, t.k)
        y_plain = S.crt_values_plain(digits.cpu(), dc)
        q = (dc.q_over_scale_hi, dc.q_over_scale_lo)
        y = codec_cuda.crt_decode(x, t.p, *q, (dc.inv, t.mu, t.k))
        assert torch.equal(y.cpu(), y_plain)
        assert torch.equal(codec_cuda.crt_decode(digits, t.p, *q).cpu(),
                           y_plain)
        re, im = S.decode_ri(ctx, pt)
        for got, want in zip((re, im), E.unembed(y_plain.to(cuda_device),
                                                 ctx.slots)):
            assert bool(((got - want).abs()
                         <= 1e-12 * want.abs().clamp(min=1)).all())
        if limbs >= len(ctx.base_primes):
            assert float((re - vre).abs().max()) <= 1e-6
        for b in np.ndindex(*batch):
            r1, i1 = S.decode_ri(ctx, S.Plaintext(pt.data[b], pt.scale))
            assert torch.equal(r1, re[b]) and torch.equal(i1, im[b])


@pytest.mark.parametrize("preset", ["REFERENCE_HEMPC", "FLAGSHIP"])
def test_decode_roundtrip_on_cuda_inside_the_loop_bars(cuda_device, preset):
    """encrypt(encode(v)) decrypted and decoded through K11/K12 on the
    card: within tests/test_hempc.py's per-channel bar (5e-10) of v and
    with an imaginary residue under its canary (1e-5); K11 and K12 each
    launched once an encode and a decode."""
    from hectr_tpu_torch.ops import codec_cuda

    ctx = make_context(getattr(cfg, preset))
    keys = S.keygen(ctx, S.TorchSampler(0, cuda_device), cuda_device)
    v = torch.linspace(-1, 1, ctx.slots, dtype=torch.float64,
                       device=cuda_device)
    codec_cuda.reset_launches()
    ct = S.encrypt(ctx, keys, S.encode(ctx, (v, torch.zeros_like(v)),
                                       ctx.max_limbs),
                   S.TorchSampler(1, cuda_device))
    re, im = S.decode_ri(ctx, S.decrypt(ctx, keys, ct))
    assert codec_cuda.LAUNCHES == {"encode_residues": 1, "crt_decode": 1}
    assert float((re - v).abs().max()) < 5e-10
    assert float(im.abs().max()) < 1e-5


def test_codec_wrappers_refuse_on_the_card(cuda_device):
    """int32 slot values, primes left on the CPU, an embedding of the wrong
    width, more than 128 coefficients to unembed and five unmergeable batch
    dimensions are refused before any launch."""
    from hectr_tpu_torch.ckks import encoding as E
    from hectr_tpu_torch.ops import codec_cuda

    ctx = make_context(cfg.FLAGSHIP)
    p = ctx.tables(2, cuda_device).p
    ReE, ImE = E.device_embedding(16, cuda_device)
    v = torch.zeros(16, dtype=torch.float64, device=cuda_device)
    x = torch.zeros((2, 256), dtype=torch.int64, device=cuda_device)
    deep = torch.zeros((2,) * 5 + (16,), dtype=torch.float64,
                       device=cuda_device).permute(4, 3, 2, 1, 0, 5)
    before = dict(codec_cuda.LAUNCHES)
    bad = [
        (lambda: codec_cuda.encode_slots(v.int(), v, ReE, ImE, 1.0, p, 1 << 15),
         TypeError),
        (lambda: codec_cuda.encode_slots(v, v, ReE, ImE, 1.0, p.cpu(),
                                         1 << 15), ValueError),
        (lambda: codec_cuda.encode_slots(v, v, ReE[:8], ImE, 1.0, p, 1 << 15),
         ValueError),
        (lambda: codec_cuda.crt_decode(x, p, 1.0, 0.0, None, (ReE, ImE)),
         ValueError),
        (lambda: codec_cuda.encode_slots(deep, deep, ReE, ImE, 1.0, p,
                                         1 << 15), ValueError),
    ]
    for call, err in bad:
        with pytest.raises(err):
            call()
    assert codec_cuda.LAUNCHES == before
