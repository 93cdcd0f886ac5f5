"""Encode's float64 pass and decode's double-double CRT (the plain versions
of the kernels K11 and K12, ``ops/codec_cuda.py``) held against the JAX
package, and the wrappers' checks, plans and dispatch on the CPU.

The same numpy-seeded inputs go through ``hectr_tpu`` (jitted, vmapped
over batch rows) and through the port's plain versions:

  * encode: given the same embedded coefficients m', the plaintexts are
    bit-equal (``JS.embed_ri`` is replaced in the JAX module by one that
    hands m' through, so the JAX side runs its own rounding, residues,
    spread and NTT on it).  The two packages' float64 embeddings
    themselves (XLA's dot and FFT against PyTorch's) round apart, so they
    are held to 1e-12 in tests/test_torch_scheme.py, not here.
  * decode: the values over the scale y (the double-double chain's
    output; ``unembed`` replaced in both modules by one that hands y out)
    are bit-equal, and the port's (re, im) are bit-equal to its own
    unembedding of the JAX package's y (within 1e-12 of the JAX package's
    unembedding, whose matrix product sums in another order).

A numpy model of the kernels, reached through the wrappers' real plans
(pointers, merged batch strides, the C entry points' arguments), stands in
for the card in the rehearsal tests: every dispatching path (scheme
encode/decode, the FFT branch, LimbOps, the bench's cases) runs through it
and is held to the plain versions and to the kernels' fixed-order sums.
"""

import ctypes
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu import config as jcfg
from hectr_tpu.ckks import encoding as jenc
from hectr_tpu.ckks import scheme as JS
from hectr_tpu.ckks.context import make_context as jmake_context
from hectr_tpu_torch import bench
from hectr_tpu_torch import config as tcfg
from hectr_tpu_torch.bench import codec_kernels as CK
from hectr_tpu_torch.ckks import dd
from hectr_tpu_torch.ckks import encoding as tenc
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.ckks.context import make_context
from hectr_tpu_torch.ckks.modmath import mul_mod_plain
from hectr_tpu_torch.ckks.ntt import intt
from hectr_tpu_torch.ops import codec_cuda

torch.set_num_threads(1)

CPU = torch.device("cpu")


def contexts(slots, logn, depth=3):
    fields = dict(name=f"codec-{slots}-{logn}", logn=logn, slots=slots,
                  scale_bits=50, limb_bits=25, mult_depth=depth)
    return (make_context(tcfg.CKKSPreset(**fields)),
            jmake_context(jcfg.CKKSPreset(**fields)))


def vmapped(fn, batch):
    """fn over `batch` leading dimensions, jitted."""
    for _ in batch:
        fn = jax.vmap(fn)
    return jax.jit(fn)


def jax_encode_given(jctx, m, k, scale, monkeypatch):
    """The JAX package's encode of the embedded coefficients m (numpy
    [*batch, 2s]) at k limbs: its embed_ri hands m through."""
    monkeypatch.setattr(JS, "embed_ri", lambda vre, vim, s: vre)
    fn = vmapped(lambda a: JS.encode(jctx, (a, jnp.zeros_like(a)), k,
                                     scale).data, m.shape[:-1])
    return np.asarray(fn(jnp.asarray(m)))


def embedded(rng, ctx, batch, scale=1.0):
    """Real subring coefficients of random slot values, through the port's
    embedding on the CPU."""
    vre = rng.uniform(-scale, scale, (*batch, ctx.slots))
    vim = rng.uniform(-scale, scale, (*batch, ctx.slots))
    return tenc.embed_ri(torch.from_numpy(vre), torch.from_numpy(vim),
                         ctx.slots)


# ---- encode: the plain float64 pass against the JAX package ---------------


@pytest.mark.parametrize("slots,logn,ks,batch", [
    (4, 8, (1, 2), ()),
    (16, 9, (3,), (3,)),
    (64, 10, (6,), (2, 3)),
    (128, 8, (4, 5), (3,)),      # the FFT branch
])
def test_encode_plain_bit_equal_jax(slots, logn, ks, batch, monkeypatch):
    ctx, jctx = contexts(slots, logn)
    m = embedded(np.random.default_rng(slots + logn), ctx, batch, 3.0)
    for k in ks:
        pt = TS.encode_embedded(ctx, m, k)
        want = jax_encode_given(jctx, m.numpy(), k, jctx.delta, monkeypatch)
        assert pt.data.shape == (*batch, k, ctx.n)
        assert np.array_equal(pt.data.numpy(), want.astype(np.int64))


def test_encode_every_row_count_and_the_qp_scale(monkeypatch):
    """k = 1 to 6 rows at the context's Delta, and the QP's compensating
    scale (a pair of primes' product, not a power of two)."""
    ctx, jctx = contexts(16, 9)
    m = embedded(np.random.default_rng(7), ctx, (2,), 5.0)
    for k in range(1, 7):
        for scale in ((ctx.delta, ctx.pair_scale(k)) if k in (3, 6)
                      else (ctx.delta,)):
            got = TS.encode_embedded(ctx, m, k, scale)
            want = jax_encode_given(jctx, m.numpy(), k, scale, monkeypatch)
            assert got.scale == scale
            assert np.array_equal(got.data.numpy(), want.astype(np.int64))


def test_integer_stage_edges_bit_equal_jax(monkeypatch):
    """y = 0, +-1, negative values, and |y| at and near 2^27, 2^54 and 2^59
    through the whole encode (scale 1, so y = round(m'))."""
    ctx, jctx = contexts(16, 8)
    edges = [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 1.5, -2.5,
             2.0**27 - 1, 2.0**27, -(2.0**27 + 1),
             2.0**54 - 2, 2.0**54, -(2.0**54), 2.0**54 + 4, -(2.0**54 + 8),
             2.0**59, -(2.0**59), 2.0**59 - 64, -(2.0**59 - 128),
             2.0**59 + 2.0**54 + 2.0**27 + 1e3, -(2.0**58 + 3.0)]
    rng = np.random.default_rng(11)
    m = np.concatenate([edges, np.round(rng.uniform(-2**59, 2**59, 10))])
    m = m[:2 * ctx.slots].reshape(1, -1)
    m = np.concatenate([m, -m])                         # [2, 32]
    got = TS.encode_embedded(ctx, torch.from_numpy(m), 4, Fraction(1))
    want = jax_encode_given(jctx, m, 4, Fraction(1), monkeypatch)
    assert np.array_equal(got.data.numpy(), want.astype(np.int64))
    # and the residues themselves against exact integers
    p = ctx.tables(4, CPU).p
    rows = tenc.coefficient_rows_plain(torch.from_numpy(m), 1.0, p, ctx.n)
    y = np.round(m).astype(np.int64).astype(object)
    exact = np.stack([(y % int(q)).astype(np.int64) for q in p[:, 0]], -2)
    assert np.array_equal(rows[..., ::ctx.n // 32].numpy(), exact)
    assert not rows.numpy()[..., 1::ctx.n // 32].any()


# ---- decode: the double-double chain against the JAX package ---------------


def _values_out(monkeypatch):
    """Both packages' decode returns y (unembed hands it out)."""
    monkeypatch.setattr(JS, "unembed", lambda y, s: (y, y))
    monkeypatch.setattr(TS, "unembed", lambda y, s: (y, y))


@pytest.mark.parametrize("slots,logn,batch", [
    (4, 8, ()), (16, 9, (3,)), (64, 10, (2, 3)), (128, 8, (3,))])
def test_decode_values_bit_equal_jax(slots, logn, batch, monkeypatch):
    """Every decode level 1 to the base count (and a plaintext above it,
    decoded over the base chain)."""
    ctx, jctx = contexts(slots, logn)
    rng = np.random.default_rng(slots * logn)
    m = embedded(rng, ctx, batch, 2.0)
    base = len(ctx.base_primes)
    junembed = vmapped(lambda a: jenc.unembed(a, slots), batch)
    for limbs in (*range(1, base + 1), base + 2):
        pt = TS.encode_embedded(ctx, m, limbs)
        with monkeypatch.context() as mp:
            _values_out(mp)
            y, _ = TS.decode_ri(ctx, pt)
            jy, _ = vmapped(lambda d: JS.decode_ri(
                jctx, JS.Plaintext(data=d, scale=pt.scale)), batch)(
                    jnp.asarray(pt.data.numpy().astype(np.uint32)))
        assert y.shape == (*batch, 2 * slots)
        assert np.array_equal(y.numpy(), np.asarray(jy))
        # the unembedded slots: the port's own unembedding of that y
        re, im = TS.decode_ri(ctx, pt)
        ure, uim = tenc.unembed(torch.from_numpy(np.array(jy)), slots)
        assert torch.equal(re, ure) and torch.equal(im, uim)
        # and the JAX package's unembedding of it (decode_ri's last step)
        jre, jim = junembed(jy)
        assert np.max(np.abs(re.numpy() - np.asarray(jre))) <= 1e-12
        assert np.max(np.abs(im.numpy() - np.asarray(jim))) <= 1e-12
        if limbs >= base:
            assert np.max(np.abs(y.numpy() - m.numpy())) <= 1e-9


def test_crt_values_edges_bit_equal_jax_dd():
    """The chain on digits at 0, 1, p - 1 and (p - 1) / 2 of each row,
    against the JAX package's dd functions in decode_ri's order."""
    from hectr_tpu.ckks import dd as jdd

    ctx, _ = contexts(16, 8)
    k = len(ctx.base_primes)
    dc = ctx.decode_constants(k, ctx.delta, CPU)
    p = np.array(ctx.base_primes, dtype=np.int64)[:, None]
    rng = np.random.default_rng(3)
    c = np.concatenate([np.zeros((k, 1), np.int64), np.ones((k, 1), np.int64),
                        p - 1, (p - 1) // 2,
                        rng.integers(0, p, (k, 28))], axis=1)
    got = TS.crt_values_plain(torch.from_numpy(c), dc)

    def chain(cj):
        hi = jnp.zeros(cj.shape[-1], jnp.float64)
        lo = jnp.zeros_like(hi)
        for i in range(k):
            term = jdd.dd_div_ff(cj[i].astype(jnp.float64), dc.p_f64[i, 0])
            hi, lo = jdd.dd_add((hi, lo), term)
        r = jdd.dd_round((hi, lo))
        frac = jdd.dd_add_f((hi, lo), -r)
        return jdd.dd_to_float(jdd.dd_mul(frac, (
            jnp.float64(dc.q_over_scale_hi), jnp.float64(dc.q_over_scale_lo))))
    assert np.array_equal(got.numpy(), np.asarray(jax.jit(chain)(
        jnp.asarray(c))))


# ---- the wrappers' checks ---------------------------------------------------


def _operands(device="cpu"):
    s, n = 16, 1 << 9
    f = dict(dtype=torch.float64, device=device)
    i = dict(dtype=torch.int64, device=device)
    return dict(v=torch.zeros((3, s), **f), E=torch.zeros((s, 2 * s), **f),
                m=torch.zeros((3, 2 * s), **f), p=torch.ones((5, 1), **i),
                x=torch.zeros((3, 2, 2 * s), **i), c=torch.ones((2, 1), **i),
                n=n)


def test_wrappers_refuse_cpu_and_meta_tensors_before_building():
    codec_cuda.reset_launches()
    for device in ("cpu", "meta"):
        o = _operands(device)
        calls = [
            lambda: codec_cuda.encode_slots(o["v"], o["v"], o["E"], o["E"],
                                            2.0**20, o["p"], o["n"]),
            lambda: codec_cuda.encode_coefficients(o["m"], 2.0**20, o["p"],
                                                   o["n"]),
            lambda: codec_cuda.crt_decode(o["x"], o["c"], 1.0, 0.0),
            lambda: codec_cuda.crt_decode(o["x"], o["c"], 1.0, 0.0,
                                          (o["c"], o["c"], o["c"]),
                                          (o["E"], o["E"])),
        ]
        for call in calls:
            with pytest.raises(ValueError, match="given tensors on"):
                call()
    assert codec_cuda.LAUNCHES == {"encode_residues": 0, "crt_decode": 0}
    assert codec_cuda.library.cache_info().currsize == 0


def test_wrapper_checks_come_in_the_order_dtype_shape_device():
    o = _operands()
    v32 = o["v"].float()
    bad_shape = torch.zeros((3, 5), dtype=torch.float64)
    # a wrong dtype is named first, even with a wrong shape, off the card
    with pytest.raises(TypeError, match="float64"):
        codec_cuda.encode_slots(v32, bad_shape, o["E"], o["E"], 1.0, o["p"],
                                o["n"])
    with pytest.raises(TypeError, match="not a tensor"):
        codec_cuda.encode_coefficients(o["m"].numpy(), 1.0, o["p"], o["n"])
    with pytest.raises(TypeError, match="int64"):
        codec_cuda.crt_decode(o["x"].int(), o["c"][:1], 1.0, 0.0)
    # then the shape, off the card
    with pytest.raises(ValueError, match="one shape"):
        codec_cuda.encode_slots(o["v"], bad_shape, o["E"], o["E"], 1.0,
                                o["p"], o["n"])
    with pytest.raises(ValueError, match=r"\[16, 32\]"):
        codec_cuda.encode_slots(o["v"], o["v"], o["E"][:, :8], o["E"], 1.0,
                                o["p"], o["n"])
    with pytest.raises(ValueError, match="column"):
        codec_cuda.encode_coefficients(o["m"], 1.0, o["p"][:, 0], o["n"])
    with pytest.raises(ValueError, match="spread"):
        codec_cuda.encode_coefficients(o["m"], 1.0, o["p"], 48)
    with pytest.raises(ValueError, match="column"):
        codec_cuda.crt_decode(o["x"], o["p"], 1.0, 0.0)
    wide = torch.zeros((2, 256), dtype=torch.int64)
    with pytest.raises(ValueError, match="unembedding"):
        codec_cuda.crt_decode(wide, o["c"], 1.0, 0.0, None, (o["E"], o["E"]))
    with pytest.raises(ValueError, match="at most 4"):
        codec_cuda.batch_plan((2, 3, 4, 5, 6), [(1, 0, 7, 0, 11)])
    # and only then the device
    with pytest.raises(ValueError, match="given tensors on"):
        codec_cuda.encode_slots(o["v"], o["v"], o["E"], o["E"], 1.0, o["p"],
                                o["n"])


def test_batch_plan_merges_leading_dimensions():
    # contiguous [2, 3, s]: one batch dimension; a zero vector expanded
    # over it has stride 0 there
    assert codec_cuda.batch_plan((2, 3), [(48, 16), (0, 0)]) == (
        [6], [[16], [0]])
    # a strided view [..., :k, ::stride] of [2, 3, K, N] rows: [2, 3] merge
    assert codec_cuda.batch_plan((2, 3), [(3 * 5 * 64, 5 * 64)]) == (
        [6], [[5 * 64]])
    # no batch at all: one dimension of size 1
    assert codec_cuda.batch_plan((), [()]) == ([1], [[0]])
    # dimensions that do not merge stay apart
    assert codec_cuda.batch_plan((2, 3), [(100, 16)]) == ([2, 3],
                                                          [[100, 16]])


def test_dispatching_functions_refuse_meta():
    o = _operands("meta")
    ctx, _ = contexts(16, 9)
    dc = ctx.decode_constants(2, ctx.delta, CPU)
    for call in (lambda: tenc.encode_rows(o["v"], o["v"], 16, 1.0, o["p"],
                                          o["n"]),
                 lambda: tenc.coefficient_rows(o["m"], 1.0, o["p"], o["n"]),
                 lambda: TS.crt_decode(ctx, o["x"], dc)):
        with pytest.raises(NotImplementedError):
            call()


def test_codec_work_counts_bytes_and_operations():
    # K11 at FLAGSHIP: re and im [16], ReE and ImE [16, 32], 22 primes in,
    # 22 rows of 2^15 out: 5.77 MB, 1.72 us at 3.35 TB/s
    nbytes, flops = bench.codec_work("encode_residues", 1, 22, 32,
                                     n=1 << 15, fused=True,
                                     in_numels=[16, 16])
    assert nbytes == 8 * (32 + 2 * 16 * 32 + 22 + 22 * (1 << 15))
    assert flops == 32 * (4 * 16 + 2) + 32 * 22 * 8
    ms, by = bench.codec_bound("encode_residues", 1, 22, 32, n=1 << 15,
                               fused=True, in_numels=[16, 16])
    assert by == "bytes" and abs(ms - 1.724e-3) < 1e-6
    # the m' entry reads m' and the primes only
    assert bench.codec_work("encode_residues", 1, 12, 16384, n=16384,
                            in_numels=[16384])[0] == 8 * (16384 + 12
                                                          + 12 * 16384)
    # K12 at FLAGSHIP: 2 rows x 32 words at a stride of 1024 (a sector
    # each), p, inv, mu, k, the two matrices, 32 values out
    nbytes, flops = bench.codec_work("crt_decode", 1, 2, 32, col_stride=1024,
                                     unembed=True)
    assert nbytes == 2 * 32 * 32 + 8 * 2 * 4 + 8 * 2 * 16 * 32 + 8 * 32
    assert flops == 32 * (35 * 2 + 40 + 64)
    # contiguous digits: 8 bytes a word, p alone
    assert bench.codec_work("crt_decode", 4, 2, 32, digits=True)[0] == (
        4 * 2 * 32 * 8 + 8 * 2 + 8 * 4 * 32)
    with pytest.raises(ValueError):
        bench.codec_work("ntt", 1, 1, 1)


# ---- rehearsal: a numpy model of the kernels behind the real wrappers -----


def _view(ptr, dtype, shape, strides):
    """A numpy view of memory at address ptr, strides in elements."""
    ctype = ctypes.c_double if dtype == np.float64 else ctypes.c_int64
    base = np.ctypeslib.as_array((ctype * 1).from_address(ptr))
    return np.lib.stride_tricks.as_strided(
        base, shape=tuple(shape), strides=[8 * s for s in strides])


class KernelModel:
    """The C entry points of csrc/codec.cu in numpy and plain PyTorch CPU
    ops: the same arguments, the same operation order."""

    def __init__(self):
        self.calls = {"encode": 0, "decode": 0}

    def hectr_encode_residues(self, nbatch, bsizes, bstrides, in0, in1, cs0,
                              cs1, re_e, im_e, width, primes, pstride, rows,
                              n, scale, out, stream):
        sizes, st = list(bsizes), list(bstrides)
        assert len(sizes) == nbatch and stream is None
        if re_e is not None:
            s = width // 2
            vre = _view(in0, np.float64, sizes + [s], st[:nbatch] + [cs0])
            vim = _view(in1, np.float64, sizes + [s], st[nbatch:] + [cs1])
            ReE = _view(re_e, np.float64, [s, width], [width, 1])
            ImE = _view(im_e, np.float64, [s, width], [width, 1])
            sr = np.zeros(sizes + [width])
            si = np.zeros(sizes + [width])
            for i in range(s):
                sr = sr + ReE[i] * vre[..., i:i + 1]
            for i in range(s):
                si = si + ImE[i] * vim[..., i:i + 1]
            m = (sr + si) / s
        else:
            m = _view(in0, np.float64, sizes + [width], st + [cs0])
        y = np.rint(m * scale)
        p = _view(primes, np.int64, [rows, 1], [pstride, 0])
        neg = y < 0
        a = np.abs(y)
        a1 = np.floor(a / 2.0**54)
        r1 = a - a1 * 2.0**54
        a2 = np.floor(r1 / 2.0**27)
        a3 = r1 - a2 * 2.0**27
        a1, a2, a3 = (x.astype(np.int64)[..., None, :] for x in (a1, a2, a3))
        r = np.remainder(a1 * np.remainder(1 << 54, p)
                         + np.remainder(a2 * np.remainder(1 << 27, p), p)
                         + a3, p)
        res = np.where(neg[..., None, :] & (r != 0), p - r, r)
        batch = int(np.prod(sizes))
        o = _view(out, np.int64, [batch, rows, n], [rows * n, n, 1])
        o[...] = 0
        o[:, :, ::n // width] = res.reshape(batch, rows, width)
        self.calls["encode"] += 1
        return 0

    def hectr_crt_decode(self, nbatch, bsizes, bstrides, x, row_stride,
                         col_stride, rows, width, p, inv, mu, k, cstrides,
                         q_hi, q_lo, re_e, im_e, out0, out1, stream):
        sizes, st, cs = list(bsizes), list(bstrides), list(cstrides)
        assert len(sizes) == nbatch and stream is None

        def col(ptr, j):
            return torch.from_numpy(_view(ptr, np.int64, [rows, 1],
                                          [cs[j], 0]).copy())
        X = torch.from_numpy(_view(x, np.int64, sizes + [rows, width],
                                   st + [row_stride, col_stride]).copy())
        P = col(p, 0)
        if inv is not None:
            X = mul_mod_plain(X, col(inv, 1), P, col(mu, 2), col(k, 3))
        acc = (torch.zeros(X[..., 0, :].shape, dtype=torch.float64),) * 2
        for i in range(rows):
            acc = dd.dd_add(acc, dd.dd_div_ff(X[..., i, :].double(),
                                              float(P[i, 0])))
        r = dd.dd_round(acc)
        y = dd.dd_to_float(dd.dd_mul(dd.dd_add_f(acc, -r), (q_hi, q_lo)))
        batch = int(np.prod(sizes))
        if re_e is None:
            _view(out0, np.float64, [batch, width], [width, 1])[...] = \
                y.reshape(batch, width).numpy()
        else:
            s = width // 2
            E = [torch.from_numpy(_view(e, np.float64, [s, width],
                                        [width, 1]).copy())
                 for e in (re_e, im_e)]
            for o, v in zip((out0, out1), CK.unembed_in_kernel_order(y, *E)):
                _view(o, np.float64, [batch, s], [s, 1])[...] = \
                    v.reshape(batch, s).numpy()
        self.calls["decode"] += 1
        return 0


@pytest.fixture
def kernel_model(monkeypatch):
    """CPU tensors dispatched as if on the card, the kernels replaced by
    the model behind the real wrappers."""
    model = KernelModel()
    codec_cuda._PLANS.clear()
    codec_cuda.reset_launches()
    monkeypatch.setattr(tenc, "on_card", lambda x: True)
    monkeypatch.setattr(TS, "on_card", lambda x: True)
    monkeypatch.setattr(codec_cuda, "_check_device",
                        lambda name, ts: ts[0].device)
    monkeypatch.setattr(codec_cuda, "library", lambda: model)
    monkeypatch.setattr(codec_cuda, "launch_on",
                        lambda entry, device, *args: entry(*args, None))
    yield model
    codec_cuda._PLANS.clear()


def test_rehearsal_scheme_paths(kernel_model):
    """encode (the embedding fused, complex and (re, im) input, broadcast
    zeros, batches) and decode (the strided view, unembedded) through the
    model: bit-equal to the plain versions of the fixed-order sums, every
    batch row bit-equal to its 1-D call, one launch each."""
    ctx, _ = contexts(16, 9)
    rng = np.random.default_rng(21)
    vre = torch.from_numpy(rng.uniform(-2, 2, (2, 3, 16)))
    vim = torch.zeros(16, dtype=torch.float64).expand(2, 3, 16)
    ReE, ImE = tenc.device_embedding(16, CPU)
    k = 5
    pt = TS.encode(ctx, (vre, vim), k)
    assert kernel_model.calls["encode"] == 1
    want = TS.encode_embedded_plain(
        ctx, CK.embed_in_kernel_order(vre, vim, ReE, ImE), k)
    assert torch.equal(pt.data, want.data) and pt.scale == want.scale
    for b in np.ndindex(2, 3):
        assert torch.equal(TS.encode(ctx, (vre[b], vim[b]), k).data,
                           pt.data[b])
    z = torch.complex(vre, torch.from_numpy(rng.uniform(-1, 1, (2, 3, 16))))
    assert torch.equal(TS.encode(ctx, z, k).data, TS.encode_embedded_plain(
        ctx, CK.embed_in_kernel_order(z.real, z.imag, ReE, ImE), k).data)

    before = kernel_model.calls["decode"]
    re, im = TS.decode_ri(ctx, pt)
    assert kernel_model.calls["decode"] == before + 1
    t = ctx.tables(2, CPU)
    dc = ctx.decode_constants(2, pt.scale, CPU)
    digits = mul_mod_plain(intt(pt.data[..., :2, :], t)[..., ::16],
                           dc.inv, t.p, t.mu, t.k)
    y = TS.crt_values_plain(digits, dc)
    wre, wim = CK.unembed_in_kernel_order(y, ReE, ImE)
    assert torch.equal(re, wre) and torch.equal(im, wim)
    assert float((re - vre).abs().max()) <= 1e-9
    for b in np.ndindex(2, 3):
        r1, i1 = TS.decode_ri(ctx, TS.Plaintext(pt.data[b], pt.scale))
        assert torch.equal(r1, re[b]) and torch.equal(i1, im[b])
    assert codec_cuda.LAUNCHES["encode_residues"] == kernel_model.calls[
        "encode"]
    assert codec_cuda.LAUNCHES["crt_decode"] == kernel_model.calls["decode"]


def test_rehearsal_fft_branch_and_limb_mesh(kernel_model):
    """The m' entry (128 slots: the FFT embedding, then K11; K12's y, then
    the FFT unembedding) bit-equal to the plain path; LimbOps' encode (K11
    a shard) and decode (K12's digits entry) bit-equal to one device."""
    from hectr_tpu_torch.parallel import make_mesh
    from hectr_tpu_torch.parallel.limb_ops import LimbOps

    ctx, _ = contexts(128, 8)
    rng = np.random.default_rng(22)
    v = torch.from_numpy(rng.uniform(-1, 1, (3, 128))
                         + 1j * rng.uniform(-1, 1, (3, 128)))
    pt = TS.encode(ctx, v, 4)
    assert torch.equal(pt.data, TS.encode_embedded_plain(
        ctx, tenc.embed_ri(v.real, v.imag, 128), 4).data)
    re, im = TS.decode_ri(ctx, pt)
    t = ctx.tables(2, CPU)
    dc = ctx.decode_constants(2, pt.scale, CPU)
    wre, wim = TS.crt_decode_plain(ctx, mul_mod_plain(
        intt(pt.data[..., :2, :], t), dc.inv, t.p, t.mu, t.k), dc)
    assert torch.equal(re, wre) and torch.equal(im, wim)

    ctx, _ = contexts(16, 9, depth=3)
    vre = torch.from_numpy(rng.uniform(-1, 1, (2, 16)))
    vim = torch.zeros(16, dtype=torch.float64).expand(2, 16)
    one = TS.encode(ctx, (vre, vim), ctx.max_limbs)
    for D in (2, 3):
        ops = LimbOps(ctx, make_mesh(limb=D, device=CPU))
        lpt = ops.encode((vre, vim), ctx.max_limbs)
        assert torch.equal(torch.cat(lpt.parts, dim=-2), one.data)
        got = ops.decode_ri(lpt)
        want = TS.decode_ri(ctx, one)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_rehearsal_bench_cases(kernel_model, monkeypatch):
    """bench.codec_kernels' cases and checks at logN = 10 presets, through
    the model."""
    small = dict(logn=10, scale_bits=50, limb_bits=25)
    monkeypatch.setattr(tcfg, "FLAGSHIP", tcfg.CKKSPreset(
        name="f", slots=16, mult_depth=10, special_limbs=2, digit_width=2,
        **small))
    monkeypatch.setattr(tcfg, "FLAGSHIP_QP", tcfg.CKKSPreset(
        name="q", slots=16, mult_depth=15, special_limbs=2, digit_width=2,
        **small))
    monkeypatch.setattr(tcfg, "MEDIUM", tcfg.CKKSPreset(
        name="m", slots=512, mult_depth=5, special_limbs=2, digit_width=2,
        **small))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    res = CK.check(CPU)
    assert res["max_abs_err"]["encode_residues"] <= 1
    assert 0 <= res["max_abs_err"]["crt_decode"] <= 1e-9
    gen = torch.Generator(device=CPU)
    labels = [(c.label, c.kernel) for c in CK.cases(CPU, gen)]
    assert ("flagship", "encode_residues") in labels
    assert ("flagship", "crt_decode") in labels
    for case in CK.cases(CPU, gen):
        assert bench.codec_bound(**case.work)[0] > 0
