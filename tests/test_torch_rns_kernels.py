"""The scheme ops' modular arithmetic that the CUDA kernels K9 and K10 take
over (hectr_tpu_torch/csrc/rns_ops.cu), on the CPU.

* Each plain primitive of ``ckks.modmath`` bit for bit against its
  counterpart in the JAX package, on the operand patterns the paths pass
  (a plaintext shared by a batch, [R, 1] columns, a gadget [dnum, lf, 1],
  the non-contiguous ``ct.data[..., 0, :, :]``, a limb shard's rows), the
  lazy and wide Shoup forms on inputs outside their documented domain.
* The kernels' stride plans rebuilt with ``torch.as_strided`` against
  ``broadcast_to`` for every pattern, and their refusals.
* K10's plain version against the JAX package's group sum at n1 = 4 and
  91, and the BSGS gemv it serves.
* The rescale through K6's one-group form and K8 against the JAX package's,
  edge residues of the dropped row included.
* A rehearsal of the card's dispatch: with the kernels replaced by an
  emulation that reads each operand through its plan's strides, the scheme
  ops, gemvs, ct x ct products and the limb and coefficient meshes' ops
  give the CPU's residues bit for bit.  The kernels themselves run only on
  the card (tests/test_torch_cuda.py).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu.ckks import modmath as JM
from hectr_tpu.ckks import scheme as JS
from hectr_tpu_torch import bench, interop
from hectr_tpu_torch.ckks import gemv as TG
from hectr_tpu_torch.ckks import keyswitch as TK
from hectr_tpu_torch.ckks import modmath as MM
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.ops import rns_cuda as R
from tests.test_torch_keyswitch_kernels import contexts, preset
from tests.test_torch_scheme import CPU, JaxReplay, jencode, u32

torch.set_num_threads(1)

# 30- and 25-bit NTT primes as the chains mix them
PRIMES = (1073479681, 33292289, 1072496641, 33832961, 1071513601, 33882113)
N = 64


def columns(primes):
    """(p, mu, k) int64 [R, 1] for both packages."""
    return MM.barrett_constants(list(primes))


def uniform(rng, primes, shape):
    """Residues of `shape` [..., R, n] below each row's prime, 0 and p - 1
    planted in columns 0 and 1."""
    p = np.array(primes, dtype=np.int64).reshape(-1, 1)
    a = rng.integers(0, p, size=shape)
    a[..., 0] = 0
    a[..., 1] = p[:, 0] - 1
    return a.astype(np.int64)


def shoup_of(w, p):
    return ((w.astype(object) << 32) // p.astype(object)).astype(np.int64)


def patterns():
    """name -> (a, b, c, w, rows): views of int64 arrays as the paths pass
    them, `rows` the primes of their R rows."""
    rng = np.random.default_rng(0)
    R5 = PRIMES[:5]
    ct = uniform(rng, R5, (3, 2, 5, N))              # a batch of 3
    pt = uniform(rng, R5, (5, N))
    other = np.roll(ct, 1, axis=0)
    out = {
        "shared plaintext": (ct, pt, other, pt, R5),
        "[R, 1] columns": (ct[0, 0], ct[1, 1], ct[2, 0], pt, R5),
        "non-contiguous ct.data[..., 0, :, :]": (
            ct[:, 0], ct[:, 1], other[:, 0], pt, R5),
        "limb shard's rows": (ct[..., 1:4, :], other[..., 1:4, :],
                              other[:, 1:2, 1:4, :], pt[1:4], PRIMES[1:4]),
    }
    lf = PRIMES
    s = uniform(rng, lf, (len(lf), N))
    gad = rng.integers(0, min(lf), size=(3, len(lf), 1)).astype(np.int64)
    out["gadget [dnum, lf, 1]"] = (s[None], gad, uniform(rng, lf, (3, 6, N)),
                                   s, lf)
    return out


PATTERNS = patterns()


def t(a):
    """An int64 tensor sharing the numpy view's strides."""
    return torch.from_numpy(a)


def jnp32(a):
    return jnp.asarray(np.ascontiguousarray(a).astype(np.uint32))


# ---- the plain primitives against the JAX package ------------------------


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_plain_primitives_bit_equal_jax(pattern):
    a, b, c, w, rows = PATTERNS[pattern]
    p, mu, k = columns(rows)
    ws = shoup_of(w, p)
    jp, jmu, jk = (jnp.asarray(x.astype(np.uint64)) for x in (p, mu, k))
    tp, tmu, tk = t(p), t(mu), t(k)
    perm = np.random.default_rng(1).permutation(N)
    cases = {
        "add_mod": (MM.add_mod_plain(t(a), t(b), tp),
                    JM.add_mod(jnp32(a), jnp32(b), jp)),
        "sub_mod": (MM.sub_mod_plain(t(a), t(b), tp),
                    JM.sub_mod(jnp32(a), jnp32(b), jp)),
        "neg_mod": (MM.neg_mod_plain(t(a), tp), JM.neg_mod(jnp32(a), jp)),
        "mul_mod": (MM.mul_mod_plain(t(a), t(b), tp, tmu, tk),
                    JM.mul_mod(jnp32(a), jnp32(b), jp, jmu, jk)),
        "mul_add_mod": (
            MM.mul_add_mod_plain(t(a), t(b), t(c), tp, tmu, tk),
            JM.add_mod(JM.mul_mod(jnp32(a), jnp32(b), jp, jmu, jk),
                       jnp32(c), jp)),
        "add_mod_perm": (
            MM.add_mod_perm_plain(t(a), torch.from_numpy(perm), t(b), tp),
            JM.add_mod(jnp32(a)[..., perm], jnp32(b), jp)),
        "mul_mod_shoup": (MM.mul_mod_shoup_plain(t(a), t(w), t(ws), tp),
                          JM.mul_mod_shoup(jnp32(a), jnp32(w), jnp32(ws), jp)),
        "mul_mod_shoup_wide": (
            MM.mul_mod_shoup_wide_plain(t(a), t(w), t(ws), tp),
            JM.mul_mod_shoup_wide(jnp32(a), jnp32(w), jnp32(ws), jp)),
        "mul_mod_shoup_lazy": (
            MM.mul_mod_shoup_lazy_plain(t(a), t(w), t(ws), tp),
            JM.mul_mod_shoup_u32_lazy(jnp32(a), jnp32(w), jnp32(ws),
                                      jnp32(p))),
    }
    for name, (got, want) in cases.items():
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64)), \
            f"{name} at {pattern}"


def test_lazy_and_wide_shoup_out_of_domain_bit_equal_jax():
    """The wide form on unreduced a < 2^31 (base conversion's residues of
    another prime) and the lazy form on a in [0, 2p) and up to 2^31: the
    port's int64 words equal the JAX package's 32-bit ones."""
    rng = np.random.default_rng(2)
    p, _, _ = columns(PRIMES)
    w = uniform(rng, PRIMES, (len(PRIMES), N))
    ws = shoup_of(w, p)
    for hi in (2 * p, np.full_like(p, 1 << 31)):
        a = rng.integers(0, hi, size=(2, len(PRIMES), N)).astype(np.int64)
        a[..., 0] = hi[:, 0] - 1
        got = MM.mul_mod_shoup_wide_plain(t(a), t(w), t(ws), t(p))
        want = JM.mul_mod_shoup_wide(jnp32(a), jnp32(w), jnp32(ws),
                                     jnp.asarray(p.astype(np.uint64)))
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
        assert bool((got < t(p)).all())
        got = MM.mul_mod_shoup_lazy_plain(t(a), t(w), t(ws), t(p))
        want = JM.mul_mod_shoup_u32_lazy(jnp32(a), jnp32(w), jnp32(ws),
                                         jnp32(p))
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
        assert bool((got < 2 * t(p)).all())


# ---- the stride plans ------------------------------------------------------


def _plan_views(operands, keep_last=False):
    shape, sizes, strides = R.map_plan([x.shape for x in operands],
                                       [x.stride() for x in operands],
                                       keep_last)
    return shape, sizes, [torch.as_strided(x, sizes, st)
                          for x, st in zip(operands, strides)]


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_stride_plan_matches_broadcast(pattern):
    a, b, c, w, rows = PATTERNS[pattern]
    p, mu, k = (t(x) for x in columns(rows))
    for keep_last in (False, True):
        for ops in ((t(a), t(b), p), (t(a), t(b), t(c), p, mu, k),
                    (t(a), t(w), t(w), p), (t(a), p)):
            shape, sizes, views = _plan_views(ops, keep_last)
            assert tuple(shape) == torch.broadcast_shapes(
                *(x.shape for x in ops))
            assert 1 <= len(sizes) <= R.MAX_DIMS
            if keep_last:
                assert sizes[-1] == shape[-1]
            for x, v in zip(ops, views):
                assert torch.equal(v, torch.broadcast_to(x, shape)
                                   .reshape(sizes)), pattern


def test_stride_plan_merges_and_refuses():
    x = torch.zeros((4, 2, 5, N), dtype=torch.int64)
    p = torch.zeros((5, 1), dtype=torch.int64)
    # a whole ciphertext batch: the batch and component axes merge, the
    # rows do not merge with the columns (p is a column)
    assert R.map_plan([x.shape, x.shape, p.shape],
                      [x.stride(), x.stride(), p.stride()])[1] == [8, 5, N]
    # contiguous operands without a column merge into one dimension
    assert R.map_plan([x.shape] * 2, [x.stride()] * 2)[1] == [4 * 2 * 5 * N]
    # seven dimensions that no stride lets merge
    y = torch.zeros((2,) * 7, dtype=torch.int64)
    with pytest.raises(ValueError, match="at most 6"):
        R.map_plan([y.shape, y.shape], [y.stride(), y.permute(
            *reversed(range(7))).stride()])
    with pytest.raises(ValueError, match="do not broadcast"):
        R.map_plan([(3, N), (4, N)], [(N, 1), (N, 1)])
    # K10: the summed axis comes out, the constants must not vary on it
    C = torch.zeros((3, 4, 2, 5, N), dtype=torch.int64)
    w = torch.zeros((4, 1, 5, N), dtype=torch.int64)
    shape, red, red_st, sizes, _ = R.reduce_plan(
        [C.shape, w.shape, p.shape, p.shape, p.shape],
        [C.stride(), w.stride(), p.stride(), p.stride(), p.stride()], -4)
    assert shape == (3, 2, 5, N) and red == 4 and red_st[:2] == [2 * 5 * N,
                                                                 5 * N]
    # the batch does not merge with the components: the summed axis lies
    # between them in C
    assert red_st[2:] == [0, 0, 0] and sizes == [3, 2, 5, N]
    q = torch.zeros((4, 1, 5, 1), dtype=torch.int64)   # a prime per baby
    with pytest.raises(ValueError, match="constants vary"):
        R.reduce_plan([C.shape, w.shape, q.shape, p.shape, p.shape],
                      [C.stride(), w.stride(), q.stride(), p.stride(),
                       p.stride()], -4)


def test_wrappers_refuse_off_the_card_before_building():
    """A CPU tensor, an int32 operand, a scalar or a wrong operand count
    is refused before the kernel library is built (no nvcc here)."""
    a = torch.zeros((2, 5, N), dtype=torch.int64)
    p = torch.ones((5, 1), dtype=torch.int64)
    bad = [
        (lambda: R.rns_map("add_mod", a, a, p), ValueError),
        (lambda: R.rns_map("add_mod", a.int(), a, p), TypeError),
        (lambda: R.rns_map("add_mod", a, 3, p), TypeError),
        (lambda: R.rns_map("add_mod", a, a), TypeError),
        (lambda: R.mod_product_sum(a, a, 0, p, p, p), ValueError),
    ]
    for call, err in bad:
        with pytest.raises(err):
            call()
    assert R.LAUNCHES == {"rns_map": 0, "mod_product_sum": 0}


def test_meta_device_raises_in_every_dispatching_function():
    m = torch.zeros((2, 5, N), dtype=torch.int64, device="meta")
    c = torch.zeros((5, 1), dtype=torch.int64, device="meta")
    perm = torch.zeros(N, dtype=torch.int64, device="meta")
    calls = [
        lambda: MM.add_mod(m, m, c), lambda: MM.sub_mod(m, m, c),
        lambda: MM.neg_mod(m, c), lambda: MM.mul_mod(m, m, c, c, c),
        lambda: MM.mul_add_mod(m, m, m, c, c, c),
        lambda: MM.add_mod_perm(m, perm, m, c),
        lambda: MM.mod_product_sum(m, m, 0, c, c, c),
        lambda: MM.mul_mod_shoup(m, c, c, c),
        lambda: MM.mul_mod_shoup_wide(m, c, c, c),
        lambda: MM.mul_mod_shoup_lazy(m, c, c, c),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError):
            call()


def test_rns_work_counts_bytes_and_multiplies():
    # FLAGSHIP's mul_mod: a half [2, 22, 2^15], a shared key [22, 2^15] and
    # three columns in, [2, 22, 2^15] out
    e = 2 * 22 * (1 << 15)
    nbytes, imads = bench.rns_work("mul_mod", [e, e // 2, 22, 22, 22], e)
    assert nbytes == 8 * (e + e // 2 + 66 + e) and imads == 9 * e
    assert bench.rns_work("add_mod", [e, e, 22], e) == (8 * (3 * e + 22), 0)
    # K10 at FLAGSHIP n1 = 4: C 46.1 MB, the group's plaintexts 23.1 MB,
    # 11.5 MB out: 0.024 ms at 3.35 TB/s
    nbytes, imads = bench.rns_work("mod_product_sum",
                                   [4 * e, 2 * e, 22, 22, 22], e,
                                   products=4 * e)
    assert abs(nbytes / bench.HBM_BYTES_PER_S * 1e3 - 0.0241) < 1e-4
    assert imads == 3 * (3 * 4 * e + 2 * e)
    with pytest.raises(ValueError):
        bench.rns_work("mul_mod_barrett", [1], 1)


# ---- K10's plain version and the group sum --------------------------------


@pytest.mark.parametrize("n1", [4, 91])
def test_mod_product_sum_plain_bit_equal_jax_group_sum(n1):
    """mod_product_sum_plain against the composition it names and against
    the JAX package's group sum (hectr_tpu/ckks/gemv.py:430-434: reduced
    products, one sum and a Barrett pass over the baby axis) on C [n1, 2,
    k, N] and a group's plaintexts [n1, k, N] at N = 2^10; also with a
    batch of 2 in front."""
    rng = np.random.default_rng(n1)
    rows = PRIMES[:4]
    p, mu, k = columns(rows)
    C = uniform(rng, rows, (2, n1, 2, len(rows), 1024))
    w = uniform(rng, rows, (n1, len(rows), 1024))
    got = MM.mod_product_sum_plain(t(C), t(w)[:, None], -4, t(p), t(mu),
                                   t(k))
    assert torch.equal(got, MM.sum_mod(MM.mul_mod_plain(
        t(C), t(w)[:, None], t(p), t(mu), t(k)), -4, t(p), t(mu), t(k)))
    jp, jmu, jk = (jnp.asarray(x.astype(np.uint64)) for x in (p, mu, k))
    group_sum = jax.jit(lambda c, g: JM.sum_mod(
        JM.mul_mod(c, g[:, None], jp, jmu, jk), 0, jp, jmu, jk))
    for b in range(2):
        want = group_sum(jnp32(C[b]), jnp32(w))
        assert np.array_equal(got[b].numpy(),
                              np.asarray(want).astype(np.int64))


@pytest.fixture(scope="module")
def hybrid():
    """A FLAGSHIP-shaped chain at logN = 9 (two specials, width-2 digit
    groups), the JAX package's keys and BSGS rotation keys carried over."""
    from hectr_tpu.ckks import keyswitch as JK

    ctx, jctx = contexts(preset(9))
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(0))
    keys = interop.keyset(jkeys.sk, jkeys.pk, CPU)
    need = TG.bsgs_rotations(ctx.slots)
    jrk = JK.gen_rotation_keys(jctx, jkeys, jax.random.PRNGKey(1),
                               rotations=need)
    rk = interop.rotation_keys({r: np.asarray(x) for r, x in jrk.items()},
                               CPU)
    v = np.linspace(-2, 2, 16)
    jct = jax.jit(lambda p: JS.encrypt(jctx, jkeys, p, jax.random.PRNGKey(2)))(
        jencode(jctx, v, np.zeros(16), ctx.max_limbs))
    ct = interop.ciphertext(jct.data, jct.scale, CPU)
    return ctx, jctx, keys, jkeys, rk, jrk, ct, jct


def test_bsgs_gemv_through_mod_product_sum_bit_equal_jax(hybrid, monkeypatch):
    """The BSGS gemv at n1 = 4 (16 slots), its group sums now
    mod_product_sum, against the JAX package's on the same diagonal
    plaintexts."""
    from hectr_tpu.ckks import gemv as JG
    from tests.test_torch_keyswitch import _reference_diag_encoding

    ctx, jctx, _, _, rk, jrk, ct, jct = hybrid
    assert TG.bsgs_split(ctx.slots)[0] == 4
    monkeypatch.setattr(TG, "_encode_diags", _reference_diag_encoding(jctx))
    M = np.random.default_rng(7).normal(size=(8, 3))
    k = ctx.max_limbs
    mat = JG.gemv_materials(jctx, M, k, jrk, method="bsgs")
    want = jax.jit(lambda m, c: JG.gemv_apply(
        jctx, m, JS.Ciphertext(data=c, scale=jct.scale)).data)(mat, jct.data)
    got = TG.gemv(ctx, M, ct, rk, method="bsgs")
    assert np.array_equal(u32(got.data), np.asarray(want))


# ---- the rescale through K6 and K8 -----------------------------------------


def test_drop_one_through_base_conversion_bit_equal_jax_at_edge_residues(
        hybrid):
    """rescale_pair, each _drop_one a base conversion from p_d, an NTT and
    the mod-down tail, against the JAX package's (centre, remainder, NTT,
    subtract, Shoup multiply), with the first dropped row's coefficients 0,
    (p_d - 1)/2, (p_d + 1)/2 and p_d - 1 planted (the centring's edges),
    over a batch of 2."""
    from hectr_tpu.ckks import ntt as JT

    ctx, jctx, _, _, _, _, ct, jct = hybrid
    k = ctx.max_limbs
    d = k - 1
    p_d = ctx.data_primes[d]
    rng = np.random.default_rng(3)
    data = uniform(rng, ctx.data_primes[:k], (2, 2, k, ctx.n))
    coeff = rng.integers(0, p_d, size=(2, 2, ctx.n)).astype(np.int64)
    coeff[..., :4] = [0, (p_d - 1) // 2, (p_d + 1) // 2, p_d - 1]
    coeff[1, 1, 4:8] = [(p_d - 1) // 2, (p_d + 1) // 2, 0, p_d - 1]
    row = TS.ntt(t(coeff)[..., None, :], ctx.tables_row(d, CPU))
    data[..., d:, :] = row.numpy()
    assert np.array_equal(
        np.asarray(JT.intt(jnp32(data[..., d:, :]), jctx.tables_row(d))),
        coeff[..., None, :])
    got = TS.rescale_pair(ctx, TS.Ciphertext(t(data), ct.scale))
    want = jax.jit(lambda x: JS.rescale_pair(
        jctx, JS.Ciphertext(data=x, scale=jct.scale)).data)(jnp32(data))
    assert np.array_equal(u32(got.data), np.asarray(want))


# ---- the card's dispatch, rehearsed on the CPU -----------------------------


class Emulation:
    """Stands in for K9 and K10: checks what the wrappers check, builds each
    call's plan, reads every operand through the plan's strides
    (``torch.as_strided``) and computes the plain primitive there; counts
    calls by primitive and the plans' dimensions."""

    def __init__(self):
        self.calls = collections.Counter()
        self.dims = collections.Counter()

    @staticmethod
    def _checked(name, tensors):
        for x in tensors:
            assert isinstance(x, torch.Tensor), f"{name}: {type(x)}"
            assert x.dtype == torch.int64, f"{name}: {x.dtype}"
            assert x.device.type == "cpu"

    def rns_map(self, op, *operands, perm=None):
        code, arity = R.OPS[op]
        assert len(operands) == arity
        self._checked(op, operands + (() if perm is None else (perm,)))
        shape, sizes, views = _plan_views(operands, perm is not None)
        if perm is not None:
            views[0] = views[0].index_select(-1, perm)
        got = getattr(MM, op + "_plain")(*views).reshape(shape)
        want = (MM.add_mod_perm_plain(operands[0], perm, *operands[1:])
                if perm is not None
                else getattr(MM, op + "_plain")(*operands))
        assert torch.equal(got, want), op
        self.calls[op + (" perm" if perm is not None else "")] += 1
        self.dims[len(sizes)] += 1
        return got

    def mod_product_sum(self, C, w, dim, p, mu, k):
        operands = (C, w, p, mu, k)
        self._checked("mod_product_sum", operands)
        shape, red, red_st, sizes, strides = R.reduce_plan(
            [x.shape for x in operands], [x.stride() for x in operands], dim)
        Cv, wv = (torch.as_strided(x, [red] + sizes, [rs] + st)
                  for x, rs, st in zip((C, w), red_st, strides))
        consts = (torch.as_strided(x, sizes, st)
                  for x, st in zip((p, mu, k), strides[2:]))
        got = MM.mod_product_sum_plain(Cv, wv, 0, *consts).reshape(shape)
        assert torch.equal(got, MM.mod_product_sum_plain(C, w, dim, p, mu, k))
        self.calls["mod_product_sum"] += 1
        self.dims[len(sizes)] += 1
        return got


def _paths(ctx, keys, rk, relin, ct):
    """Every scheme op on the paths, batched over 2 and alone: encrypt,
    decrypt, arithmetic, rescale, key switch, rotate, mul_ct (both key
    layouts), the diagonal and BSGS gemvs, the limb mesh's and the
    coefficient mesh's ops."""
    from hectr_tpu_torch.parallel import LocalMesh, make_mesh
    from hectr_tpu_torch.parallel.coeff_ops import CoeffOps
    from hectr_tpu_torch.parallel.limb_ops import LimbOps

    k = ctx.max_limbs
    sampler = JaxReplay(enc_keys=[jax.random.PRNGKey(s) for s in (4, 5)])
    v = torch.linspace(-1, 1, 16, dtype=torch.float64)
    pt = TS.encode(ctx, (torch.stack([v, -v]), torch.zeros(2, 16,
                                                           dtype=v.dtype)), k)
    out = {"encrypt": TS.encrypt(ctx, keys, pt, sampler).data}
    b = TS.Ciphertext(out["encrypt"], pt.scale)
    out["decrypt"] = TS.decrypt(ctx, keys, b).data
    out["add/sub/neg"] = TS.neg(ctx, TS.sub(ctx, TS.add(ctx, b, ct), ct)).data
    out["mul_pt + rescale"] = TS.rescale_pair(ctx, TS.mul_pt(
        ctx, b, TS.Plaintext(pt.data[0], ctx.pair_scale(k)))).data
    out["rotate"] = TK.rotate(ctx, b, 3, rk).data
    for compact, key in relin.items():
        out[f"mul_ct compact={compact}"] = TK.mul_ct(ctx, b, ct, key).data
    M = np.random.default_rng(4).normal(size=(16, 16)) / 4
    band = np.where(np.abs(np.subtract.outer(range(16), range(16))) <= 2, M, 0)
    for method in ("diag", "bsgs"):
        for name, m in (("band", band), ("dense", M)):
            out[f"{method} gemv {name}"] = TG.gemv(ctx, m, b, rk,
                                                   method=method).data
    ops = LimbOps(ctx, make_mesh(limb=2, device=CPU))
    for method in ("diag", "bsgs"):
        mat = ops.gemv_materials(band, k, rk, CPU, method)
        got = ops.gemv_apply(mat, ops.shard_ct(b))
        out[f"limb {method} gemv"] = ops.gather_ct(got).data
    co = CoeffOps(ctx, LocalMesh(2))
    out["coefficient gemv"] = co.make_gemv(band, k, rk, CPU)(ct).data
    out["coefficient rescale"] = co.rescale_pair(ct).data
    return out


def test_dispatch_rehearsal_bit_equal_cpu(hybrid, monkeypatch):
    """With K9/K10 emulated through their plans, every path's residues
    equal the plain CPU path's, every primitive and K10 are reached, and
    no call needs more than MAX_DIMS dimensions."""
    from hectr_tpu.ckks import keyswitch as JK

    ctx, jctx, keys, jkeys, rk, _, ct, _ = hybrid
    jrk = JK.gen_rotation_keys(jctx, jkeys, jax.random.PRNGKey(1))
    rk = interop.rotation_keys({r: np.asarray(x) for r, x in jrk.items()},
                               CPU)
    relin = {c: TK.gen_relin_key(ctx, keys, JaxReplay(
        switch_keys=[jax.random.PRNGKey(6)]), compact=c)
        for c in (False, True)}
    want = _paths(ctx, keys, rk, relin, ct)
    emu = Emulation()
    monkeypatch.setattr(MM, "_on_card",
                        lambda *xs: next(x for x in xs
                                         if isinstance(x, torch.Tensor)
                                         ).device.type == "cpu")
    monkeypatch.setattr(R, "rns_map", emu.rns_map)
    monkeypatch.setattr(R, "mod_product_sum", emu.mod_product_sum)
    got = _paths(ctx, keys, rk, relin, ct)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    reached = {op for op in emu.calls}
    assert {"add_mod", "add_mod perm", "sub_mod", "neg_mod", "mul_mod",
            "mul_add_mod", "mul_mod_shoup", "mod_product_sum"} <= reached, \
        emu.calls
    assert max(emu.dims) <= R.MAX_DIMS
