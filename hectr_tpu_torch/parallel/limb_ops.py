"""Limb-sharded CKKS scheme operations: the RNS rows of every tensor
split over a limb mesh (``hectr_tpu_torch.parallel``), the JAX package's
"limb" axis.

The JAX package annotates arrays with ``ct_sharding`` / ``key_sharding``
and GSPMD inserts the collectives.  Here every exchange is written out.
A limb mesh of D shards owns contiguous blocks of the top-level extended
chain (K data rows, then S special rows, ``LimbRows``); a level-k tensor's
shard holds the rows of [0, k) its block covers.  Work per row stays on
its shard; three things cross shards, each one ``mesh.gather`` in row
order:

  * the rescale: the owner of row k-1 sends it, in the coefficient
    domain after its own INTT, to every shard ("rescale row");
  * the digit decomposition: each shard INTTs its own rows, then the
    whole coefficient-domain polynomial [..., k, N] is gathered, since a
    digit group of alpha rows can straddle two shards; each shard
    base-converts every digit to its own target rows only ("digit
    stack");
  * the mod-down by the special primes: the owners of the S special rows
    send them in the coefficient domain; each shard base-converts them
    to its own data rows ("special rows");

and the decode gathers its CRT digits [..., k, 2s] ("decode digits").
The key-switch inner product is local: digits and key share the row map.
Every target row of a base conversion depends on its own prime alone, so
converting to a shard's rows gives those rows of the whole conversion;
the float correction sums the source rows left to right, which the
gathers keep in row order.  So each op repeats the single-device
arithmetic in its order, and results are bit-identical to
``ckks.scheme`` / ``ckks.keyswitch`` / ``ckks.gemv``.

``LimbOps(ctx, mesh)`` takes a ``parallel.Mesh`` (``make_mesh`` or
``multihost.make_pod_mesh``) and works on its limb mesh.  Operands are
``LimbCiphertext`` / ``LimbPlaintext``: a tuple of the held shards'
tensors (all D on a ``LocalLimbMesh``, this rank's on a
``ProcessLimbMesh``), placed by ``parallel.place`` (``shard_ct`` and the
other placement methods call the module's ``shard_ciphertext`` and its
kin).  Keys are tuples of the held shards' top-level blocks
(``shard_key``).  ``gathered`` counts the bytes each kind of exchange
brings together (the gathered tensor at 4 B a residue, as the wire
carries it); ``trace``, when a list, collects the result of every op
called from outside this class, as ``ckks.scheme_ops.SchemeOps`` does
on one device.
"""

from __future__ import annotations

import collections
import weakref
from typing import NamedTuple

import numpy as np
import torch

from hectr_tpu_torch import parallel as P
from hectr_tpu_torch.ckks import gemv as G
from hectr_tpu_torch.ckks.basecvt import (
    base_conv_constants,
    base_convert,
    grouped_conv_constants,
    grouped_convert,
)
from hectr_tpu_torch.ckks.context import CKKSContext
from hectr_tpu_torch.ckks.encoding import (
    MATRIX_MAX_SLOTS,
    coefficient_rows,
    complex_tensor,
    embed_ri,
    encode_rows,
)
from hectr_tpu_torch.ckks.keyswitch import (
    _ks_constants,
    galois_element,
    key_inner_product,
    mod_down_tail,
    permutation,
)
from hectr_tpu_torch.ckks.modmath import (
    add_mod,
    mod_product_sum,
    mul_mod,
    mul_mod_shoup,
    neg_mod,
    sub_mod,
)
from hectr_tpu_torch.ckks.ntt import intt, ntt, ntt_tables
from hectr_tpu_torch.ckks.scheme import (
    Ciphertext,
    KeySet,
    Plaintext,
    crt_decode,
    signed_to_residues,
)
from hectr_tpu_torch.ckks.scheme_ops import traced
from hectr_tpu_torch.parallel import LimbCiphertext, LimbPlaintext, LimbRows
from hectr_tpu_torch.utils.pmu import span

WIRE_BYTES = 4       # a residue on the wire (int32)


class LimbKeys(NamedTuple):
    """A KeySet on a limb mesh: each held shard's block of sk [K+S, N]
    and of pk [2, K, N]."""

    sk: tuple
    pk: tuple


def _ntt(x: torch.Tensor, t) -> torch.Tensor:
    """ntt of a shard's rows; a shard without rows launches nothing."""
    return ntt(x, t) if x.shape[-2] else x


def _intt(x: torch.Tensor, t) -> torch.Tensor:
    return intt(x, t) if x.shape[-2] else x


class LimbOps:
    """Limb-sharded op set for one (context, mesh) pair."""

    def __init__(self, ctx: CKKSContext, mesh: P.Mesh):
        self.ctx = ctx
        self.mesh = mesh
        self.rows = LimbRows(ctx.max_limbs, len(ctx.special_primes),
                             mesh.limb.size)
        self.held = mesh.limb.shards
        self.gathered: collections.Counter = collections.Counter()
        self.trace: list | None = None
        self._depth = 0
        self._cut: dict = {}    # id(top-level key) -> (weakref, its blocks)

    # ------------------------------------------------------------------
    # rows, primes and tables of a shard
    # ------------------------------------------------------------------

    def _data(self, s: int, k: int) -> tuple[int, ...]:
        lo, hi = self.rows.data_rows(s, k)
        return self.ctx.data_primes[lo:hi]

    def _special(self, s: int) -> tuple[int, ...]:
        lo, hi = self.rows.special_rows(s)
        return self.ctx.special_primes[lo:hi]

    def _tables(self, primes, device):
        return ntt_tables(self.ctx.n, tuple(primes), device)

    def _gather(self, what: str, parts, sizes) -> torch.Tensor:
        lead = parts[0].shape[:-2]
        self.gathered[what] += (int(np.prod(lead, dtype=np.int64))
                                * sum(sizes) * parts[0].shape[-1] * WIRE_BYTES)
        return self.mesh.limb.gather(parts, sizes)

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def shard_data(self, x: torch.Tensor, k: int | None = None) -> tuple:
        """The held shards' rows of a level-k tensor [..., k, N] (k: its
        row count)."""
        k = x.shape[-2] if k is None else k
        return P.place(x, P.pt_sharding(self.mesh),
                       [self.rows.data_rows(s, k)
                        for s in range(self.rows.size)])

    def shard_ct(self, ct: Ciphertext) -> LimbCiphertext:
        return P.shard_ciphertext(self.ctx, ct, self.mesh)

    def shard_pt(self, pt: Plaintext) -> LimbPlaintext:
        return P.shard_plaintext(self.ctx, pt, self.mesh)

    def gather_ct(self, ct: LimbCiphertext) -> Ciphertext:
        return P.gather_ciphertext(self.ctx, ct, self.mesh)

    def shard_key(self, ksk: torch.Tensor) -> tuple:
        """The held shards' blocks of a top-level key [dnum, 4 or 2,
        K+S, N]."""
        return P.shard_key(self.ctx, ksk, self.mesh)

    def shard_keys(self, keys: dict) -> dict:
        return {r: self.shard_key(k) for r, k in keys.items()}

    def shard_keyset(self, keys: KeySet) -> LimbKeys:
        return LimbKeys(sk=P.place(keys.sk, P.pt_sharding(self.mesh),
                                   self.rows.blocks),
                        pk=self.shard_data(keys.pk, self.ctx.max_limbs))

    def _blocks(self, key: torch.Tensor) -> tuple:
        """``shard_key(key)``, cut once per key tensor, so that every
        gemv built from one key shares its blocks (as the single device
        shares the key) and the global key can be freed."""
        hit = self._cut.get(id(key))
        if hit is None or hit[0]() is not key:
            hit = self._cut[id(key)] = (weakref.ref(key), self.shard_key(key))
        return hit[1]

    def level_key(self, parts, k: int) -> tuple:
        """Sharded top-level key -> its level-k slice on every shard
        (``keyswitch.slice_key``, local to each shard)."""
        out = []
        for s, p in zip(self.held, parts):
            p = p[:self.ctx.dnum(k)]
            idx = self.rows.key_index(s, k)
            out.append(p if idx is None else p.index_select(-2, idx.to(p.device)))
        return tuple(out)

    def key_bytes(self, parts) -> list[int]:
        return [p.numel() * p.element_size() for p in parts]

    # ------------------------------------------------------------------
    # per-row arithmetic: nothing crosses shards
    # ------------------------------------------------------------------

    def _map(self, fn, k: int, *operands) -> tuple:
        """fn(shard's level-k tables, shard's operands...) per held shard."""
        device = operands[0][0].device
        return tuple(fn(self._tables(self._data(s, k), device), *xs)
                     for s, *xs in zip(self.held, *operands))

    @staticmethod
    def _same(a, b) -> None:
        if a.limbs != b.limbs or a.scale != b.scale:
            raise ValueError(f"operands differ: {a.limbs} vs {b.limbs} limbs, "
                             f"scales {a.scale} vs {b.scale}")

    @span("scheme.add")
    @traced
    def add(self, a: LimbCiphertext, b: LimbCiphertext) -> LimbCiphertext:
        self._same(a, b)
        return LimbCiphertext(self._map(lambda t, x, y: add_mod(x, y, t.p),
                                        a.limbs, a.parts, b.parts),
                              a.scale, a.limbs)

    @span("scheme.sub")
    @traced
    def sub(self, a: LimbCiphertext, b: LimbCiphertext) -> LimbCiphertext:
        self._same(a, b)
        return LimbCiphertext(self._map(lambda t, x, y: sub_mod(x, y, t.p),
                                        a.limbs, a.parts, b.parts),
                              a.scale, a.limbs)

    @span("scheme.neg")
    @traced
    def neg(self, a: LimbCiphertext) -> LimbCiphertext:
        return LimbCiphertext(self._map(lambda t, x: neg_mod(x, t.p), a.limbs,
                                        a.parts), a.scale, a.limbs)

    @span("scheme.add_pt")
    @traced
    def add_pt(self, a: LimbCiphertext, pt: LimbPlaintext) -> LimbCiphertext:
        self._same(a, pt)

        def one(t, x, m):
            c0 = add_mod(x[..., 0, :, :], m, t.p)
            return torch.stack([c0, x[..., 1, :, :].expand_as(c0)], dim=-3)
        return LimbCiphertext(self._map(one, a.limbs, a.parts, pt.parts),
                              a.scale, a.limbs)

    @span("scheme.mul_pt")
    @traced
    def mul_pt(self, a: LimbCiphertext, pt: LimbPlaintext) -> LimbCiphertext:
        if a.limbs != pt.limbs:
            raise ValueError(f"{a.limbs} vs {pt.limbs} limbs")
        return LimbCiphertext(self._map(
            lambda t, x, m: mul_mod(x, m.unsqueeze(-3), t.p, t.mu, t.k),
            a.limbs, a.parts, pt.parts), a.scale * pt.scale, a.limbs)

    @span("scheme.mod_down_to")
    @traced
    def mod_down_to(self, a: LimbCiphertext, k: int) -> LimbCiphertext:
        """Drop trailing limbs down to k without dividing."""
        if a.limbs < k:
            raise ValueError(f"cannot mod down {a.limbs} limbs to {k}")
        return LimbCiphertext(tuple(
            x[..., :self.rows.data_sizes(k)[s], :]
            for s, x in zip(self.held, a.parts)), a.scale, k)

    @span("scheme.mod_down_pair")
    @traced
    def mod_down_pair(self, a: LimbCiphertext) -> LimbCiphertext:
        return self.mod_down_to(a, a.limbs - 2)

    def _permute(self, parts, perm: torch.Tensor) -> tuple:
        """Galois permutation of the evaluation index axis, per row."""
        return tuple(x.index_select(-1, perm) for x in parts)

    # ------------------------------------------------------------------
    # encode / encrypt / decrypt / decode
    # ------------------------------------------------------------------

    @span("scheme.encode")
    @traced
    def encode(self, v, k: int) -> LimbPlaintext:
        """``scheme.encode``: slot values -> each shard's rows of the
        NTT-domain plaintext.  Each shard's rows are ``encode_rows`` over
        its primes (on the card one K11 launch a shard, the embedding fused
        and summed as on one device); above MATRIX_MAX_SLOTS the FFT
        embedding once, then ``encode_embedded``."""
        if isinstance(v, tuple):
            vre, vim = v
        else:
            v = complex_tensor(v)
            vre, vim = v.real, v.imag
        ctx = self.ctx
        if ctx.slots > MATRIX_MAX_SLOTS:
            return self.encode_embedded(embed_ri(vre, vim, ctx.slots), k)
        return self._encode_parts(lambda p: encode_rows(
            vre, vim, ctx.slots, float(ctx.delta), p, ctx.n), k, vre.device)

    @traced
    def encode_embedded(self, m: torch.Tensor, k: int) -> LimbPlaintext:
        """``scheme.encode_embedded`` at the scale Delta: each shard's rows
        through ``coefficient_rows`` (K11's m' entry a shard on the
        card)."""
        ctx = self.ctx
        return self._encode_parts(lambda p: coefficient_rows(
            m, float(ctx.delta), p, ctx.n), k, m.device)

    def _encode_parts(self, rows, k: int, device) -> LimbPlaintext:
        """Each held shard's NTT-domain plaintext rows, `rows(primes_col)`
        giving its coefficient rows (none for a shard without rows at level
        k: no launch)."""
        parts = []
        for s in self.held:
            t = self._tables(self._data(s, k), device)
            parts.append(_ntt(rows(t.p), t))
        return LimbPlaintext(tuple(parts), self.ctx.delta, k)

    @span("scheme.encrypt")
    @traced
    def encrypt(self, keys: LimbKeys, pt: LimbPlaintext,
                sampler) -> LimbCiphertext:
        """``scheme.encrypt``: the sampler draws the global samples once;
        each shard reduces and transforms them over its own rows."""
        k = pt.limbs
        device = pt.parts[0].device
        draws = [x.to(device) for x in sampler.encryption(
            self.ctx, k, tuple(pt.parts[0].shape[:-2]), device)]

        def one(t, m, pk):
            r = m.shape[-2]
            v, e0, e1 = (_ntt(signed_to_residues(x, t.p), t) for x in draws)
            c0 = add_mod(add_mod(mul_mod(v, pk[0, :r], t.p, t.mu, t.k), e0,
                                 t.p), m, t.p)
            c1 = add_mod(mul_mod(v, pk[1, :r], t.p, t.mu, t.k), e1, t.p)
            return torch.stack([c0, c1], dim=-3)
        return LimbCiphertext(self._map(one, k, pt.parts, keys.pk), pt.scale,
                              k)

    @span("scheme.decrypt")
    @traced
    def decrypt(self, keys: LimbKeys, ct: LimbCiphertext) -> LimbPlaintext:
        def one(t, x, sk):
            r = x.shape[-2]
            return add_mod(x[..., 0, :, :],
                           mul_mod(x[..., 1, :, :], sk[:r], t.p, t.mu, t.k),
                           t.p)
        return LimbPlaintext(self._map(one, ct.limbs, ct.parts, keys.sk),
                             ct.scale, ct.limbs)

    @span("scheme.decode_ri")
    def decode_ri(self, pt: LimbPlaintext) -> tuple[torch.Tensor, torch.Tensor]:
        """``scheme.decode_ri``: each shard's CRT digits over the base
        chain, gathered in row order, then the double-double sum and the
        unembedding (``scheme.crt_decode``: K12's digits entry on the card;
        on every shard: the result is replicated)."""
        ctx = self.ctx
        k = min(pt.limbs, len(ctx.base_primes))
        stride = ctx.n // (2 * ctx.slots)
        device = pt.parts[0].device
        dc = ctx.decode_constants(k, pt.scale, device)
        digits = []
        for s, x in zip(self.held, pt.parts):
            lo, hi = self.rows.data_rows(s, k)
            t = self._tables(ctx.data_primes[lo:hi], device)
            coeffs = _intt(x[..., :hi - lo, :], t)[..., ::stride]
            digits.append(mul_mod(coeffs, dc.inv[lo:hi], t.p, t.mu, t.k))
        c = self._gather("decode digits", digits, self.rows.data_sizes(k))
        return crt_decode(ctx, c, dc)

    def decode(self, pt: LimbPlaintext) -> torch.Tensor:
        re, im = self.decode_ri(pt)
        return torch.complex(re, im)

    # ------------------------------------------------------------------
    # rescale: the owner of the dropped row sends it to every shard
    # ------------------------------------------------------------------

    def _drop_one(self, parts, k: int) -> tuple:
        """``scheme._drop_one`` on a level-k tensor's shards -> level
        k-1."""
        ctx = self.ctx
        d = k - 1
        device = parts[0].device
        inv, inv_sh, p_d = ctx.rescale_constants(k, device)
        sizes = [0] * self.rows.size
        owner = next(s for s, (lo, hi) in enumerate(self.rows.blocks)
                     if lo <= d < hi)
        sizes[owner] = 1
        row = ctx.tables_row(d, device)
        send = tuple(_intt(x[..., -1:, :], row) if s == owner else x[..., :0, :]
                     for s, x in zip(self.held, parts))
        last = self._gather("rescale row", send, sizes)        # [..., 1, N]
        centered = torch.where(last > p_d // 2, last - p_d, last)
        out = []
        for s, x in zip(self.held, parts):
            lo, hi = self.rows.data_rows(s, d)
            t = self._tables(ctx.data_primes[lo:hi], device)
            ext = _ntt(torch.remainder(centered, t.p), t)
            diff = sub_mod(x[..., :hi - lo, :], ext, t.p)
            out.append(mul_mod_shoup(diff, inv[lo:hi], inv_sh[lo:hi], t.p))
        return tuple(out)

    @span("scheme.rescale_pair")
    @traced
    def rescale_pair(self, a: LimbCiphertext) -> LimbCiphertext:
        """Divide by the trailing scale-prime pair (one CKKS level),
        bit-identical to ``scheme.rescale_pair``."""
        k = a.limbs
        parts = self._drop_one(self._drop_one(a.parts, k), k - 1)
        return LimbCiphertext(parts, a.scale / self.ctx.pair_scale(k), k - 2)

    # ------------------------------------------------------------------
    # key switching
    # ------------------------------------------------------------------

    @span("keyswitch.modup")
    def decompose(self, parts, k: int) -> tuple:
        """``keyswitch.decompose_digits`` on a level-k poly's shards ->
        each shard's rows of the extended digits [..., dnum, r, N]: its
        data rows below k, then its special rows."""
        ctx = self.ctx
        device = parts[0].device
        coeff = self._gather("digit stack", tuple(
            _intt(x, self._tables(self._data(s, k), device))
            for s, x in zip(self.held, parts)), self.rows.data_sizes(k))
        dnum, alpha = ctx.dnum(k), ctx.alpha
        pad = dnum * alpha - k
        if pad:
            coeff = torch.cat([coeff, coeff.new_zeros(
                (*coeff.shape[:-2], pad, ctx.n))], dim=-2)
        grouped = coeff.unflatten(-2, (dnum, alpha))     # [..., dnum, alpha, N]
        out = []
        for s in self.held:
            primes = self._data(s, k) + self._special(s)
            consts = grouped_conv_constants(ctx.digit_groups(k), primes,
                                            device)
            out.append(_ntt(grouped_convert(grouped, consts),
                            self._tables(primes, device)))
        return tuple(out)

    @span("keyswitch.inner_product")
    def _inner(self, digits, keys, k: int) -> tuple:
        """Key-switch inner product per shard: digits and the level-k key
        share the row map."""
        return tuple(key_inner_product(dg, key, self._tables(
            self._data(s, k) + self._special(s), dg.device))
            for s, dg, key in zip(self.held, digits, keys))

    @span("keyswitch.mod_down")
    def _mod_down(self, acc, k: int) -> tuple:
        """``keyswitch._mod_down_special`` on each shard's [..., r, N]
        (data rows, then special rows) -> its data rows."""
        ctx = self.ctx
        device = acc[0].device
        n_data = self.rows.data_sizes(k)
        last = self._gather("special rows", tuple(
            _intt(x[..., n_data[s]:, :], self._tables(self._special(s), device))
            for s, x in zip(self.held, acc)), self.rows.special_sizes())
        pinv, pinv_sh = _ks_constants(ctx, k, device)
        out = []
        for s, x in zip(self.held, acc):
            lo, hi = self.rows.data_rows(s, k)
            primes = ctx.data_primes[lo:hi]
            t = self._tables(primes, device)
            consts = base_conv_constants(ctx.special_primes, primes, device)
            ext = _ntt(base_convert(last, consts), t)
            out.append(mod_down_tail(x[..., :hi - lo, :], ext, pinv[lo:hi],
                                     pinv_sh[lo:hi], t.p))
        return tuple(out)

    def _switch(self, digits, keys, k: int) -> tuple:
        """Inner product + mod-down: each shard's [..., 2, r, N]."""
        return self._mod_down(self._inner(digits, keys, k), k)

    def key_switch(self, parts, ksk, k: int) -> tuple:
        """``keyswitch.key_switch`` of a level-k poly's shards under the
        sharded top-level key `ksk`."""
        return self._switch(self.decompose(parts, k), self.level_key(ksk, k), k)

    @traced
    def rotate(self, ct: LimbCiphertext, r: int, rot_keys: dict
               ) -> LimbCiphertext:
        """Left-rotate slots by r; `rot_keys` maps r to a sharded key
        (``shard_keys``)."""
        ctx = self.ctx
        r = r % ctx.slots
        if r == 0:
            return ct
        k = ct.limbs
        perm = permutation(ctx.n, galois_element(r, ctx.n), ct.parts[0].device)
        c0r = self._permute((x[..., 0, :, :] for x in ct.parts), perm)
        c1r = self._permute((x[..., 1, :, :] for x in ct.parts), perm)
        ks = self.key_switch(c1r, rot_keys[r], k)
        return LimbCiphertext(self._map(
            lambda t, c0, w: torch.stack([add_mod(c0, w[..., 0, :, :], t.p),
                                          w[..., 1, :, :]], dim=-3),
            k, c0r, ks), ct.scale, k)

    @span("scheme.mul_ct")
    @traced
    def mul_ct(self, a: LimbCiphertext, b: LimbCiphertext,
               relin_key) -> LimbCiphertext:
        """ct x ct + relinearisation under the sharded relin key (either
        layout); scales multiply."""
        if a.limbs != b.limbs:
            raise ValueError(f"operands at {a.limbs} vs {b.limbs} limbs")
        k = a.limbs

        def tensor(t, x, y):
            a0, a1 = x[..., 0, :, :], x[..., 1, :, :]
            b0, b1 = y[..., 0, :, :], y[..., 1, :, :]
            d0 = mul_mod(a0, b0, t.p, t.mu, t.k)
            d1 = add_mod(mul_mod(a0, b1, t.p, t.mu, t.k),
                         mul_mod(a1, b0, t.p, t.mu, t.k), t.p)
            return torch.stack([d0, d1, mul_mod(a1, b1, t.p, t.mu, t.k)],
                               dim=-3)
        d = self._map(tensor, k, a.parts, b.parts)
        ks = self.key_switch(tuple(x[..., 2, :, :] for x in d), relin_key, k)
        return LimbCiphertext(self._map(
            lambda t, dd, w: add_mod(dd[..., :2, :, :], w, t.p),
            k, d, ks), a.scale * b.scale, k)

    # ------------------------------------------------------------------
    # encrypted gemv (materials sharded by row)
    # ------------------------------------------------------------------

    def gemv_materials(self, M: np.ndarray, k: int, rot_keys: dict, device,
                       method: str = "auto") -> dict:
        """``gemv.gemv_materials`` from global keys, every plaintext
        sharded by row and every key the level-k slice of its rotation's
        held blocks (``_blocks``, ``level_key``); the permutations are
        global."""
        def shard(node, key=None):
            if isinstance(node, dict):
                out = {name: shard(v, name) for name, v in node.items()
                       if name != "ksk"}
                if "ksk" in node:
                    out["ksk"] = self.level_key(
                        self._blocks(rot_keys[node["r"]]), k)
                return out
            if isinstance(node, list):
                return [shard(v) for v in node]
            if key in ("pt", "pt0"):
                return self.shard_data(node, k)
            return node
        return shard(G.gemv_materials(self.ctx, M, k, rot_keys, device, method))

    @span("scheme.gemv_apply")
    @traced
    def gemv_apply(self, mat: dict, ct: LimbCiphertext) -> LimbCiphertext:
        """``gemv.gemv_apply`` on sharded materials; consumes one level."""
        if ct.limbs != mat["k"]:
            raise ValueError(f"ciphertext at {ct.limbs} limbs but gemv "
                             f"materials were built for {mat['k']}")
        k = ct.limbs
        pair = self.ctx.pair_scale(k)
        if "diag" in mat:
            acc = self._apply_diag(mat["diag"], ct)
        else:
            acc = self._apply_bsgs(mat["bsgs"], ct)
        return self.rescale_pair(LimbCiphertext(acc, ct.scale * pair, k))

    def _apply_diag(self, d: dict, ct: LimbCiphertext) -> tuple:
        """sum_r T_r * pt_r on every shard, as the single device's diagonal
        method sums them (one K10 pass a shard on the card)."""
        k = ct.limbs
        terms, pts = [], []
        if "pt0" in d:
            terms.append(ct.parts)
            pts.append(d["pt0"])
        if d["rot"]:
            digits = self.decompose(tuple(x[..., 1, :, :] for x in ct.parts),
                                    k)
            c0 = tuple(x[..., 0, :, :] for x in ct.parts)
            for rot in d["rot"]:
                ks = self._switch(self._permute(digits, rot["perm"]),
                                  rot["ksk"], k)
                terms.append(self._map(
                    lambda t, c, w: torch.stack(
                        [add_mod(c, w[..., 0, :, :], t.p), w[..., 1, :, :]],
                        dim=-3),
                    k, self._permute(c0, rot["perm"]), ks))
                pts.append(rot["pt"])
        if not terms:
            return tuple(torch.zeros_like(x) for x in ct.parts)
        C = tuple(torch.stack(cs, dim=-4) for cs in zip(*terms))
        P = tuple(torch.stack(ps) for ps in zip(*pts))
        return self._map(lambda t, c, p: mod_product_sum(
            c, p[:, None], -4, t.p, t.mu, t.k), k, C, P)

    def _apply_bsgs(self, b: dict, ct: LimbCiphertext) -> tuple:
        k = ct.limbs
        digits = self.decompose(tuple(x[..., 1, :, :] for x in ct.parts), k)
        c0 = tuple(x[..., 0, :, :] for x in ct.parts)
        babies = [ct.parts]
        for baby in b["baby"]:
            ks = self._switch(self._permute(digits, baby["perm"]), baby["ksk"],
                              k)
            babies.append(self._map(
                lambda t, c, w: torch.stack([add_mod(c, w[..., 0, :, :], t.p),
                                             w[..., 1, :, :]], dim=-3),
                k, self._permute(c0, baby["perm"]), ks))
        C = tuple(torch.stack(cs, dim=-4) for cs in zip(*babies))

        def group_sum(ptg):
            return self._map(lambda t, c, p: mod_product_sum(
                c, p[:, None], -4, t.p, t.mu, t.k), k, C, ptg)

        acc = (group_sum(b["pt0"]) if "pt0" in b
               else tuple(torch.zeros_like(x) for x in ct.parts))
        for giant in b["giant"]:
            w = group_sum(giant["pt"])
            w0 = self._permute((x[..., 0, :, :] for x in w), giant["perm"])
            w1 = self._permute((x[..., 1, :, :] for x in w), giant["perm"])
            ks = self._switch(self.decompose(w1, k), giant["ksk"], k)
            acc = self._map(
                lambda t, a, x, y: add_mod(a, torch.stack(
                    [add_mod(x, y[..., 0, :, :], t.p), y[..., 1, :, :]],
                    dim=-3), t.p),
                k, acc, w0, ks)
        return acc
