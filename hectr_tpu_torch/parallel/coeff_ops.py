"""Coefficient-sharded CKKS scheme operations, as
``hectr_tpu/parallel/coeff_ops.py``.

Ciphertexts whose coefficient axis is sharded over a mesh
(``hectr_tpu_torch.parallel``) are processed end to end: every transform
is the sharded NTT of ``parallel.ntt_shard`` (cross-shard stages through
``mesh.ppermute``, shard-local stages through the NTT kernels),
everything else is per coefficient and so local.  The one exception is
the Galois permutation of the evaluation index axis, which gathers the
row, as the JAX package runs it in the global view between two
``shard_map`` programs.

Operands are *chunks*: the coefficients this process holds of a residue
tensor, ``[..., L, S*C]`` with the S held shards side by side (the whole
row ``[..., L, N]`` on a local mesh, where ``shard`` and ``gather`` cost
nothing; ``[..., L, C]`` on a rank of a process mesh).  ``Ciphertext``
and ``Plaintext`` carry chunks unchanged.  Each op repeats the
single-device op's arithmetic in its order, so results are bit-identical
to ``ckks.scheme`` / ``ckks.keyswitch`` / ``ckks.gemv``.
"""

from __future__ import annotations

import numpy as np
import torch

from hectr_tpu_torch.ckks import gemv as G
from hectr_tpu_torch.ckks.basecvt import (
    base_conv_constants,
    base_convert,
    grouped_conv_constants,
    grouped_convert,
)
from hectr_tpu_torch.ckks.context import CKKSContext
from hectr_tpu_torch.ckks.keyswitch import (
    _inner_product,
    _ks_constants,
    galois_element,
    mod_down_tail,
    permutation,
    slice_key,
)
from hectr_tpu_torch.ckks.modmath import (
    add_mod,
    mod_product_sum,
    mul_mod_shoup,
    sub_mod,
)
from hectr_tpu_torch.ckks.ntt import NTTTables, pointwise_mul
from hectr_tpu_torch.ckks.scheme import Ciphertext
from hectr_tpu_torch.parallel.ntt_shard import local_ntt_fns


class CoeffOps:
    """Coefficient-sharded op set for one (context, mesh) pair."""

    def __init__(self, ctx: CKKSContext, mesh):
        if ctx.n % mesh.size or ctx.n // mesh.size < 2:
            raise ValueError(f"a ring of {ctx.n} does not split over "
                             f"{mesh.size} shards")
        self.ctx = ctx
        self.mesh = mesh
        self.D = mesh.size
        self._split = (len(mesh.shards), ctx.n // mesh.size)     # (S, C)
        self._columns = np.concatenate([
            np.arange(s * self._split[1], (s + 1) * self._split[1])
            for s in mesh.shards])

    def shard(self, a: torch.Tensor) -> torch.Tensor:
        """Global ``[..., N]`` -> this process's chunk."""
        return self.mesh.shard(a).flatten(-2)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """A chunk -> global ``[..., N]`` (an all-gather on a process
        mesh)."""
        return self.mesh.gather(x.unflatten(-1, self._split))

    def _ntt(self, x: torch.Tensor, t: NTTTables) -> torch.Tensor:
        fwd, _ = local_ntt_fns(t, self.mesh)
        return fwd(x.unflatten(-1, self._split)).flatten(-2)

    def _intt(self, x: torch.Tensor, t: NTTTables) -> torch.Tensor:
        _, inv = local_ntt_fns(t, self.mesh)
        return inv(x.unflatten(-1, self._split)).flatten(-2)

    def _permute(self, x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
        """Galois permutation of the evaluation index axis: the held
        columns of the gathered row's ``index_select(-1, perm)``."""
        if len(self.mesh.shards) < self.D:
            perm = perm[torch.from_numpy(self._columns).to(perm.device)]
        return self.gather(x).index_select(-1, perm)

    def ntt(self, a: torch.Tensor) -> torch.Tensor:
        """Forward transform of a coefficient-domain chunk over the
        first ``a.shape[-2]`` data limbs."""
        return self._ntt(a, self.ctx.tables(a.shape[-2], a.device))

    def intt(self, a: torch.Tensor) -> torch.Tensor:
        return self._intt(a, self.ctx.tables(a.shape[-2], a.device))

    def negacyclic_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Coefficient-domain [k, ...] x [k, ...] -> negacyclic product
        over the chain: two forward transforms, the pointwise product,
        one inverse."""
        if a.shape != b.shape:
            raise ValueError(f"{tuple(a.shape)} vs {tuple(b.shape)}")
        t = self.ctx.tables(a.shape[-2], a.device)
        return self._intt(pointwise_mul(self._ntt(a, t), self._ntt(b, t), t),
                          t)

    def _drop_one(self, data: torch.Tensor) -> torch.Tensor:
        """Sharded mirror of ``scheme._drop_one`` on chunks
        [..., K, M]: exact single-limb rescale."""
        ctx = self.ctx
        k = data.shape[-2]
        d = k - 1
        device = data.device
        inv, inv_sh, p_d = ctx.rescale_constants(k, device)
        t_out = ctx.tables(d, device)
        last = self._intt(data[..., d:d + 1, :], ctx.tables_row(d, device))
        centered = torch.where(last > p_d // 2, last - p_d, last)
        ext = self._ntt(torch.remainder(centered, t_out.p), t_out)
        diff = sub_mod(data[..., :d, :], ext, t_out.p)
        return mul_mod_shoup(diff, inv, inv_sh, t_out.p)

    def rescale_pair(self, a: Ciphertext) -> Ciphertext:
        """Composite rescale of a coefficient-sharded ciphertext,
        bit-identical to ``scheme.rescale_pair``."""
        data = self._drop_one(self._drop_one(a.data))
        return Ciphertext(data=data,
                          scale=a.scale / self.ctx.pair_scale(a.limbs))

    # ------------------------------------------------------------------
    # key switching: the digit decomposition and the inner product +
    # mod-down are local but for their transforms; the Galois permutation
    # between them is the one gather
    # ------------------------------------------------------------------

    def _decompose(self, c1: torch.Tensor) -> torch.Tensor:
        """NTT-domain chunk [k, M] -> extended NTT-domain digits
        [dnum, k+S, M] (mirror of ``keyswitch.decompose_digits``)."""
        ctx = self.ctx
        k, width = c1.shape[-2:]
        device = c1.device
        coeff = self._intt(c1, ctx.tables(k, device))
        dnum, alpha = ctx.dnum(k), ctx.alpha
        pad = dnum * alpha - k
        if pad:
            coeff = torch.cat([coeff, torch.zeros(
                (pad, width), dtype=torch.int64, device=device)])
        consts = grouped_conv_constants(
            ctx.digit_groups(k), ctx.data_primes[:k] + ctx.special_primes,
            device)
        ext = grouped_convert(coeff.reshape(dnum, alpha, width), consts)
        return self._ntt(ext, ctx.tables_ks(k, device))

    def _ks_apply(self, digits: torch.Tensor, ksk: torch.Tensor,
                  k: int) -> torch.Tensor:
        """(digits [dnum, k+S, M], level-sliced key chunk in either
        layout) -> [2, k, M]: ``keyswitch._inner_product`` as it is, then
        the mirror of ``_mod_down_special``."""
        ctx = self.ctx
        device = digits.device
        acc = _inner_product(ctx, digits, ksk, k, sliced=True)
        pinv, pinv_sh = _ks_constants(ctx, k, device)
        t = ctx.tables(k, device)
        last = self._intt(acc[..., k:, :], ctx.tables_special(device))
        consts = base_conv_constants(ctx.special_primes, ctx.data_primes[:k],
                                     device)
        ext = self._ntt(base_convert(last, consts), t)
        return mod_down_tail(acc[..., :k, :], ext, pinv, pinv_sh, t.p)

    def rotate(self, ct: Ciphertext, r: int, rot_keys: dict) -> Ciphertext:
        """Left-rotate a coefficient-sharded ciphertext's slots by r,
        bit-identical to ``keyswitch.rotate``.  `rot_keys` holds global
        keys; the level's slice is sharded here."""
        ctx = self.ctx
        r = r % ctx.slots
        if r == 0:
            return ct
        k = ct.limbs
        device = ct.data.device
        perm = permutation(ctx.n, galois_element(r, ctx.n), device)
        ksk = self.shard(slice_key(ctx, rot_keys[r], k))
        c0r = self._permute(ct.data[0], perm)
        c1r = self._permute(ct.data[1], perm)
        ks = self._ks_apply(self._decompose(c1r), ksk, k)
        t = ctx.tables(k, device)
        return Ciphertext(data=torch.stack([add_mod(c0r, ks[0], t.p), ks[1]]),
                          scale=ct.scale)

    def make_gemv(self, M: np.ndarray, k: int, rot_keys: dict, device):
        """Coefficient-sharded hoisted-diagonal encrypted gemv closure:
        the op sequence of ``gemv``'s diagonal method (one digit
        decomposition shared across rotation amounts) on the same
        materials, sharded, so the result is bit-identical to
        ``make_gemv(..., method="diag")``."""
        ctx = self.ctx
        mat = G.gemv_materials(ctx, M, k, rot_keys, device, "diag")["diag"]
        pt0 = self.shard(mat["pt0"]) if "pt0" in mat else None
        rots = [{"perm": rot["perm"],
                 **{name: self.shard(rot[name]) for name in ("ksk", "pt")}}
                for rot in mat["rot"]]
        pair = ctx.pair_scale(k)

        def apply(ct: Ciphertext) -> Ciphertext:
            if ct.limbs != k:
                raise ValueError(f"ciphertext at {ct.limbs} limbs but the "
                                 f"gemv was built for {k}")
            t = ctx.tables(k, ct.data.device)
            # sum_r T_r * pt_r over the terms, as the single device's
            # diagonal method sums them (one K10 pass on the card)
            terms, pts = [], []
            if pt0 is not None:
                terms.append(ct.data)
                pts.append(pt0)
            if rots:
                digits = self._decompose(ct.data[1])            # hoisted
                c0 = ct.data[0]
                for rot in rots:
                    ks = self._ks_apply(self._permute(digits, rot["perm"]),
                                        rot["ksk"], k)
                    c0r = self._permute(c0, rot["perm"])
                    terms.append(torch.stack([add_mod(c0r, ks[0], t.p),
                                              ks[1]]))
                    pts.append(rot["pt"])
            if terms:
                acc = mod_product_sum(torch.stack(terms),
                                      torch.stack(pts)[:, None], 0, t.p,
                                      t.mu, t.k)
            else:
                acc = torch.zeros_like(ct.data)
            return self.rescale_pair(Ciphertext(data=acc,
                                                scale=ct.scale * pair))

        return apply
