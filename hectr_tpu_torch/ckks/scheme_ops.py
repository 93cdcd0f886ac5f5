"""The single-device op set: ``ckks.scheme`` and ``ckks.gemv`` under the
method names of ``parallel.limb_ops.LimbOps``, so that one regulator
step (``hempc.regulator.make_hempc_regulator``) runs on either.

Both op sets can record what they compute: with ``trace`` a list, every
op called from outside the op set appends ``(name, result)``.  Run the
same step on both and the two traces line up op for op.
"""

from __future__ import annotations

import functools

import numpy as np

from hectr_tpu_torch.ckks import gemv as G
from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.ckks.context import CKKSContext


def traced(fn):
    """Record fn's result in the op set's ``trace`` when it was called
    from outside the op set (not from another of its ops)."""
    @functools.wraps(fn)
    def op(self, *args, **kwargs):
        self._depth += 1
        try:
            out = fn(self, *args, **kwargs)
        finally:
            self._depth -= 1
        if self.trace is not None and self._depth == 0:
            self.trace.append((fn.__name__, out))
        return out
    return op


class SchemeOps:
    """The scheme's ops on one device; keys, plaintexts and ciphertexts
    are the scheme's own."""

    def __init__(self, ctx: CKKSContext):
        self.ctx = ctx
        self.trace: list | None = None
        self._depth = 0

    def shard_keyset(self, keys: S.KeySet) -> S.KeySet:
        """The keys as this op set holds them: as they are."""
        return keys

    def gemv_materials(self, M: np.ndarray, k: int, rot_keys: dict, device,
                       method: str = "auto") -> dict:
        return G.gemv_materials(self.ctx, M, k, rot_keys, device, method)

    @traced
    def encode(self, v, k: int) -> S.Plaintext:
        return S.encode(self.ctx, v, k)

    @traced
    def encrypt(self, keys: S.KeySet, pt: S.Plaintext, sampler
                ) -> S.Ciphertext:
        return S.encrypt(self.ctx, keys, pt, sampler)

    @traced
    def add(self, a: S.Ciphertext, b: S.Ciphertext) -> S.Ciphertext:
        return S.add(self.ctx, a, b)

    @traced
    def sub(self, a: S.Ciphertext, b: S.Ciphertext) -> S.Ciphertext:
        return S.sub(self.ctx, a, b)

    @traced
    def neg(self, a: S.Ciphertext) -> S.Ciphertext:
        return S.neg(self.ctx, a)

    @traced
    def mod_down_to(self, a: S.Ciphertext, k: int) -> S.Ciphertext:
        return S.mod_down_to(self.ctx, a, k)

    @traced
    def gemv_apply(self, mat: dict, ct: S.Ciphertext) -> S.Ciphertext:
        return G.gemv_apply(self.ctx, mat, ct)

    @traced
    def decrypt(self, keys: S.KeySet, ct: S.Ciphertext) -> S.Plaintext:
        return S.decrypt(self.ctx, keys, ct)

    def decode_ri(self, pt: S.Plaintext):
        return S.decode_ri(self.ctx, pt)
