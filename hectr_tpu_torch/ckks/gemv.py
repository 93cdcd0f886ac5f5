"""Encrypted matrix-vector products: plaintext matrix x ciphertext
vector (GPQHE's he_gemv), as ``hectr_tpu/ckks/gemv.py``.

* Diagonal method with hoisting (``method="diag"``):
      M v = sum_r diag_r(M) * rot_r(v),  diag_r[i] = M[i, (i+r) mod s]
  one key switch per nonzero diagonal, one shared digit decomposition.
* Baby-step/giant-step (``method="bsgs"``), r = g*n1 + b:
      M v = sum_g rot_{g n1}( sum_b rot_{-g n1}(diag_{g n1 + b}) * rot_b(v) )
  O(sqrt s) keys and key switches.
* ``method="auto"`` picks whichever needs fewer key switches among the
  methods whose keys are present.

Materials (diagonal plaintexts encoded at level k, permutations,
level-sliced keys) are built once per matrix; the loops over rotation
amounts are plain Python loops.  One rescale at the end; output scale
== input scale.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hectr_tpu_torch.ckks.context import CKKSContext
from hectr_tpu_torch.ckks.keyswitch import (
    _inner_product,
    _mod_down_special,
    decompose_digits,
    galois_element,
    permutation,
    slice_key,
)
from hectr_tpu_torch.ckks.modmath import (
    add_mod,
    mul_mod,
    mul_mod_shoup,
    sum_mod,
)
from hectr_tpu_torch.ckks.scheme import (
    Ciphertext,
    Plaintext,
    encode,
    mul_pt,
    rescale_pair,
)
from hectr_tpu_torch.config import resolve_device


def diagonals(M: np.ndarray, slots: int) -> np.ndarray:
    """Generalized diagonals of the slots x slots (zero-padded) matrix:
    diag[r, i] = M[i, (i+r) mod slots]."""
    Mz = np.zeros((slots, slots), dtype=np.complex128)
    Mz[:M.shape[0], :M.shape[1]] = M
    return np.stack([Mz[np.arange(slots), (np.arange(slots) + r) % slots]
                     for r in range(slots)])


def bsgs_split(slots: int) -> tuple[int, int]:
    """(n1, n2): baby count n1 ~ round(sqrt(slots)) and giant count
    n2 = ceil(slots/n1)."""
    n1 = max(1, round(math.sqrt(slots)))
    return n1, -(-slots // n1)


def bsgs_rotations(slots: int) -> list[int]:
    """The rotation amounts a dense BSGS gemv needs keys for: babies
    1..n1-1 and giants n1, 2*n1, ..."""
    n1, n2 = bsgs_split(slots)
    return sorted(set(range(1, n1)) | {g * n1 for g in range(1, n2)})


def _bsgs_cost(active_rot: list[int], slots: int) -> tuple[int, list[int], int]:
    """(#key switches, needed rotation amounts, n1) for BSGS on this
    sparsity pattern."""
    n1, _ = bsgs_split(slots)
    giants = sorted({r // n1 for r in active_rot} - {0})
    needed = sorted(set(range(1, n1)) | {g * n1 for g in giants})
    return (n1 - 1) + len(giants), needed, n1


def _resolve_method(ctx: CKKSContext, M: np.ndarray, rot_keys: dict,
                    method: str):
    """(method, diags, active) after "auto" resolution."""
    s = ctx.slots
    diags = diagonals(np.asarray(M), s)
    active = [r for r in range(s) if np.max(np.abs(diags[r])) > 0.0]
    if not active:
        active = [0]
    rot_active = [r for r in active if r % s != 0]

    if method == "auto":
        bs_cost, bs_needed, _ = _bsgs_cost(rot_active, s)
        diag_ok = all(r in rot_keys for r in rot_active)
        bsgs_ok = all(r in rot_keys for r in bs_needed)
        if diag_ok and (len(rot_active) <= bs_cost or not bsgs_ok):
            method = "diag"
        elif bsgs_ok:
            method = "bsgs"
        else:
            missing = [r for r in rot_active if r not in rot_keys][:5]
            raise KeyError(
                f"rot_keys covers neither method: diagonal path missing "
                f"amounts {missing}..., BSGS path needs "
                f"{bsgs_rotations(s)[:5]}... (gen_rotation_keys(..., "
                f"rotations=bsgs_rotations(ctx.slots)))")
    if method not in ("diag", "bsgs"):
        raise ValueError(f"unknown gemv method {method!r}")
    return method, diags, active


def _encode_diags(ctx: CKKSContext, D: np.ndarray, k: int, scale,
                  device: torch.device) -> torch.Tensor:
    """Diagonals' slot vectors [R, s] -> NTT-domain residues [R, k, N],
    in one batched encode (each row equals its own 1-D encode)."""
    v = (torch.from_numpy(np.ascontiguousarray(D.real)).to(device),
         torch.from_numpy(np.ascontiguousarray(D.imag)).to(device))
    return encode(ctx, v, k, scale).data


def _pt_shoup(pt: torch.Tensor, k: int, ctx: CKKSContext) -> torch.Tensor:
    """Shoup companions floor(pt * 2^32 / p) of a static plaintext."""
    return torch.div(pt << 32, ctx.primes_col(k, pt.device),
                     rounding_mode="floor")


def gemv_materials(ctx: CKKSContext, M: np.ndarray, k: int, rot_keys: dict,
                   device, method: str = "auto") -> dict:
    """The static operands of an encrypted gemv with matrix M at k
    input limbs, on `device`: a dict keyed "diag" or "bsgs" by the
    resolved method."""
    method, diags, active = _resolve_method(ctx, M, rot_keys, method)
    build = _materials_diag if method == "diag" else _materials_bsgs
    return build(ctx, diags, active, k, rot_keys, resolve_device(device))


def gemv_apply(ctx: CKKSContext, mat: dict, ct: Ciphertext) -> Ciphertext:
    """Apply an encrypted gemv from its materials (gemv_materials)."""
    if ct.limbs != mat["k"]:
        raise ValueError(f"ciphertext at {ct.limbs} limbs but gemv materials "
                         f"were built for {mat['k']}")
    if "diag" in mat:
        return _apply_diag(ctx, mat["diag"], ct)
    return _apply_bsgs(ctx, mat["bsgs"], ct)


def make_gemv(ctx: CKKSContext, M: np.ndarray, k: int, rot_keys: dict,
              device, method: str = "auto"):
    """An encrypted-gemv closure for a fixed matrix at a fixed level."""
    mat = gemv_materials(ctx, M, k, rot_keys, device, method)
    return lambda ct: gemv_apply(ctx, mat, ct)


def gemv(ctx: CKKSContext, M: np.ndarray, ct: Ciphertext, rot_keys: dict,
         method: str = "auto") -> Ciphertext:
    """Encrypted M @ v.  Consumes one level; output scale == input
    scale."""
    return make_gemv(ctx, M, ct.limbs, rot_keys, ct.data.device, method)(ct)


# ---------------------------------------------------------------------------
# hoisted diagonal method
# ---------------------------------------------------------------------------


def _materials_diag(ctx, diags, active, k, rot_keys, device) -> dict:
    s = ctx.slots
    pts = _encode_diags(ctx, diags[active], k, ctx.pair_scale(k), device)
    d: dict = {"rot": []}
    for r, pt in zip(active, pts):
        if r % s == 0:
            d["pt0"] = pt
            continue
        d["rot"].append({
            "perm": permutation(ctx.n, galois_element(r, ctx.n), device),
            "ksk": slice_key(ctx, rot_keys[r], k),
            "pt": pt,
            "pt_sh": _pt_shoup(pt, k, ctx),
        })
    return {"k": k, "diag": d}


def _apply_diag(ctx: CKKSContext, d: dict, ct: Ciphertext) -> Ciphertext:
    k = ct.limbs
    pair = ctx.pair_scale(k)
    t = ctx.tables(k, ct.data.device)
    if "pt0" in d:
        acc = mul_pt(ctx, ct, Plaintext(data=d["pt0"], scale=pair)).data
    else:
        acc = torch.zeros_like(ct.data)
    if d["rot"]:
        digits = decompose_digits(ctx, ct.data[1])          # hoisted
        c0 = ct.data[0]
        for rot in d["rot"]:
            perm = rot["perm"]
            ks_ext = _inner_product(ctx, digits.index_select(-1, perm),
                                    rot["ksk"], k, sliced=True)
            ks = _mod_down_special(ctx, ks_ext, k)          # [2, k, N]
            c0r = c0.index_select(-1, perm)
            term0 = mul_mod_shoup(add_mod(c0r, ks[0], t.p), rot["pt"],
                                  rot["pt_sh"], t.p)
            term1 = mul_mod_shoup(ks[1], rot["pt"], rot["pt_sh"], t.p)
            acc = add_mod(acc, torch.stack([term0, term1]), t.p)
    return rescale_pair(ctx, Ciphertext(data=acc, scale=ct.scale * pair))


# ---------------------------------------------------------------------------
# baby-step / giant-step method
# ---------------------------------------------------------------------------


def _materials_bsgs(ctx, diags, active, k, rot_keys, device) -> dict:
    s = ctx.slots
    n1, _ = bsgs_split(s)
    pair = ctx.pair_scale(k)
    active_set = set(active)
    groups = sorted({r // n1 for r in active})

    # diag'_{g,b} = rot_{-g n1}(diag_{g n1 + b}); np.roll by +g*n1 is
    # exactly rot_{-g n1}.  Inactive (b, g) cells encode the zero vector.
    # One batched encode per group: n1 rows at a time bounds the
    # temporaries of a dense full-packing grid.
    def encode_group(g):
        D = np.zeros((n1, s), dtype=np.complex128)
        for b in range(n1):
            r = g * n1 + b
            if r < s and r in active_set:
                D[b] = np.roll(diags[r], g * n1)
        return _encode_diags(ctx, D, k, pair, device)       # [n1, k, N]

    b: dict = {"n1": n1, "baby": [
        {"perm": permutation(ctx.n, galois_element(bb, ctx.n), device),
         "ksk": slice_key(ctx, rot_keys[bb], k)}
        for bb in range(1, n1)]}
    if 0 in groups:
        b["pt0"] = encode_group(0)
    b["giant"] = [
        {"perm": permutation(ctx.n, galois_element(g * n1, ctx.n), device),
         "ksk": slice_key(ctx, rot_keys[g * n1], k),
         "pt": encode_group(g)}
        for g in groups if g > 0]
    return {"k": k, "bsgs": b}


def _apply_bsgs(ctx: CKKSContext, b: dict, ct: Ciphertext) -> Ciphertext:
    k = ct.limbs
    pair = ctx.pair_scale(k)
    t = ctx.tables(k, ct.data.device)
    digits = decompose_digits(ctx, ct.data[1])              # hoisted babies
    c0 = ct.data[0]
    C = [ct.data]
    for baby in b["baby"]:
        perm = baby["perm"]
        ks_ext = _inner_product(ctx, digits.index_select(-1, perm),
                                baby["ksk"], k, sliced=True)
        ks = _mod_down_special(ctx, ks_ext, k)
        C.append(torch.stack([add_mod(c0.index_select(-1, perm), ks[0], t.p),
                              ks[1]]))
    C = torch.stack(C)                                      # [n1, 2, k, N]

    def group_sum(ptg):
        # sum_b C[b] * ptg[b]: reduced products, one sum + Barrett
        prod = mul_mod(C, ptg[:, None], t.p, t.mu, t.k)     # [n1, 2, k, N]
        return sum_mod(prod, 0, t.p, t.mu, t.k)             # [2, k, N]

    acc = group_sum(b["pt0"]) if "pt0" in b else torch.zeros_like(ct.data)
    for giant in b["giant"]:
        w = group_sum(giant["pt"])
        perm = giant["perm"]
        w0 = w[0].index_select(-1, perm)
        w1 = w[1].index_select(-1, perm)
        dig = decompose_digits(ctx, w1)
        ks_ext = _inner_product(ctx, dig, giant["ksk"], k, sliced=True)
        ks = _mod_down_special(ctx, ks_ext, k)
        acc = add_mod(acc, torch.stack([add_mod(w0, ks[0], t.p), ks[1]]), t.p)
    return rescale_pair(ctx, Ciphertext(data=acc, scale=ct.scale * pair))
