"""Encrypted QP: box-constrained MPC solved over ciphertext, as
``hectr_tpu/hempc/qp_enc.py``.

A fixed-iteration projected-gradient method on the MPC box QP

    min 1/2 du' H du + c' du   s.t.  lb <= du <= ub

evaluated entirely on CKKS ciphertexts:

    z_0     = clip(du_unc)                 (du_unc = -H^{-1} c, the
                                            unconstrained optimum the
                                            gemv pair computes encrypted)
    z_{t+1} = clip(z_t - eta H (z_t - du_unc))

  * eta H (z - du_unc) is one encrypted gemv (plaintext matrix eta*H).
  * clip is a per-slot odd-polynomial surrogate of the box projection,
    z = mid + hw * p((y - mid)/hw): a minimax (Lawson-iterated) degree
    3/5/7 fit of clamp(w,-1,1) on [-B, B], post-scaled so max|p| <= 1 on
    the fit domain, so the box holds by construction (up to CKKS noise).
  * Degree-7 evaluation is a balanced power tree: 5 ct x ct mults (each
    relinearised) and 6 rescales, 4 rescale pairs deep.  Degree 3: 2
    mults, 3 rescales, 3 pairs deep.

The solver counts its work in ``COUNTS`` (``pgd_counts`` gives what one
solve adds) and opens the spans ``qp.pgd`` around a solve and ``qp.grad``
around each iteration's eta H gemv, beside ``scheme.clip`` around each
clip.

Scales are scheduled exactly: every stage re-enters at the context
scale Delta because its constants are encoded at the compensating
products of scale pairs (exact Fractions); ``scheme.add``/``add_pt``
refuse operands whose Fractions differ.

The host-side helpers (fits, domains, step size, depth ledger, the
float64 reference) are the JAX package's numpy code unchanged; the
encrypted solver builds its plaintext constants and gemv materials once
and returns a closure.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.ckks.context import CKKSContext
from hectr_tpu_torch.ckks.gemv import gemv_apply, gemv_materials
from hectr_tpu_torch.ckks.keyswitch import mul_ct
from hectr_tpu_torch.ckks.scheme import Ciphertext, Plaintext, mod_down_to
from hectr_tpu_torch.ops import launches
from hectr_tpu_torch.utils.pmu import span
from hectr_tpu_torch.utils.rows import matvec

# The encrypted QP's work, counted on the host where it is issued:
# ``solve`` (solves), ``clip`` (clip evaluations), ``ct_mult`` (ct x ct
# multiplies), ``relin`` (relinearisations: key switches with the
# relinearisation key, one a multiply here), ``rescale_pair`` (rescales,
# each dividing by one prime pair, the gemvs' own among them) and
# ``levels`` (rescale pairs of depth consumed: limbs in less limbs out,
# over 2).  Registered with the launch counters, so each CUDA-graph
# replay of a captured step adds what its capture counted
# (``ops.launches.Replayed``).
COUNTS: collections.Counter = launches.register(collections.Counter())


@functools.lru_cache(maxsize=None)
def clip_poly_coeffs(domain: float = 2.0, degree: int = 7,
                     cap: bool = True, grid: int | None = None
                     ) -> tuple[float, ...]:
    """Odd-polynomial surrogate of clamp(w,-1,1) on [-domain, domain].

    Returns (c1, c3, ..., c_degree): p(w) = sum c_e w^e, odd e.
    Minimax via Lawson's iteratively-reweighted least squares; with
    cap=True the coefficients are scaled by 1/max|p| so the surrogate
    never exceeds the box on the fit domain (zero overshoot).  Valid
    only on [-domain, domain] (see pgd_domains).
    """
    if degree not in (3, 5, 7):
        raise ValueError(f"clip degree {degree} not in (3, 5, 7)")
    if grid is None:
        grid = max(8001, 2 * int(2000 * domain) + 1)
    w = np.linspace(-domain, domain, grid)
    t = np.clip(w, -1.0, 1.0)
    A = np.stack([w**e for e in range(1, degree + 1, 2)], axis=1)
    wts = np.ones_like(w)
    c = None
    for _ in range(300):
        Aw = A * wts[:, None]
        c, *_ = np.linalg.lstsq(Aw, t * wts, rcond=None)
        err = np.abs(A @ c - t)
        wts = wts * np.sqrt(err + 1e-14)
        wts /= wts.max()
    if cap:
        c = c / np.max(np.abs(A @ c))
    return tuple(float(x) for x in c)


def _quantize_domain(domain) -> np.ndarray:
    """Round fit domains up to a 0.25 grid (>= 1.5): per-slot fits stay
    safe (fit domain >= true bound) and the coefficient cache small."""
    return np.maximum(np.ceil(np.asarray(domain, dtype=np.float64) / 0.25)
                      * 0.25, 1.5)


def clip_coeffs_per_slot(domains: np.ndarray, degree: int,
                         cap: bool = True) -> np.ndarray:
    """[d] fit domains -> [d, nterms] per-slot clip coefficients, each
    slot fitted on its own (quantized-up) domain."""
    dq = _quantize_domain(domains)
    return np.stack([np.asarray(clip_poly_coeffs(float(b), degree, cap))
                     for b in dq])


def poly_clip_np(y: np.ndarray, mid: np.ndarray, hw: np.ndarray,
                 coeffs) -> np.ndarray:
    """Plaintext evaluation of the clip surrogate (float64).
    coeffs: [nterms] shared, or [d, nterms] per-slot."""
    cs = np.asarray(coeffs, dtype=np.float64)
    if cs.ndim == 1:
        cs = np.broadcast_to(cs, (np.shape(y)[-1], cs.shape[0]))
    wv = (y - mid) / hw
    acc = np.zeros_like(wv)
    for i in range(cs.shape[1]):
        acc = acc + cs[..., :, i] * wv ** (2 * i + 1)
    return mid + hw * acc


def pgd_domains(H: np.ndarray, lb: np.ndarray, ub: np.ndarray,
                eta: float, input_bound) -> tuple[np.ndarray, np.ndarray]:
    """Worst-case per-slot clip input domains (in halfwidth units).

    input_bound B0 (scalar or [d]) bounds |du_unc - mid| / hw: the first
    clip sees du_unc (domain B0); iteration clips see
    y = z - eta H (z - du_unc) with z box-capped, so
        |y_i - mid_i|/hw_i <= 1 + eta (|H| (hw (1+B0)))_i / hw_i.
    """
    hw = (ub - lb) / 2.0
    B0 = np.broadcast_to(np.asarray(input_bound, dtype=np.float64),
                         lb.shape).copy()
    amp = np.abs(H) @ (hw * (1.0 + B0))
    B_it = 1.0 + eta * amp / hw
    return B0, B_it


def eta_for_domain(H: np.ndarray, lb: np.ndarray, ub: np.ndarray,
                   input_bound, max_iter_domain: float = 3.0) -> float:
    """Largest step size keeping every iteration-clip domain below
    max_iter_domain (the domain grows linearly in eta)."""
    hw = (ub - lb) / 2.0
    B0 = np.broadcast_to(np.asarray(input_bound, dtype=np.float64), lb.shape)
    amp = np.abs(H) @ (hw * (1.0 + B0))
    return float((max_iter_domain - 1.0) / np.max(amp / hw))


def pgd_eta(H: np.ndarray, lb: np.ndarray, ub: np.ndarray,
            input_bound, max_iter_domain: float = 3.0) -> float:
    """The default PGD step: min of the classical optimal step
    2/(l_min + l_max) and the largest step keeping every iteration-clip
    domain below max_iter_domain."""
    ev = np.linalg.eigvalsh((H + H.T) / 2.0)
    return min(2.0 / (float(ev[0]) + float(ev[-1])),
               eta_for_domain(H, lb, ub, input_bound, max_iter_domain))


def pgd_reference(H: np.ndarray, du_unc: np.ndarray, lb: np.ndarray,
                  ub: np.ndarray, iters: int, eta: float,
                  poly_clip: bool = True, degree: int = 7,
                  input_bound=3.0) -> np.ndarray:
    """Plaintext mirror of the encrypted iteration (float64)."""
    mid = (lb + ub) / 2.0
    hw = (ub - lb) / 2.0
    B0, B_it = pgd_domains(H, lb, ub, eta, input_bound)

    def clip(y, doms):
        if poly_clip:
            return poly_clip_np(y, mid, hw,
                                clip_coeffs_per_slot(doms, degree))
        return np.clip(y, lb, ub)

    z = clip(du_unc, B0)
    for _ in range(iters):
        z = clip(z - eta * (H @ (z - du_unc)), B_it)
    return z


def clip_pairs(degree: int) -> int:
    """Rescale pairs consumed by one encrypted clip of this degree."""
    return {3: 3, 7: 4}[degree]


def pgd_limbs_required(degree: int, iters: int,
                       input_kind: str = "w_scaled") -> int:
    """The depth ledger: data limbs the encrypted PGD consumes below
    k_in.  One clip burns C = 2*clip_pairs(degree) limbs, each iteration
    2 (its gemv) + C, and input_kind "du" 2 more for the w-space
    normalization.

      FLAGSHIP    (22 limbs, k_in=20): deg7/iters=1 -> 18 (exact fit)
      FLAGSHIP_QP (32 limbs, k_in=30): deg7/iters=2 -> 28 (exact fit)
    """
    C = 2 * clip_pairs(degree)
    norm = 2 if input_kind == "du" else 0
    return norm + C + iters * (2 + C)


def pgd_counts(degree: int, iters: int,
               input_kind: str = "w_scaled") -> dict[str, int]:
    """What one encrypted solve adds to ``COUNTS``: iters + 1 clips, each
    of 2 ct x ct multiplies and 3 rescales at degree 3, 5 and 6 at degree
    7; one rescale a gradient gemv and one for the w-space normalization
    of input_kind "du"; its depth is the ledger's, ``pgd_limbs_required``
    / 2 rescale pairs."""
    clips = iters + 1
    mults, rescales = {3: (2, 3), 7: (5, 6)}[degree]
    return {"solve": 1, "clip": clips, "ct_mult": clips * mults,
            "relin": clips * mults,
            "rescale_pair": (clips * rescales + iters
                             + (input_kind == "du")),
            "levels": pgd_limbs_required(degree, iters, input_kind) // 2}


def _mul_ct(ctx: CKKSContext, a: Ciphertext, b: Ciphertext,
            relin_key) -> Ciphertext:
    COUNTS["ct_mult"] += 1
    COUNTS["relin"] += 1
    return mul_ct(ctx, a, b, relin_key)


def _rescale(ctx: CKKSContext, a: Ciphertext) -> Ciphertext:
    COUNTS["rescale_pair"] += 1
    return S.rescale_pair(ctx, a)


def _const_pt(ctx: CKKSContext, v: np.ndarray, k: int, scale,
              device) -> Plaintext:
    """Encode a real per-slot constant vector at (k limbs, scale)."""
    z = torch.zeros(ctx.slots, dtype=torch.float64, device=device)
    z[:v.shape[0]] = torch.from_numpy(np.asarray(v, dtype=np.float64))
    return S.encode(ctx, (z, torch.zeros_like(z)), k, scale)


def _box_layout(ctx: CKKSContext, lb: np.ndarray, ub: np.ndarray):
    """(mid, hw) over all slots; slots beyond the box get (0, 1)."""
    d = lb.shape[0]
    mid = np.zeros(ctx.slots)
    hw = np.ones(ctx.slots)
    mid[:d] = (lb + ub) / 2.0
    hw[:d] = (ub - lb) / 2.0
    return mid, hw


def _clip_build(ctx: CKKSContext, lb: np.ndarray, ub: np.ndarray, k: int,
                domain, degree: int, denormalize: bool, device):
    """The encrypted clip's plaintext constants and its evaluation:
    returns (pts, apply) with `pts` a dict of Plaintexts (each at its
    level and exact scale) and `apply(w_ct, relin_key)`, which takes w
    at k limbs and scale Delta and returns the clip at scale Delta."""
    delta = ctx.delta
    s = ctx.slots
    d_cons = lb.shape[0]
    mid, hw = _box_layout(ctx, lb, ub)
    doms = np.full(s, 1.5)
    doms[:d_cons] = np.broadcast_to(np.asarray(domain, np.float64),
                                    (d_cons,))
    cs_slot = clip_coeffs_per_slot(doms, degree)          # [s, nterms]
    out_gain = hw if denormalize else np.ones(s)
    q = {e: cs_slot[:, i] * out_gain
         for i, e in enumerate(range(1, degree + 1, 2))}
    out_mid = mid if denormalize else np.zeros(s)

    def const(v, level, scale):
        return _const_pt(ctx, v, level, scale, device)

    def check(w: Ciphertext) -> None:
        if w.limbs != k or w.scale != delta:
            raise ValueError(f"clip built for {k} limbs at scale Delta, "
                             f"given {w.limbs} limbs at {w.scale}")

    if degree == 3:
        # w2 = w^2 (pair 1), s3 = q3*w2 (pair 2), z = w*(q1+s3) (pair 3)
        P1, P2, P3 = (ctx.pair_scale(k - 2 * i) for i in range(3))
        pts = {"q3": const(q[3], k - 2, P1 * P2 * P3 / delta**2),
               "q1": const(q[1], k - 4, P3),
               "mid": const(out_mid, k - 6, delta)}

        @span("scheme.clip")
        def apply(w: Ciphertext, relin_key) -> Ciphertext:
            check(w)
            COUNTS["clip"] += 1
            t = _rescale(ctx, _mul_ct(ctx, w, w, relin_key))
            s3 = _rescale(ctx, S.mul_pt(ctx, t, pts["q3"]))
            s3 = S.add_pt(ctx, s3, pts["q1"])
            z = _rescale(ctx, _mul_ct(ctx, mod_down_to(ctx, w, k - 4),
                                      s3, relin_key))
            return S.add_pt(ctx, z, pts["mid"])               # Delta, k-6

        return pts, apply

    if degree != 7:
        raise ValueError(f"encrypted clip of degree {degree}: 3 or 7 only")
    # balanced power tree: 5 ct x ct mults, 4 rescale pairs deep
    P1, P2, P3, P4 = (ctx.pair_scale(k - 2 * i) for i in range(4))
    s_y = delta**2 / P1                         # w2 = w^2     at k-2
    s_d3 = delta * s_y / P2                     # w3 = w*w2    at k-4
    s_d4 = s_y**2 / P2                          # w4 = w2^2    at k-4
    s_d5 = s_d3 * s_y / P3                      # w5 = w3*w2   at k-6
    s_d7 = s_d3 * s_d4 / P3                     # w7 = w3*w4   at k-6
    pts = {"q1": const(q[1], k - 6, P4 * delta / delta),
           "q3": const(q[3], k - 6, P4 * delta / s_d3),
           "q5": const(q[5], k - 6, P4 * delta / s_d5),
           "q7": const(q[7], k - 6, P4 * delta / s_d7),
           "mid": const(out_mid, k - 8, delta)}

    @span("scheme.clip")
    def apply(w: Ciphertext, relin_key) -> Ciphertext:
        check(w)
        COUNTS["clip"] += 1
        w2 = _rescale(ctx, _mul_ct(ctx, w, w, relin_key))        # s_y, k-2
        w3 = _rescale(ctx, _mul_ct(ctx, mod_down_to(ctx, w, k - 2),
                                   w2, relin_key))               # s_d3, k-4
        w4 = _rescale(ctx, _mul_ct(ctx, w2, w2, relin_key))       # s_d4
        w5 = _rescale(ctx, _mul_ct(ctx, w3, mod_down_to(ctx, w2, k - 4),
                                   relin_key))                   # s_d5, k-6
        w7 = _rescale(ctx, _mul_ct(ctx, w3, w4, relin_key))       # s_d7
        acc = S.mul_pt(ctx, mod_down_to(ctx, w, k - 6), pts["q1"])
        acc = S.add(ctx, acc, S.mul_pt(ctx, mod_down_to(ctx, w3, k - 6),
                                       pts["q3"]))
        acc = S.add(ctx, acc, S.mul_pt(ctx, w5, pts["q5"]))
        acc = S.add(ctx, acc, S.mul_pt(ctx, w7, pts["q7"]))
        z = _rescale(ctx, acc)                                    # Delta, k-8
        return S.add_pt(ctx, z, pts["mid"])

    return pts, apply


def make_encrypted_clip(ctx: CKKSContext, relin_key: torch.Tensor,
                        lb: np.ndarray, ub: np.ndarray, k: int, domain=2.0,
                        degree: int = 7, denormalize: bool = False):
    """Polynomial box projection in normalized units on a ciphertext at
    k limbs and scale Delta; output at k - 2*clip_pairs(degree) limbs,
    scale Delta exactly.

    The ciphertext carries w = (y - mid) / hw and the clip returns p(w),
    or hw * p(w) + mid in original units when `denormalize` (folded into
    the last constants: no extra depth).  Normalized, every plaintext
    coefficient is O(1), so noise grows with the domain bound only.
    `domain`: scalar or per-entry [d] fit domain; padding slots get the
    minimum domain."""
    _, apply = _clip_build(ctx, lb, ub, k, domain, degree, denormalize,
                           relin_key.device)
    return lambda w: apply(w, relin_key)


def make_encrypted_pgd(ctx: CKKSContext, relin_key: torch.Tensor,
                       rot_keys: dict, H: np.ndarray, lb: np.ndarray,
                       ub: np.ndarray, k_in: int, iters: int,
                       eta: float | None = None, degree: int = 7,
                       input_bound=3.0, max_iter_domain: float = 3.0,
                       input_kind: str = "du"):
    """Build the encrypted projected-gradient solver: returns
    (solve, eta), with solve(du_ct) -> z_ct.  Every plaintext constant
    and gemv material is built here, once, on the relinearisation key's
    device.

    input_kind:
      * "du": the input is du_unc at k_in limbs, scale Delta;
        normalizing it to w-space costs one rescale pair.
      * "w_scaled": the input is already diag(1/hw) du_unc (the caller
        folded the normalization into its gemv gains); only the
        centering add happens here.

    The output is du in original units at k_in - pgd_limbs_required(...)
    limbs, scale Delta.  `input_bound` is the a-priori certificate
    max|du_unc - mid|/hw <= B0 every clip polynomial is fitted for.
    """
    if eta is None:
        eta = pgd_eta(H, lb, ub, input_bound, max_iter_domain)
    if input_kind not in ("du", "w_scaled"):
        raise ValueError(f"input_kind {input_kind!r}")
    device = relin_key.device
    d_cons = lb.shape[0]
    mid, hw = _box_layout(ctx, lb, ub)
    C = 2 * clip_pairs(degree)
    norm = 2 if input_kind == "du" else 0
    need = pgd_limbs_required(degree, iters, input_kind)
    if k_in - need < len(ctx.base_primes):
        raise ValueError(f"depth: need {need} limbs below k_in={k_in}, "
                         f"base={len(ctx.base_primes)}")
    B0, B_it = pgd_domains(H, lb, ub, eta, input_bound)

    invhw = (_const_pt(ctx, 1.0 / hw, k_in, ctx.pair_scale(k_in), device)
             if input_kind == "du" else None)
    k0 = k_in - norm
    negmid = _const_pt(ctx, -mid / hw, k0, ctx.delta, device)
    _, clip0 = _clip_build(ctx, lb, ub, k0, B0, degree, iters == 0, device)
    # gradient in w-space: G = eta * diag(1/hw) H diag(hw)
    Gw = eta * (np.asarray(H) * hw[None, :d_cons] / hw[:d_cons, None])
    stages = []
    k = k0 - C
    for t in range(iters):
        gm = gemv_materials(ctx, Gw, k, rot_keys, device)
        _, clip_t = _clip_build(ctx, lb, ub, k - 2, B_it, degree,
                                t == iters - 1, device)
        stages.append((k, gm, clip_t))
        k -= 2 + C

    @span("qp.pgd")
    def solve(du_in: Ciphertext) -> Ciphertext:
        COUNTS["solve"] += 1
        w = (_rescale(ctx, S.mul_pt(ctx, du_in, invhw))
             if invhw is not None else du_in)
        w_unc = S.add_pt(ctx, w, negmid)
        z = clip0(w_unc, relin_key)
        for kc, gm, clip in stages:
            with span("qp.grad"):
                COUNTS["rescale_pair"] += 1          # the gemv's own
                g = gemv_apply(ctx, gm,
                               S.sub(ctx, z, mod_down_to(ctx, w_unc, kc)))
            y = S.sub(ctx, mod_down_to(ctx, z, kc - 2), g)
            z = clip(y, relin_key)
        COUNTS["levels"] += (du_in.limbs - z.limbs) // 2
        return z

    return solve, eta


def make_pgd_mirror_regulator(model, plant, horizon: int, bounds, device,
                              iters: int = 2, degree: int = 7,
                              input_bound=3.0):
    """Plaintext float64 mirror of the constrained encrypted regulator
    (gemv pair -> fixed-iteration polynomial PGD -> uhat + du) on
    `device`: the same iteration and per-slot clip polynomials on the
    same certified domains as make_encrypted_pgd, so the encrypted loop
    must match it to CKKS noise.  Its state is the running maximum of
    the input certificate max|du_unc - mid|/hw (start it at a float64
    zero; None skips it), which the caller holds to input_bound after
    the loop.

    Inputs [..., n] are a batch of loops (the JAX package vmaps the
    mirror over them): every gain and H product goes through
    ``utils.rows.matvec``, so on the CPU each row is bit-equal to its
    1-D call, and the certificate is one per loop (state [*batch])."""
    from hectr_tpu_torch.control.mpc import mpc_gains, mpc_hessian
    from hectr_tpu_torch.control.stages import weighting_matrices

    ny, nx = np.shape(model.C)
    nu = np.shape(model.B)[1]
    Q, R = weighting_matrices(plant.xs, plant.us)
    K_A, K_B = mpc_gains(ny, nx, nu, horizon, model.A, model.B, model.C,
                         Q, R)
    H = mpc_hessian(ny, nx, nu, horizon, model.A, model.B, model.C, Q, R)
    lb = np.tile(np.asarray(bounds.dumin, dtype=np.float64), horizon)
    ub = np.tile(np.asarray(bounds.dumax, dtype=np.float64), horizon)
    eta = pgd_eta(H, lb, ub, input_bound)
    B0, B_it = pgd_domains(H, lb, ub, eta, input_bound)

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

    cs0 = f64(clip_coeffs_per_slot(B0, degree))           # [d, nterms]
    cs_it = f64(clip_coeffs_per_slot(B_it, degree))
    K_A, K_B, H = f64(K_A), f64(K_B), f64(H)
    mid, hw = f64((lb + ub) / 2.0), f64((ub - lb) / 2.0)

    def clip(y, cs):
        w = (y - mid) / hw
        acc = torch.zeros_like(w)
        for i in range(cs.shape[1]):
            acc = acc + cs[:, i] * w ** (2 * i + 1)
        return mid + hw * acc

    def regulator(state, xhat, uhat, xr, ur):
        du_unc = -(matvec(K_A, xhat - xr) + matvec(K_B, uhat - ur))
        if state is not None:
            cert = (torch.abs(du_unc - mid) / hw).amax(-1)
            state = torch.maximum(state, cert)
        z = clip(du_unc, cs0)
        for _ in range(iters):
            z = clip(z - eta * matvec(H, z - du_unc), cs_it)
        return uhat + z[..., :nu], state

    return regulator
