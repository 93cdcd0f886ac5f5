"""Lattice-security accounting for the CKKS parameter presets.

The reference hardcodes logn=12, q=2^109 (src/ctr.c:514-517) with no
security statement anywhere in the tree; 109 modulus bits at ring
degree 4096 is exactly the 128-bit ceiling of the Homomorphic
Encryption Security Standard (homomorphicencryption.org, Nov 2018,
Table 1, ternary secret, classical attacks) -- folklore-safe.  A
framework that lets users pick parameters must *check* them: this
module computes each preset's total modulus bits (data + special
primes -- key switching temporarily raises ciphertexts to Q*P, so the
attack surface is logQP, not logQ) and classifies it against the
standard's table.

The table is the published standard, not an LWE-estimator run; between
table rows the security estimate is linear interpolation in log2(QP)
(security falls roughly linearly in logQ at fixed n over these ranges).
Estimates are labeled as such.

The port of ``hectr_tpu/ckks/security.py``, over the port's chains
(which equal the JAX package's prime for prime).
"""

from __future__ import annotations

import dataclasses

from hectr_tpu_torch.config import CKKSPreset

# Homomorphic Encryption Security Standard (Nov 2018), Table 1:
# maximum log2(QP) at ring degree 2^logn for {128, 192, 256}-bit
# security against classical attacks, ternary secret, sigma = 3.2.
HE_STANDARD_MAX_LOGQP: dict[int, dict[int, int]] = {
    128: {10: 27, 11: 54, 12: 109, 13: 218, 14: 438, 15: 881},
    192: {10: 19, 11: 37, 12: 75, 13: 152, 14: 305, 15: 611},
    256: {10: 14, 11: 29, 12: 58, 13: 118, 14: 237, 15: 476},
}


@dataclasses.dataclass(frozen=True)
class SecurityReport:
    preset: str
    logn: int
    log_q: int            # data modulus bits (decryption modulus)
    log_qp: int           # data + special bits (key-switch modulus)
    max_logqp_128: int    # standard's 128-bit ceiling at this degree
    meets_128: bool
    meets_192: bool
    meets_256: bool
    est_bits: float       # interpolated classical-security estimate

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        tick = {True: "yes", False: "NO"}
        return (f"{self.preset}: logN={self.logn} logQ={self.log_q} "
                f"logQP={self.log_qp} (128-bit ceiling {self.max_logqp_128}) "
                f"-> ~{self.est_bits:.0f}-bit classical "
                f"[128:{tick[self.meets_128]} 192:{tick[self.meets_192]} "
                f"256:{tick[self.meets_256]}]")


def modulus_bits(preset: CKKSPreset) -> tuple[int, int]:
    """(log2 Q, log2 QP) for the preset's derived RNS chain."""
    from hectr_tpu_torch.ckks.context import make_context

    ctx = make_context(preset)
    q = 1
    for p in ctx.data_primes:
        q *= p
    qp = q
    for p in ctx.special_primes:
        qp *= p
    return q.bit_length(), qp.bit_length()


def _interp_security(logn: int, log_qp: int) -> float:
    """Security estimate: piecewise-linear through the standard's three
    (max logQP, bits) points at this ring degree; beyond the 128-bit
    point, the Core-SVP-style inverse model bits ~ 128 * q128/logQP
    (which reproduces the table's own 192/256 rows within ~3%, so it is
    the standard-consistent extrapolation -- a linear slope would
    overstate the loss).  Clamped to [0, 300]."""
    pts = sorted((HE_STANDARD_MAX_LOGQP[bits][logn], bits)
                 for bits in (128, 192, 256))  # ascending logQP
    (q256, b256), (q192, b192), (q128, b128) = pts
    if log_qp <= q256:
        return 300.0
    if log_qp <= q192:
        t = (log_qp - q256) / (q192 - q256)
        return b256 + t * (b192 - b256)
    if log_qp <= q128:
        t = (log_qp - q192) / (q128 - q192)
        return b192 + t * (b128 - b192)
    return max(0.0, b128 * q128 / log_qp)


def security_report(preset: CKKSPreset) -> SecurityReport:
    if preset.logn not in HE_STANDARD_MAX_LOGQP[128]:
        raise ValueError(
            f"no HE-standard row for logN={preset.logn}; supported "
            f"degrees: {sorted(HE_STANDARD_MAX_LOGQP[128])}")
    log_q, log_qp = modulus_bits(preset)
    return SecurityReport(
        preset=preset.name,
        logn=preset.logn,
        log_q=log_q,
        log_qp=log_qp,
        max_logqp_128=HE_STANDARD_MAX_LOGQP[128][preset.logn],
        meets_128=log_qp <= HE_STANDARD_MAX_LOGQP[128][preset.logn],
        meets_192=log_qp <= HE_STANDARD_MAX_LOGQP[192][preset.logn],
        meets_256=log_qp <= HE_STANDARD_MAX_LOGQP[256][preset.logn],
        est_bits=_interp_security(preset.logn, log_qp),
    )


def assert_security(preset: CKKSPreset, bits: int = 128) -> SecurityReport:
    """Raise ValueError unless the preset meets `bits`-bit classical
    security per the HE standard table.  Returns the report."""
    rep = security_report(preset)
    if bits not in HE_STANDARD_MAX_LOGQP:
        raise ValueError(f"bits must be one of {sorted(HE_STANDARD_MAX_LOGQP)}")
    ok = {128: rep.meets_128, 192: rep.meets_192, 256: rep.meets_256}[bits]
    if not ok:
        raise ValueError(
            f"preset '{preset.name}' does not meet {bits}-bit security: "
            f"logQP={rep.log_qp} exceeds the standard's ceiling "
            f"{HE_STANDARD_MAX_LOGQP[bits][preset.logn]} at logN="
            f"{preset.logn} (~{rep.est_bits:.0f}-bit estimated); use a "
            f"larger ring degree (e.g. the '{preset.name}-secure' "
            f"variant if defined) or a shorter chain")
    return rep
