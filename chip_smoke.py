"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  0. require CUDA; print the card's name and power limit
  1. build the CUDA kernels from hectr_tpu_torch/csrc, one nvcc per
     source, all at once (timed)
  2. NTT kernels vs plain PyTorch, bit for bit, over real prime chains
     (logN 8/12/15, L 1/5/24/34, batch ()/(2,)/(11,)) and over every
     logN 1-15 at 1, 3, 4, 22, 44 and 264 rows (every cluster size the
     wrapper picks), and their times, bounds and shares of the bound at
     the shapes the encrypted loops give them, each bit-equal and timed
     at every cluster size (hectr_tpu_torch.bench.ntt_kernels); the
     key-switch kernels K6-K8 (base conversion, key inner product,
     mod-down tail) bit-equal to their plain versions at every case of
     hectr_tpu_torch.bench.keyswitch_kernels (REFERENCE_HEMPC alone and
     over 64 loops, FLAGSHIP and FLAGSHIP_QP at the top and an odd level,
     over 4 loops, MEDIUM, a coefficient rank's columns, a limb shard's
     rows; stored and compact keys, K7 with and without a Galois
     permutation; K6's mod-down and rescale forms), timed there by
     CUDA-graph replay beside bound and plain; the scheme ops' kernels K9
     (every primitive of ckks/modmath.py at FLAGSHIP's [2, 22, 2^15] and
     the FLAGSHIP_QP batch [4, 2, 32, 2^15], broadcast and non-contiguous
     operands, the permuted form, every int64 word random) and K10 (the
     BSGS group sum at FLAGSHIP n1 = 4, over 4 loops and at MEDIUM's
     n1 = 91) bit-equal to their plain versions, timed beside bound and
     plain (hectr_tpu_torch.bench.rns_kernels), and the wrapper's host
     time per K9 call beside the plain composition's and its aten launches;
     the encode and decode kernels K11 (FLAGSHIP's 22 rows and the
     FLAGSHIP_QP batch of 4 with the embedding fused, MEDIUM's m' entry) and
     K12 (the same shapes' base rows through their stride, real encodings
     and random residues, and its digits entry) held to their plain
     versions (K11's m' entry and K12's y bit-equal, the fused embedding
     bit-equal to its fixed-order sum and within one unit of y of the
     plain composition, the unembedded values to 1e-12 relative), timed
     beside bound and plain (hectr_tpu_torch.bench.codec_kernels); the
     CSTR loop's stages K13 at one plant and 1,024 within 1e-13 of the
     uncaptured stages in each of its modes (step, step with the next
     observation, observation), timed in the second beside its bound, the
     uncaptured stages and their CUDA graph, with the host's us a step
     through the loop's K13 holder (hectr_tpu_torch.bench.stages_kernels);
     the encrypt kernel K14 bit-equal to the composition it replaces (three
     torch.remainder, three K1, three K9, a stack) at one and 1,024
     ciphertexts of the benchmark's ring and one of FLAGSHIP, timed beside
     its bound and the composition (hectr_tpu_torch.bench.encrypt_kernels)
  3. the REFERENCE_HEMPC encrypted CSTR loop (40 steps, every rotation
     key) through the CLI's functions: <= 5e-10 per channel against the
     plaintext twin, canary < 1e-5, golden cstr-hempc.bin to 1e-6
  4. the FLAGSHIP loop (logN=15, 24-prime chain, BSGS rotation keys,
     horizon 4): <= 2e-9 per channel, canary < 1e-5, final state
  5. the multiply-ceiling probe K3 (hectr_tpu_torch.bench.vpu_ceiling):
     kernel bit-equal to the plain chain at small r and over the full
     [4096, 128] x 512 x 4 chain, the pow identity, kernel and plain
     times, multiplies/s, SASS instructions per multiply, and the NTT
     kernel's share of the ceiling
  6. the fused single-ciphertext regulator at FLAGSHIP (40 steps, the
     keys of phase 4): <= 2e-9 per channel, canary < 1e-5, final state
  7. the constrained encrypted loop at FLAGSHIP_QP as
     scripts/run_flagship_qp_tpu.py sets it up (compact relinearisation
     and BSGS keys, du box, degree-7 2-iteration PGD, 10 steps): the
     plaintext mirror's eta, envelope and certificate equal the JAX
     run's; <= 1e-4 per channel against the mirror, box honored to 1e-4
     and active, canary < 1e-5.  Then the same regulator over 4 loops
     (simulate_batch, loop b under (1, 0.75, 0.5, 0.25)[b] x the
     disturbance, inside the same envelope): each loop <= 1e-4 from the
     batched mirror, every box honored, loop 0 active, every canary
     < 1e-5; rows 0 and 3 of a step against the 1-D regulator; K1/K2
     bit-equal to plain at every batched shape the loops launched
  8. "he": the reference's he_* call sequence at its exact parameters
     (hectx_init(12, 109, 16, 50), 15 rotation keys, 4 encryptions, 2
     gemvs): the control law to 1e-8, canary < 1e-5, the realized
     modulus and security estimate printed; the native CRT oracle
     (csrc/hectr_host.cpp, built with g++) on the decrypted plaintext
     "parallel" (after 6, on phase 4's keys): the coefficient axis on a
     local mesh of D = 2, 4, 8 shards at full width.  The sharded NTT and
     inverse at FLAGSHIP's shapes ([22, 2^15], [11, 24, 2^15]) bit-equal
     to ntt/intt on whole rows, and at logN = 16 and 17 (22 limbs, every
     D that leaves a chunk of at most 2^15) to the plain transform; K1/K2
     on the stacked [L*D, C] view bit-equal to the plain local stages,
     at those shapes and at every stacked shape CoeffOps gives them;
     CoeffOps rescale_pair, negacyclic_mul, rotate and the hoisted gemv at
     FLAGSHIP bit-equal to the single-device ops and decrypted to 1e-6;
     the sharded transform's device times by D and logN, forward and
     inverse, through the cross-shard kernels K4/K5 and with the eager
     stages they replace, beside bound and single launch, K4/K5 alone
     beside their bound and the plain cross stages, CUDA launches per
     transform either way; the scaling report; and two torch.distributed
     ranks sharing the card (gloo, chunks staged through the host), each
     bit-equal on its shard, their stages through K4/K5's received form
     (launches and a check against the plain stages per rank;
     hectr_tpu_torch.bench.run_multiproc); then encrypt -> mul_pt ->
     rescale_pair -> decrypt at logN = 16 and 17 through the scheme ops
     alone (ckks.ntt's route above 2^15) to 1e-6, with the peak memory
     and the bytes the route's cached tables hold; K4/K5's local form
     bit-equal to the plain cross stages at every shape the phase
     launched it at
     "batch" (after "parallel", FLAGSHIP on phase 4's keys): B loops
     through one regulator, every op one launch for the batch.
     REFERENCE_HEMPC: simulate_batch over 16 loops x 40 steps (loop b's
     disturbance scaled by 1 + b/16), each <= 5e-10 per channel from
     its plaintext twin, every canary < 1e-5, loop 0 = golden
     cstr-hempc.bin to 1e-6; the serving curve at B = 1, 16, 64, every
     row's u within 1e-8 of the plaintext law on its inputs, NTT
     launches per batched step equal at every B.  FLAGSHIP fused over 8
     loops x 40 steps: <= 2e-9, canaries < 1e-5, loop 0's final state.
     Rows 0 and B-1 of a 4-step run against the 1-D regulator with the
     same draws: ciphertexts and decoded u bit-equal at every row-step
     whose encode inputs agree (counted), u to 1e-12 everywhere.
     Aggregate steps/s and peak device memory for each
     "limb" (after "batch", FLAGSHIP on phase 4's keys sharded by row):
     LimbOps on local limb meshes of 2 and 3 shards (rescale_pair, digit
     decomposition, key_switch, rotate, BSGS gemv) bit-equal to the
     single-device ops, the gemv decrypted and decoded to 1e-6; 4 CSTR
     loops x 40 steps of the reference-shaped regulator on
     LocalLimbMesh(2): u and x bit-equal to the unsharded batched
     regulator on the same draws, each loop <= 2e-9 per channel from its
     plaintext twin, canaries < 1e-5, final states; K1/K2 bit-equal to
     plain at every shard shape the phase launched them at (printed by
     shape); bytes gathered per step by kind, device ms and CUDA launches
     per step sharded and unsharded, peak memory, key bytes per shard;
     two gloo ranks sharing the card (bench/run_multiproc.py --limb 2),
     one FLAGSHIP step each, bit-equal on its rows
  9. "medium": MEDIUM at full width (logN=14, 8192 slots, 12 limbs):
     FFT embedding on the card = the CPU's to 1e-12; encrypt/decrypt of
     8192 complex slots to 1e-6; rotations by 1 and 7; a 5-level ct x ct
     chain (compact relinearisation key, 12 -> 2 limbs) to 1e-6 per
     level; a dense 8192 x 8192 BSGS gemv (180 compact keys) to 1e-4 of
     M v, with its key and plaintext-grid bytes, the device memory held
     before and the peak in each of its phases (keys, grid, gemv) and
     times (hectr_tpu_torch.bench.suite.dense_gemv)
     "suite": the bench entry point (hectr_tpu_torch.bench.suite) through
     its main() for ntt_logn15, kernel_parity and compact_key_tradeoff:
     its JSON line names the three, each passed its gate
 10. each kernel launched on every path that uses it (K1/K2, K6-K12 in
     phases 3, 4, 6-9, "parallel", "batch" and "limb", with K1/K2's
     launches by shape and K9's by primitive, and each phase's launches of
     every one of them; K3 in phase 5; K4/K5 in "parallel"; K13 summed
     over the CSTR loops' phases); each
     phase's wall time, the kernel summary, the card, and as the last
     line {"ok": true, "device": {...}}
"""

from __future__ import annotations

import collections
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from hectr_tpu_torch.ops import launches as launch_counters

ROOT = pathlib.Path(__file__).resolve().parent
FLAGSHIP_FINAL_STATE = np.array([0.895, 321.8075, 0.7655])
# the JAX package's constrained FLAGSHIP_QP run (its mirror is exact
# float64 host arithmetic, so its numbers carry over)
QP_SUMMARY = ROOT / "results" / "flagship_qp_tpu" / "summary.json"
# batch + (L,) of the NTT sweep: 1, 3, 4, 22, 44 and 264 rows
ROW_SHAPES = ((1,), (3,), (2, 2), (22,), (2, 22), (11, 24))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_residues(primes, batch, n, gen, device):
    """Uniform residues [*batch, L, n] with 0 and p-1 planted per row."""
    rows = [torch.randint(0, p, (*batch, n), generator=gen, device=device)
            for p in primes]
    a = torch.stack(rows, dim=-2)
    a[..., 0] = 0
    a[..., 1] = torch.tensor(primes, device=device) - 1
    return a


def sweep_chain(logn: int) -> tuple[int, ...]:
    """24 NTT primes for rows of 2^logn, 30-bit and 25-bit alternating."""
    from hectr_tpu_torch.ckks.primes import find_ntt_primes

    two_n = 2 << logn
    return tuple(p for pair in zip(find_ntt_primes(30, 12, two_n),
                                   find_ntt_primes(25, 12, two_n))
                 for p in pair)


def phase_kernels(device, kernel_rows):
    from hectr_tpu_torch.bench import ntt_kernels
    from hectr_tpu_torch.ckks import ntt as T
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.config import FLAGSHIP_QP, CKKSPreset
    from hectr_tpu_torch.ops import ntt_cuda

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cases = 0
    max_err = {"ntt": 0, "intt": 0}
    for logn in (8, 12, 15):
        # a 34-prime chain (32 data + 2 special) at this ring size; its
        # prefixes mix 30-bit base/special and 25-bit scale primes
        preset = FLAGSHIP_QP if logn == 15 else CKKSPreset(
            name=f"smoke-{logn}", logn=logn, slots=16, scale_bits=50,
            limb_bits=25, mult_depth=15, special_limbs=2, digit_width=2)
        chain = make_context(preset).full_primes
        for L in (1, 5, 24, 34):
            t = T.ntt_tables(1 << logn, chain[:L], device)
            for batch in ((), (2,), (11,)):
                a = random_residues(chain[:L], batch, 1 << logn, gen, device)
                fwd = T.ntt(a, t)
                inv = T.intt(fwd, t)
                ref_fwd = T.ntt_plain(a, t)
                ref_inv = T.intt_plain(fwd, t)
                torch.cuda.synchronize()
                max_err["ntt"] = max(max_err["ntt"], int(
                    (fwd - ref_fwd).abs().max()))
                max_err["intt"] = max(max_err["intt"], int(
                    (inv - ref_inv).abs().max()))
                check(torch.equal(fwd, ref_fwd),
                      f"ntt != plain at logN={logn} L={L} batch={batch}")
                check(torch.equal(inv, ref_inv),
                      f"intt != plain at logN={logn} L={L} batch={batch}")
                check(torch.equal(inv, a),
                      f"intt(ntt(a)) != a at logN={logn} L={L} batch={batch}")
                cases += 1
    print(f"[kernels] {cases} cases bit-equal to plain (ntt, intt, "
          f"roundtrip); max |kernel - plain| = {max_err}", flush=True)

    # every ring size over row counts that reach every cluster size
    clusters = set()
    for logn in range(1, 16):
        chain = sweep_chain(logn)
        for lead in ROW_SHAPES:
            t = T.ntt_tables(1 << logn, chain[:lead[-1]], device)
            a = random_residues(t.primes, lead[:-1], 1 << logn, gen, device)
            fwd = T.ntt(a, t)
            inv = T.intt(fwd, t)
            ok = (torch.equal(fwd, T.ntt_plain(a, t))
                  and torch.equal(inv, T.intt_plain(fwd, t))
                  and torch.equal(inv, a))
            check(ok, f"kernel != plain at logN={logn}, shape {lead}")
            clusters.add(ntt_cuda.geometry(a.numel() >> logn, logn).cluster)
            cases += 1
    check(clusters == {1, 2, 4, 8}, f"cluster sizes reached: {clusters}")
    print(f"[kernels] logN 1-15 x rows {[int(np.prod(s)) for s in ROW_SHAPES]}"
          f" bit-equal to plain as well ({cases} cases in all; clusters of "
          f"{sorted(clusters)} CTAs)", flush=True)

    # times at the loops' shapes, beside the bound and every cluster size
    for rec in ntt_kernels.measure(device):
        by_cluster = {c["cluster"]: round(c["ms"], 4)
                      for c in rec["by_cluster"]}
        print(f"[kernels] {rec['kernel']} {rec['shape']} ({rec['label']}; "
              f"{rec['cluster']} CTAs x {rec['threads']} threads a row, "
              f"passes {rec['passes']}): kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}) = {rec['share_of_bound']:.3f} of it; "
              f"ms by CTAs a row {by_cluster}", flush=True)
        if rec["label"] == "flagship digit stack":
            kernel_rows[rec["kernel"]].update(
                max_abs_err=max_err[rec["kernel"]], ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], library_ms=None)
    keyswitch_kernels(device, kernel_rows)
    rns_kernels(device, kernel_rows)
    codec_kernels(device, kernel_rows)
    stages_kernels(kernel_rows)
    encrypt_kernels(kernel_rows)


def keyswitch_kernels(device, kernel_rows):
    """K6-K8 bit-equal to their plain versions at every case of
    ``bench.keyswitch_kernels`` (the loops' levels, batches, key layouts,
    a coefficient rank's columns and a limb shard's rows), then timed
    there beside their bounds and the plain versions."""
    from hectr_tpu_torch.bench import keyswitch_kernels as KK

    err = KK.check(device)
    print(f"[kernels] K6-K8 bit-equal to plain at {len(KK.CASES)} cases "
          f"({[c.label for c in KK.CASES]}; residues 0 and p - 1 planted; "
          f"stored and compact keys; K7 with and without a Galois "
          f"permutation); max |kernel - plain| = {err}", flush=True)
    for rec in KK.measure(device):
        plain = (f"plain {rec['plain_ms']:.4f} ms"
                 if rec["plain_ms"] is not None else "no plain version")
        print(f"[kernels] {rec['kernel']} {rec['shape']} ({rec['case']}): "
              f"kernel {rec['ms']:.4f} ms, {plain}, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) = "
              f"{rec['share_of_bound']:.3f} of it", flush=True)
        if rec["case"] == KK.HEADLINE and rec["kernel"] in kernel_rows:
            kernel_rows[rec["kernel"]].update(
                max_abs_err=err[rec["kernel"]], ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], library_ms=None)


def rns_kernels(device, kernel_rows):
    """K9/K10 bit-equal to their plain versions at every case of
    ``bench.rns_kernels``, timed there beside their bounds and the plain
    versions, and K9's host time per call."""
    from hectr_tpu_torch.bench import rns_kernels as RK

    err = RK.check(device)
    print(f"[kernels] K9 (every primitive) and K10 bit-equal to plain at "
          f"every case of bench.rns_kernels (FLAGSHIP [2, 22, 2^15], the "
          f"FLAGSHIP_QP batch [4, 2, 32, 2^15], broadcast and non-contiguous "
          f"operands, the permuted form, random int64 words; K10 at n1 = 4, "
          f"4 loops x n1 = 4, MEDIUM n1 = 91); max |kernel - plain| = {err}",
          flush=True)
    for rec in RK.measure(device):
        print(f"[kernels] {rec['kernel']} ({rec['case']}): kernel "
              f"{rec['ms']:.5f} ms, plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}) = "
              f"{rec['share_of_bound']:.3f} of it", flush=True)
        row = ("rns_map" if (rec["case"], rec["kernel"]) == RK.HEADLINE
               else "mod_product_sum" if rec["case"] == RK.SUM_HEADLINE
               else None)
        if row is not None:
            kernel_rows[row].update(
                max_abs_err=err[row], ms=rec["ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                library_ms=None)
    for rec in RK.host_costs(device):
        print(f"[kernels] K9 {rec['kernel']} host time per call "
              f"{rec['host_us']:.2f} us through ckks.modmath; the plain "
              f"composition {rec['plain_host_us']:.2f} us for its "
              f"{rec['plain_aten_launches']} aten launches", flush=True)


def codec_kernels(device, kernel_rows):
    """K11/K12 held to their plain versions at every case of
    ``bench.codec_kernels``, timed there beside their bounds and the plain
    compositions, with the dispatching functions' host time per call."""
    from hectr_tpu_torch.bench import codec_kernels as CK

    res = CK.check(device)
    print(f"[kernels] K11 (encode) and K12 (decode) held to plain at every "
          f"case of bench.codec_kernels (FLAGSHIP, the FLAGSHIP_QP batch of "
          f"4, MEDIUM's m' form; K12 on encodings, random residues and "
          f"gathered digits): K11's m' entry and K12's y bit-equal, the fused "
          f"embedding bit-equal to its fixed-order sum, {res['rounded_apart']}"
          f" coefficients whose y the plain composition's cuBLAS product "
          f"rounds one unit apart, unembedded values bit-equal to the "
          f"fixed-order sum and within {CK.UNEMBED_RTOL} relative of plain; "
          f"max |kernel - plain| {res['max_abs_err']} (K11 in units of y)",
          flush=True)
    for rec in CK.measure(device):
        print(f"[kernels] {rec['kernel']} ({rec['case']}): kernel "
              f"{rec['ms']:.5f} ms, plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.6f} ms ({rec['bound_by']}) = "
              f"{rec['share_of_bound']:.4f} of it; host {rec['host_us']:.2f} "
              f"us a call, plain {rec['plain_host_us']:.2f} us", flush=True)
        if rec["case"] == CK.HEADLINE:
            kernel_rows[rec["kernel"]].update(
                max_abs_err=res["max_abs_err"][rec["kernel"]], ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], library_ms=None)


def stages_kernels(kernel_rows):
    """K13 held to the uncaptured stages at ``bench.stages_kernels``' cases,
    timed there beside its bound, the uncaptured stages and their CUDA
    graph, with the host's us a step through the loop's K13 holder."""
    from hectr_tpu_torch.bench import stages_kernels as SK

    device = torch.device("cuda", torch.cuda.current_device())
    for rec in SK.measure(device):
        gaps = {mode: f"{g:.3e}" for mode, g in rec["gaps"].items()}
        print(f"[kernels] K13 loop_stages ({rec['case']}): within "
              f"{rec['max_gap']:.3e} of xs / us of the uncaptured stages "
              f"(by mode {json.dumps(gaps)}); step_observe timed: "
              f"kernel {rec['ms']:.5f} ms in {rec['launches']} launch, bound "
              f"{rec['bound_ms']:.7f} ms ({rec['bound_by']}) = "
              f"{rec['share_of_bound']:.5f} of it; uncaptured stages "
              f"{rec['plain_ms']:.4f} ms, their graph "
              f"{rec['plain_graph_ms']:.4f} ms in {rec['plain_launches']} "
              f"launches; host {rec['host_us']:.2f} us a step", flush=True)
        if rec["case"] == "one plant":
            kernel_rows["loop_stages"].update(
                max_abs_err=rec["max_gap"], ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], library_ms=None)


def encrypt_kernels(kernel_rows):
    """K14 held bit-equal to the plain version (``scheme.encrypt_plain``:
    the plain transform and primitives) and to the composition it replaces
    at ``bench.encrypt_kernels``' cases (B 1 and 1,024 at the benchmark's
    ring, FLAGSHIP), timed there beside its bound, the plain version and
    the composition."""
    from hectr_tpu_torch.bench import encrypt_kernels as EK

    device = torch.device("cuda", torch.cuda.current_device())
    for rec in EK.measure(device):
        print(f"[kernels] K14 encrypt ({rec['case']}: {rec['preset']}, "
              f"batch {rec['batch']}, {rec['limbs']} limbs): bit-equal to "
              f"the plain version and the composition; kernel "
              f"{rec['ms']:.5f} ms in {rec['launches']} launch, bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}) = "
              f"{rec['share_of_bound']:.3f} of it; plain "
              f"{rec['plain_ms']:.5f} ms; composition "
              f"{rec['composed_ms']:.5f} ms in "
              f"{rec['composed_launches']} launches", flush=True)
        if rec["case"] == "B 1024":
            kernel_rows["encrypt"].update(
                max_abs_err=0, ms=rec["ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                library_ms=None)


# the launches a loop phase sums: K1/K2, the key-switch kernels K6-K8, the
# scheme ops' kernels K9/K10 and the encode and decode kernels K11/K12
LOOP_KERNELS = ("ntt", "intt", "base_convert", "key_inner_product",
                "mod_down_tail", "rns_map", "mod_product_sum",
                "encode_residues", "crt_decode")


def print_rns_launches(label: str, per: int, what: str) -> None:
    """K9's launches since the last reset by primitive, divided by `per`
    (the phase's steps)."""
    from hectr_tpu_torch.ops import rns_cuda

    ops = {op: round(n / per, 3) for op, n in sorted(
        rns_cuda.OP_LAUNCHES.items())}
    print(f"[{label}] K9 launches per {what} by primitive: {json.dumps(ops)};"
          f" K10 {rns_cuda.LAUNCHES['mod_product_sum'] / per:g}", flush=True)


def print_launch_shapes(label: str, per: int, what: str) -> None:
    """The NTT kernels' launches since the last reset, by input shape,
    divided by `per` (the phase's steps)."""
    from hectr_tpu_torch.ops import ntt_cuda

    shapes = {f"{name} {list(shape)}": round(n / per, 3)
              for (name, shape), n in sorted(ntt_cuda.LAUNCH_SHAPES.items())}
    print(f"[{label}] NTT launches per {what} by shape: {json.dumps(shapes)}",
          flush=True)


def deviations(x, u, x_ref, u_ref) -> np.ndarray:
    """max |a - b| per channel (c, T, h, Tc, F)."""
    return np.concatenate([np.max(np.abs(x - x_ref), axis=0),
                           np.max(np.abs(u - u_ref), axis=0)])


def run_loop(label, preset, rotations, device, card):
    from hectr_tpu_torch import cli

    t0 = time.perf_counter()
    ctx, keys, rot_keys = cli.hempc_keys(preset, 0, device, rotations)
    x_pt, u_pt = cli.run_cstr_mpc(40, device)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    launch_counters.reset()
    t0 = time.perf_counter()
    x, u, canary = cli.run_cstr_hempc(ctx, keys, rot_keys, 40, 0, device)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    launches = launch_counters.by_kernel()
    print_launch_shapes(label, 40, "step")
    print_rns_launches(label, 40, "step")

    check(x.shape == (41, 3) and u.shape == (40, 2), f"{label}: shapes")
    check(bool(np.isfinite(x).all() and np.isfinite(u).all()),
          f"{label}: non-finite trajectory")
    dev = deviations(x, u, x_pt, u_pt)
    print(f"[{label}] keygen + {len(rot_keys)} rotation keys + plaintext "
          f"twin {t_setup:.2f} s; 40-step encrypted loop {t_loop:.3f} s = "
          f"{40 / t_loop:.2f} steps/s on {card}", flush=True)
    print(f"[{label}] max |encrypted - plaintext| per channel (c, T, h, Tc, "
          f"F) = {dev.tolist()}; canary {canary:.3e}; final state "
          f"{x[-1].tolist()}; launches {launches}", flush=True)
    return x, u, dev, canary, launches, (ctx, keys, rot_keys, x_pt, u_pt)


def phase_ceiling(device, kernel_rows, card):
    """K3: the multiply-ceiling probe, and the NTT kernel's share of it."""
    from hectr_tpu_torch.bench import HBM_BYTES_PER_S, lazy_mult_peak_per_s
    from hectr_tpu_torch.bench import vpu_ceiling as V
    from hectr_tpu_torch.ops import build

    x0, c = V.probe_inputs(device)
    err = V.check_kernel(x0, c)
    print(f"[ceiling] mulmod chain kernel bit-equal to plain at r = 0, 1, 2, "
          f"3, 16 and over [{V.ROWS}, {V.LANES}] x {V.R_CHAIN} x {V.CALLS}; "
          f"max |kernel - plain| = {err}", flush=True)
    plain = V.plain_ms(x0, c)
    launch_counters.reset()
    res = V.probe(x0, c)
    launches = launch_counters.by_kernel()
    check(launches["mulmod_chain"] > 0, "mulmod chain kernel never launched "
          "in the probe")
    sass = V.sass_loop_body(
        V.kernel_sass(build.library_path("mulmod_chain.cu")),
        "mulmod_chain_kernel")
    ntt_ms = kernel_rows["ntt"]["ms"]
    rate, share = V.ntt_share(ntt_ms, res["mult_per_s"])
    print(f"[ceiling] pow probe ok (x * w^{V.R_CHAIN * V.CALLS} mod p); "
          f"kernel {res['ms']:.4f} ms, plain {plain:.4f} ms per dispatch of "
          f"{V.CALLS} x {V.R_CHAIN} chained multiplies on [{V.ROWS}, "
          f"{V.LANES}] ({plain / res['ms']:.1f}x) = "
          f"{res['mult_per_s']:.4e} lazy-Shoup mult/s on {card}", flush=True)
    print(f"[ceiling] SASS loop body: {sass['body_instructions']} "
          f"instructions for {sass['multiplies']} multiplies = "
          f"{sass['per_multiply']:.3f} per multiply; {sass['opcodes']}",
          flush=True)
    print(f"[ceiling] ntt [11, 24, 2^15] at {ntt_ms:.4f} ms = 264 x 15 x "
          f"2^14 Shoup multiplies = {rate:.4e} mult/s = {share:.4f} of the "
          f"ceiling", flush=True)
    # the bound of one dispatch: the block in and out once, against its
    # multiplies at the integer multiply peak
    peak = lazy_mult_peak_per_s()
    t_ops = V.ROWS * V.LANES * V.R_CHAIN * V.CALLS / peak * 1e3
    t_bytes = (V.ROWS * V.LANES * 8 * 2 + V.LANES * 4 * 3) / HBM_BYTES_PER_S * 1e3
    bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                                 "bytes")
    print(f"[ceiling] bound of one dispatch {bound:.4f} ms ({by}: "
          f"{peak:.4e} lazy-Shoup mult/s = SMs x 64 IMAD/clock x the maximum "
          f"SM clock / 3); the kernel at {bound / res['ms']:.4f} of it",
          flush=True)
    kernel_rows["mulmod_chain"].update(launches=launches["mulmod_chain"],
                                       max_abs_err=err, ms=res["ms"],
                                       plain_ms=plain, bound_ms=bound,
                                       bound_by=by, library_ms=None)


def phase_fused(device, flagship, card):
    """The fused single-ciphertext regulator at FLAGSHIP, 40 steps."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.ckks.scheme import TorchSampler
    from hectr_tpu_torch.control.simulate import simulate
    from hectr_tpu_torch.hempc import hempc_init_state
    from hectr_tpu_torch.hempc.fused import (make_fused_materials,
                                             make_fused_regulator)

    ctx, keys, rot_keys, x_pt, u_pt = flagship
    model, plant = cli.cstr_setup()
    launch_counters.reset()
    t0 = time.perf_counter()
    mats = make_fused_materials(ctx, rot_keys, model, plant, 4, device)
    reg = make_fused_regulator(ctx, keys, model, plant, 4, mats)
    x, u, (_, canary) = simulate(
        model, plant, cli.disturbance(40), 1.0, 40, device, regulator=reg,
        regulator_state=hempc_init_state(TorchSampler(2, device), device),
        horizon=4, return_state=True)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    launches = launch_counters.by_kernel()
    print_launch_shapes("fused", 40, "step")
    print_rns_launches("fused", 40, "step")
    canary = float(canary)
    check(x.shape == (41, 3) and u.shape == (40, 2)
          and bool(np.isfinite(x).all() and np.isfinite(u).all()),
          "fused: shapes or non-finite trajectory")
    dev = deviations(x, u, x_pt, u_pt)
    print(f"[fused] 40-step fused encrypted loop {t_loop:.3f} s = "
          f"{40 / t_loop:.2f} steps/s on {card}", flush=True)
    print(f"[fused] max |encrypted - plaintext| per channel (c, T, h, Tc, F) "
          f"= {dev.tolist()}; canary {canary:.3e}; final state "
          f"{x[-1].tolist()}; launches {launches}", flush=True)
    check(bool((dev <= 2e-9).all()), f"fused deviation {dev}")
    check(canary < 1e-5, f"fused canary {canary}")
    check(bool(np.allclose(x[-1], FLAGSHIP_FINAL_STATE, rtol=1e-4, atol=0)),
          f"fused final state {x[-1]}")
    return launches


def phase_parallel(device, flagship, card, kernel_rows):
    """The coefficient axis on a local mesh at full width, and two ranks
    sharing the card."""
    from hectr_tpu_torch.bench import run_multiproc
    from hectr_tpu_torch.ckks import ntt as T
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.gemv import make_gemv
    from hectr_tpu_torch.ckks.keyswitch import rotate
    from hectr_tpu_torch.ckks.primes import find_ntt_primes
    from hectr_tpu_torch.parallel import LocalMesh
    from hectr_tpu_torch.ops import ntt_exchange_cuda as EX
    from hectr_tpu_torch.parallel.coeff_ops import CoeffOps
    from hectr_tpu_torch.parallel.multihost import ntt_scaling_efficiency
    from hectr_tpu_torch.parallel.ntt_shard import (clear_local_tables,
                                                    local_ntt_fns,
                                                    local_tables)

    ctx, keys, rot_keys, _, _ = flagship
    k = ctx.max_limbs
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    meshes = {D: LocalMesh(D) for D in (1, 2, 4, 8)}

    # inputs: FLAGSHIP's data chain and digit stack, and rings of 2^16
    # and 2^17 over 22 primes of their own
    tks = ctx.tables_ks(k, device)
    cases = [("data chain", ctx.tables(k, device), ()),
             ("digit stack", tks, (ctx.dnum(k),))]
    for logn in (16, 17):
        primes = tuple(find_ntt_primes(30, k, 2 << logn))
        cases.append((f"2^{logn} ring", T.ntt_tables(1 << logn, primes, device),
                      ()))
    inputs = [random_residues(t.primes, batch, t.n, gen, device)
              for _, t, batch in cases]
    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    v = np.linspace(-1.0, 1.0, ctx.slots)
    ct = S.encrypt(ctx, keys, S.encode(ctx, on(v + 0j), k),
                   S.TorchSampler(70, device))
    prod = S.mul_pt(ctx, ct, S.encode(ctx, on(2.0 * np.ones(ctx.slots) + 0j),
                                      k, scale=ctx.pair_scale(k)))
    a, b = inputs[0], random_residues(ctx.data_primes, (), ctx.n, gen, device)
    Mg = np.zeros((ctx.slots, ctx.slots))
    idx = np.arange(ctx.slots)
    Mg[idx, idx] = 0.5
    Mg[idx, (idx + 3) % ctx.slots] = -0.25

    # the sharded path alone, its launches counted; the single-device
    # references and the comparisons follow
    launch_counters.reset()
    t0 = time.perf_counter()
    sharded = {}
    for (label, t, _), x in zip(cases, inputs):
        for D, mesh in meshes.items():
            if t.n // D > 1 << 15 or D == 1:
                continue
            fwd, inv = local_ntt_fns(t, mesh)
            got = fwd(mesh.shard(x))
            sharded[label, D] = (mesh.gather(got), mesh.gather(inv(got)))
    ops = {D: CoeffOps(ctx, meshes[D]) for D in (2, 4, 8)}
    scheme = {D: (o.rescale_pair(prod), o.negacyclic_mul(a, b),
                  o.rotate(ct, 1, rot_keys),
                  o.make_gemv(Mg, k, rot_keys, device)(ct))
              for D, o in ops.items()}
    torch.cuda.synchronize()
    t_sharded = time.perf_counter() - t0
    launches = launch_counters.by_kernel()
    print_launch_shapes("parallel", 1, "phase")
    print_rns_launches("parallel", 1, "phase")
    exchange_shapes = collections.Counter(EX.LAUNCH_SHAPES)
    print_exchange_shapes("parallel", exchange_shapes)

    n_cases = 0
    for (label, t, _), x in zip(cases, inputs):
        whole = t.n <= 1 << 15
        ref = T.ntt(x, t) if whole else T.ntt_plain(x, t)
        ref_inv = T.intt(ref, t) if whole else T.intt_plain(ref, t)
        check(torch.equal(ref_inv, x), f"parallel: reference round trip, {label}")
        for D, mesh in meshes.items():
            if (label, D) not in sharded:
                continue
            fwd_got, inv_got = sharded.pop((label, D))
            check(torch.equal(fwd_got, ref),
                  f"parallel: sharded ntt != single device, {label}, D={D}")
            check(torch.equal(inv_got, x),
                  f"parallel: sharded round trip, {label}, D={D}")
            # the kernels on the stacked [L*D, C] view against the plain
            # local stages over the gathered tables
            lt = local_tables(t, mesh)
            rows = mesh.shard(x).flatten(-3, -2)
            check(torch.equal(T.ntt(rows, lt), T.ntt_plain(rows, lt))
                  and torch.equal(T.intt(rows, lt), T.intt_plain(rows, lt)),
                  f"parallel: stacked kernels != plain local stages, {label}, "
                  f"D={D}")
            n_cases += 1
    # the same at the other stacked shapes and tables CoeffOps launches:
    # a leading 2 (the ciphertext's halves) over one chain row and the
    # special rows (rescale and mod-down inverses) and over 20-22 chain
    # rows (their forward transforms)
    stacked = [ctx.tables_row(k - 1, device), ctx.tables_row(k - 2, device),
               ctx.tables_special(device), ctx.tables(k - 2, device),
               ctx.tables(k - 1, device), ctx.tables(k, device)]
    n_stacked = 0
    for t in stacked:
        x = random_residues(t.primes, (2,), t.n, gen, device)
        for D in (2, 4, 8):
            lt = local_tables(t, meshes[D])
            rows = meshes[D].shard(x).flatten(-3, -2)
            check(torch.equal(T.ntt(rows, lt), T.ntt_plain(rows, lt))
                  and torch.equal(T.intt(rows, lt), T.intt_plain(rows, lt)),
                  f"parallel: stacked kernels != plain local stages at "
                  f"{list(rows.shape)}")
            n_stacked += 1
    print(f"[parallel] K1/K2 bit-equal to the plain local stages at CoeffOps' "
          f"stacked shapes too ({n_stacked} cases: [2, L*D, 2^15/D] for L = 1 "
          f"(two chain rows), {len(ctx.special_primes)} (special rows), "
          f"{k - 2}, {k - 1}, {k} at D = 2, 4, 8)", flush=True)
    print(f"[parallel] sharded ntt/intt on a local mesh bit-equal to the "
          f"single device ({n_cases} cases: FLAGSHIP [{k}, 2^15] and "
          f"[{ctx.dnum(k)}, {len(tks.primes)}, 2^15] at D = 2, 4, 8 against "
          f"ntt/intt on whole rows; [{k}, 2^16] at D = 2, 4, 8 and "
          f"[{k}, 2^17] at D = 4, 8 against the plain transform), round "
          f"trips exact, K1/K2 on the stacked view bit-equal to the plain "
          f"local stages", flush=True)

    want = (S.rescale_pair(ctx, prod),
            T.negacyclic_mul(a, b, ctx.tables(k, device)),
            rotate(ctx, ct, 1, rot_keys),
            make_gemv(ctx, Mg, k, rot_keys, device, method="diag")(ct))
    names = ("rescale_pair", "negacyclic_mul", "rotate", "gemv")
    for D, got in scheme.items():
        for name, g, w in zip(names, got, want):
            same = (torch.equal(g, w) if name == "negacyclic_mul" else
                    torch.equal(g.data, w.data) and g.scale == w.scale)
            check(same, f"parallel: CoeffOps.{name} != single device at D={D}")
    errs = {}
    for name, g, expect in (("rescale_pair", scheme[8][0], 2.0 * v),
                            ("rotate", scheme[8][2], np.roll(v, -1)),
                            ("gemv", scheme[8][3], Mg @ v)):
        dec = S.decode(ctx, S.decrypt(ctx, keys, g)).cpu().numpy()
        errs[name] = float(np.abs(dec.real - expect).max())
        check(errs[name] <= 1e-6 and float(np.abs(dec.imag).max()) < 1e-5,
              f"parallel: decrypted {name} off by {errs[name]}")
    print(f"[parallel] CoeffOps at FLAGSHIP (logN=15, {k} + "
          f"{len(ctx.special_primes)} primes), D = 2, 4, 8: rescale_pair, "
          f"negacyclic_mul, rotate(1), hoisted gemv (diagonals 0, 3) bit-equal "
          f"to the single-device ops; decrypted max err {errs}; the sharded "
          f"path alone {t_sharded:.2f} s; launches {launches}", flush=True)
    del sharded, scheme, want

    time_sharded(cases, inputs, meshes, card, kernel_rows)

    for logn, D in ((15, 8), (17, 4)):
        rep = ntt_scaling_efficiency(logn, k, meshes[D], device)
        print(f"[parallel] scaling report: {json.dumps(rep)}", flush=True)

    # two ranks sharing the card
    rec = run_multiproc.launch(2, "cuda", 15, 4, "reference-hempc", 300.0)
    check(rec["ok"] and rec["bitexact_per_shard"] and rec["ranks"] == 2,
          f"parallel: two-rank run {rec}")
    for r, (got, checked) in enumerate(zip(rec["exchange_launches"],
                                           rec["exchange_checked"])):
        check(got["exchange_fwd"] > 0 and got["exchange_inv"] > 0
              and checked > 0,
              f"parallel: rank {r} ran K4/K5's received form {got} times, "
              f"held {checked} stages against plain")
    print(f"[parallel] two ranks: K4/K5's received form launched "
          f"{rec['exchange_launches']} times per rank "
          f"(by shape on rank 0: {json.dumps(rec['exchange_shapes'])}); "
          f"{rec['exchange_checked']} stages per rank held bit-equal to the "
          f"plain stages on the chunk the partner sent; forward transforms "
          f"under torch.profiler, per rank: "
          f"{json.dumps(rec['transform_profiles'])}", flush=True)
    print(f"[parallel] two ranks on one card ({rec['mesh']}): sharded ntt "
          f"{rec['ntt']} and {rec['scheme_ops']} bit-equal on each rank's "
          f"shard; paired exchange of {rec['exchange_bytes']} B at "
          f"{[round(x, 4) for x in rec['exchange_gb_per_s']]} GB/s per rank "
          f"through the host (not a link between cards: it says nothing "
          f"about NVLink); {rec['elapsed_s']} s on {card}", flush=True)
    # this phase's local tables (every ring at every D) are as large as the
    # rings' own: later phases get that device memory back
    clear_local_tables()
    for logn in (16, 17):
        chain_launches, chain_shapes = large_ring_chain(logn, device, card)
        for name, count in chain_launches.items():
            launches[name] += count
        exchange_shapes.update(chain_shapes)
    for name in EX.LAUNCHES:
        check(launches[name] > 0, f"parallel: {name} never launched")
    max_err = exchange_against_plain(exchange_shapes, device, gen)
    for name, err in max_err.items():
        kernel_rows[name]["max_abs_err"] = err
    print(f"[parallel] K4/K5 (local form) bit-equal to cross_stages_plain at "
          f"every shape this phase launched them at ({len(exchange_shapes)} "
          f"shapes, the sharded_ring chains' and CoeffOps' included); max "
          f"|kernel - plain| {max_err}; launches in the phase "
          f"{ {name: launches[name] for name in EX.LAUNCHES} }", flush=True)
    return launches


def print_exchange_shapes(label: str, shapes) -> None:
    """K4/K5's launches by (kernel, form, input shape)."""
    got = {f"{name} {form} {list(shape)}": n
           for (name, form, shape), n in sorted(shapes.items())}
    print(f"[{label}] K4/K5 launches by shape: {json.dumps(got)}", flush=True)


def exchange_against_plain(shapes, device, gen) -> dict:
    """K4/K5's local form against cross_stages_plain at every shape in
    `shapes` (keys (name, form, shape) of ``LAUNCH_SHAPES``), on uniform
    residues with 0 and p - 1 planted, over 30-bit primes of that ring:
    the largest |kernel - plain| by kernel.  Fails on any difference."""
    from hectr_tpu_torch.ckks import ntt as T
    from hectr_tpu_torch.ckks.primes import find_ntt_primes
    from hectr_tpu_torch.ops.ntt_exchange_cuda import exchange_local_cuda
    from hectr_tpu_torch.parallel import LocalMesh
    from hectr_tpu_torch.parallel.ntt_shard import cross_stages_plain

    err = {"exchange_fwd": 0, "exchange_inv": 0}
    for name, form, shape in sorted(shapes):
        check(form == "local", f"{name}: {form} form launched in one process")
        *lead, L, D, C = shape
        n = D * C
        primes = tuple(find_ntt_primes(30, L, 2 * n))
        t = T.ntt_tables(n, primes, device)
        x = random_residues(primes, tuple(lead), n, gen,
                            device).unflatten(-1, (D, C))
        inverse = name == "exchange_inv"
        got = exchange_local_cuda(x, t, inverse)
        want = cross_stages_plain(x, t, LocalMesh(D), inverse)
        torch.cuda.synchronize()
        err[name] = max(err[name], int((got - want).abs().max()))
        check(torch.equal(got, want), f"{name} != plain at {list(shape)}")
    return err


# the kernel line's K4/K5 numbers: the 2^17 ring's route (ckks.ntt.sharded_ring)
EXCHANGE_HEADLINE = ("2^17 ring", 4)


def time_sharded(cases, inputs, meshes, card, kernel_rows):
    """Device ms of the sharded transform by D (CUDA-graph replay),
    forward and inverse, through K4/K5 and with the eager stages; K4 and
    K5 alone beside their bound (``bench.exchange_bound``) and the plain
    cross stages (CUDA events); CUDA launches per forward transform
    either way (torch.profiler)."""
    from hectr_tpu_torch import bench
    from hectr_tpu_torch.bench.batch import profile_kernels
    from hectr_tpu_torch.ckks import ntt as T
    from hectr_tpu_torch.ops.ntt_exchange_cuda import exchange_local_cuda
    from hectr_tpu_torch.parallel.ntt_shard import (cross_stages_plain,
                                                    local_ntt_fns,
                                                    local_tables)

    peak = bench.lazy_mult_peak_per_s()
    for (label, t, _), x in zip(cases, inputs):
        logn = t.n.bit_length() - 1
        rows = x.numel() >> logn
        L = len(t.primes)
        bound, by = bench.ntt_bound(rows, L, logn, peak)
        ms = collections.defaultdict(dict)
        launches = {}
        for D, mesh in meshes.items():
            if t.n // D > 1 << 15:
                continue
            fwd, inv = local_ntt_fns(t, mesh)
            xs = mesh.shard(x)
            ms["forward"][D] = bench.cuda_graph_time_ms(lambda: fwd(xs))
            ms["inverse"][D] = bench.cuda_graph_time_ms(lambda: inv(xs))
            if D == 1:
                continue
            lt = local_tables(t, mesh)

            def eager_fwd(v):       # the plain cross stages, then K1
                v = cross_stages_plain(v, t, mesh, False)
                return T.ntt(v.flatten(-3, -2), lt).unflatten(-2, (L, D))

            def eager_inv(v):       # K2, then the plain cross stages
                v = T.intt(v.flatten(-3, -2), lt).unflatten(-2, (L, D))
                return cross_stages_plain(v, t, mesh, True)

            check(torch.equal(eager_fwd(xs), fwd(xs))
                  and torch.equal(eager_inv(xs), inv(xs)),
                  f"parallel: eager stages != K4/K5 at {label}, D={D}")
            ms["eager forward"][D] = bench.cuda_graph_time_ms(
                lambda: eager_fwd(xs))
            ms["eager inverse"][D] = bench.cuda_graph_time_ms(
                lambda: eager_inv(xs))
            for name, inverse in (("K4", False), ("K5", True)):
                ms[name][D] = bench.cuda_graph_time_ms(
                    lambda: exchange_local_cuda(xs, t, inverse))
                ms[f"plain {name}"][D] = bench.cuda_time_ms(
                    lambda: cross_stages_plain(xs, t, mesh, inverse))
            ex_bound, ex_by = bench.exchange_bound(rows, L, logn, D, "local",
                                                   peak)
            ms["K4/K5 bound"][D] = ex_bound
            launches[D] = {
                "K4/K5": profile_kernels(lambda: fwd(xs))["kernel_launches"],
                "eager": profile_kernels(
                    lambda: eager_fwd(xs))["kernel_launches"]}
            if (label, D) == EXCHANGE_HEADLINE:
                for key, name in (("exchange_fwd", "K4"),
                                  ("exchange_inv", "K5")):
                    kernel_rows[key].update(
                        ms=ms[name][D], plain_ms=ms[f"plain {name}"][D],
                        bound_ms=ex_bound, bound_by=ex_by, library_ms=None)
        single = (f"; single K1 launch "
                  f"{bench.cuda_graph_time_ms(lambda: T.ntt(x, t)):.5f} ms"
                  if logn <= 15 else "; no single launch above 2^15")
        table = {k: {D: round(v, 5) for D, v in row.items()}
                 for k, row in ms.items()}
        print(f"[parallel] sharded transform {list(x.shape)} ({label}) ms by "
              f"D on {card}: {json.dumps(table)}; whole-transform bound "
              f"{bound:.5f} ms ({by}){single}; CUDA launches per forward "
              f"transform by D {json.dumps(launches)}", flush=True)


def large_ring_chain(logn, device, card):
    """encrypt -> mul_pt -> rescale_pair -> decrypt at a ring above 2^15
    through the scheme ops alone (ckks.ntt routes every transform to the
    sharded one): the decrypted product to 1e-6, the chain's peak device
    memory above what was held before it, and the bytes the route's
    cached local tables hold.  Returns the chain's kernel launches and
    K4/K5's launches by shape."""
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.config import CKKSPreset
    from hectr_tpu_torch.ops import ntt_exchange_cuda as EX
    from hectr_tpu_torch.parallel.ntt_shard import clear_local_tables

    ctx = make_context(CKKSPreset(name=f"he-{logn}-109", logn=logn, slots=16,
                                  scale_bits=50, limb_bits=25, mult_depth=1))
    k = ctx.max_limbs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    launch_counters.reset()
    keys = S.keygen(ctx, S.TorchSampler(0, device), device)
    v = torch.linspace(-1, 1, 16, dtype=torch.float64, device=device)
    w = torch.linspace(0.5, -0.5, 16, dtype=torch.float64, device=device)
    zero = torch.zeros_like(v)
    ct = S.encrypt(ctx, keys, S.encode(ctx, (v, zero), k),
                   S.TorchSampler(1, device))
    pt = S.encode(ctx, (w, zero), k, ctx.pair_scale(k))
    out = S.rescale_pair(ctx, S.mul_pt(ctx, ct, pt))
    re, im = S.decode_ri(ctx, S.decrypt(ctx, keys, out))
    err = float((re - v * w).abs().max())
    err_im = float(im.abs().max())
    torch.cuda.synchronize()
    launches = launch_counters.by_kernel()
    shapes = collections.Counter(EX.LAUNCH_SHAPES)
    peak = torch.cuda.max_memory_allocated(device)
    del ct, pt, out, re, im
    held = torch.cuda.memory_allocated(device)
    clear_local_tables()
    cached = held - torch.cuda.memory_allocated(device)
    print(f"[parallel] scheme ops at logN={logn} ({k} + "
          f"{len(ctx.special_primes)} primes) on the card through ckks.ntt's "
          f"sharded route: decrypted product off by {err:.3e} (imag "
          f"{err_im:.3e}); peak device memory {peak - base} B above the "
          f"{base} B held before; the route's cached local tables held "
          f"{cached} B; launches {launches} on {card}", flush=True)
    check(err < 1e-6 and err_im < 1e-6,
          f"logN={logn} chain decrypted off by {err}, {err_im}")
    check(cached > 0, f"logN={logn}: no local tables were cached")
    check(launches["exchange_fwd"] > 0 and launches["exchange_inv"] > 0,
          f"logN={logn}: the chain ran no K4/K5 launch: {launches}")
    return launches, shapes


class RowDraws:
    """Encryption draws replayed per row: row b from its own numpy
    generator, so a 1-D run given one row's generator draws what that
    row of the batched run draws."""

    def __init__(self, seeds, device):
        self.rngs = [np.random.default_rng(s) for s in seeds]
        self.device = device

    def encryption(self, ctx, k, batch, device):
        check(int(np.prod(batch, dtype=np.int64)) == len(self.rngs),
              f"replay sampler of {len(self.rngs)} rows given batch {batch}")
        rows = []
        for rng in self.rngs:
            r = rng.integers(0, 4, ctx.n)
            rows.append(((r == 3).astype(np.int64) - (r == 0),
                         np.round(3.2 * rng.normal(size=ctx.n)).astype(np.int64),
                         np.round(3.2 * rng.normal(size=ctx.n)).astype(np.int64)))
        return tuple(torch.from_numpy(np.stack(d)).reshape(*batch, ctx.n)
                     .to(self.device) for d in zip(*rows))


def spy_regulator(run):
    """run() with scheme.encode / encrypt / decrypt / decode_ri recording
    the encode inputs (re and im stacked: [2, ..., s]), the plaintexts
    encrypted, the ciphertexts made and decrypted and the decoded values
    ([2, ..., s]): (run's result, records)."""
    from hectr_tpu_torch.ckks import scheme as S

    rec = {"in": [], "pt": [], "ct": [], "dec": [], "out": []}
    encode, encrypt, decrypt, decode_ri = (S.encode, S.encrypt, S.decrypt,
                                           S.decode_ri)

    def encode_spy(ctx, v, k, scale=None):
        rec["in"].append(torch.stack(v))
        return encode(ctx, v, k, scale)

    def decode_spy(ctx, pt):
        out = decode_ri(ctx, pt)
        rec["out"].append(torch.stack(out))
        return out

    def enc_spy(ctx, keys, pt, sampler):
        ct = encrypt(ctx, keys, pt, sampler)
        rec["pt"].append(pt.data.clone())
        rec["ct"].append(ct.data.clone())
        return ct

    def dec_spy(ctx, keys, ct):
        rec["dec"].append(ct.data.clone())
        return decrypt(ctx, keys, ct)

    S.encode, S.encrypt, S.decrypt, S.decode_ri = (encode_spy, enc_spy,
                                                   dec_spy, decode_spy)
    try:
        out = run()
    finally:
        S.encode, S.encrypt, S.decrypt, S.decode_ri = (encode, encrypt,
                                                       decrypt, decode_ri)
    return out, rec


def rows_equal_1d(label, reg, B, steps, device):
    """Rows 0 and B-1 of a `steps`-step batched run against the 1-D
    regulator given the same draws.  K11 and K12 sum each batch row in one
    fixed order, so at every row-step whose encode inputs equal the 1-D
    run's (the plant and estimator's cuBLAS products may round a batch row
    an ulp apart), the plaintexts, the uploaded and decrypted ciphertexts
    and the decoded values must be bit-equal; decoded u within 1e-12
    everywhere."""
    from hectr_tpu_torch.bench import batch as BB
    from hectr_tpu_torch.hempc import hempc_init_state

    xs, u0 = BB.protocol_inputs(B, steps, device, seed=5)
    seeds = [1000 + b for b in range(B)]
    (us, _), rec = spy_regulator(lambda: BB.run_rounds(
        reg, hempc_init_state(RowDraws(seeds, device), device, (B,)), xs, u0,
        1))
    agree, total, err = 0, 0, 0.0
    for b in (0, B - 1):
        (us1, _), rec1 = spy_regulator(lambda: BB.run_rounds(
            reg, hempc_init_state(RowDraws([seeds[b]], device), device),
            xs[b], u0[b], 1))
        err = max(err, float((us[:, b] - us1).abs().max()))
        per = len(rec1["pt"]) // steps         # encrypts a step
        per_in = len(rec1["in"]) // steps      # encodes a step
        for i in range(steps):
            total += 1
            if all(torch.equal(rec["in"][j][:, b], rec1["in"][j])
                   for j in range(i * per_in, (i + 1) * per_in)):
                agree += 1
                check(all(torch.equal(rec[key][j][b], rec1[key][j])
                          for key in ("pt", "ct")
                          for j in range(i * per, (i + 1) * per))
                      and torch.equal(rec["dec"][i][b], rec1["dec"][i])
                      and torch.equal(rec["out"][i][:, b], rec1["out"][i]),
                      f"{label}: row {b} step {i}: plaintexts, ciphertexts "
                      f"or decoded values differ from the 1-D run with equal "
                      f"encode inputs")
    print(f"[batch] {label} rows 0 and {B - 1} vs the 1-D regulator with the "
          f"same draws over {steps} steps: encode inputs equal in {agree} of "
          f"{total} row-steps (plaintexts, ciphertexts and decoded values "
          f"bit-equal there), max |u - u_1d| {err:.3e}", flush=True)
    check(err <= 1e-12, f"{label}: batched row vs 1-D u differ by {err}")


def phase_batch(device, flagship, card):
    """The batch axis: B independent loops through one regulator, every
    op one launch for the whole batch."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.bench import batch as BB
    from hectr_tpu_torch.ckks.scheme import TorchSampler
    from hectr_tpu_torch.control.simulate import (make_mpc_regulator,
                                                  simulate_batch)
    from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
    from hectr_tpu_torch.hempc.fused import (make_fused_materials,
                                             make_fused_regulator)
    from hectr_tpu_torch.ops import ntt_cuda
    from hectr_tpu_torch.utils import read_traj_bin

    model, plant = cli.cstr_setup()
    total = dict.fromkeys(LOOP_KERNELS, 0)

    def tally():
        launches = launch_counters.by_kernel()
        for k in total:
            total[k] += launches[k]

    def closed_loop(label, reg, B, bar):
        p = np.stack([cli.disturbance(40) * (1 + b / B) for b in range(B)])
        torch.cuda.reset_peak_memory_stats(device)
        launch_counters.reset()
        t0 = time.perf_counter()
        x, u, (_, canary) = simulate_batch(
            model, plant, p, 1.0, 40, device, regulator=reg,
            regulator_state=hempc_init_state(TorchSampler(2, device), device,
                                             (B,)), horizon=4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tally()
        launches = dict(ntt_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(device)
        x_pt, u_pt, _ = simulate_batch(model, plant, p, 1.0, 40, device,
                                       horizon=4)
        check(x.shape == (B, 41, 3) and u.shape == (B, 40, 2)
              and bool(np.isfinite(x).all() and np.isfinite(u).all()),
              f"{label}: shapes or non-finite trajectories")
        dev = np.stack([deviations(x[b], u[b], x_pt[b], u_pt[b])
                        for b in range(B)])
        canary = canary.cpu().numpy()
        print(f"[batch] {label}: {B} loops x 40 steps in {wall:.3f} s = "
              f"{B * 40 / wall:.2f} loop-steps/s aggregate, "
              f"{40 / wall:.2f} per loop; NTT launches per batched step "
              f"{ {k: v / 40 for k, v in launches.items()} }; peak device "
              f"memory {peak} B on {card}", flush=True)
        print(f"[batch] {label}: max |encrypted - plaintext twin| per channel "
              f"over the loops {dev.max(axis=0).tolist()}; canaries "
              f"{canary.min():.3e}..{canary.max():.3e}; loop 0 final state "
              f"{x[0, -1].tolist()}", flush=True)
        check(bool((dev <= bar).all()), f"{label}: deviation {dev.max(0)}")
        check(bool((canary < 1e-5).all()), f"{label}: canary {canary.max()}")
        return x, u

    # REFERENCE_HEMPC: 16 loops, loop b's disturbance scaled by 1 + b/16
    ref = BB.reference_setup(device)
    ctx, keys, rk = ref[:3]
    reg = make_hempc_regulator(ctx, keys, rk, model, plant, 4)
    x, u = closed_loop("reference-hempc B=16", reg, 16, 5e-10)
    golden_x, golden_u = read_traj_bin(ROOT / "tests/golden/cstr-hempc.bin")
    golden = np.hstack([golden_x, golden_u])
    ours = np.hstack([x[0], np.vstack([u[0], u[0, -1:]])])
    rel = np.max(np.abs(ours - golden), axis=0) / np.max(np.abs(golden), axis=0)
    print(f"[batch] reference-hempc loop 0 vs golden cstr-hempc.bin: max "
          f"relative error per channel {rel.tolist()}", flush=True)
    check(bool((rel < 1e-6).all()), f"batch golden mismatch {rel}")

    # the serving curve: every row's u against the plaintext law on its
    # own inputs, NTT launches per batched step the same at every B
    law = make_mpc_regulator(model, plant, 4, device)
    per_step = {}
    for B in (1, 16, 64):
        xs, u0 = BB.protocol_inputs(B, 4, device)
        state = hempc_init_state(TorchSampler(3, device), device, (B,))
        BB.run_rounds(reg, state, xs[..., :1, :], u0, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        launch_counters.reset()
        t0 = time.perf_counter()
        us, state = BB.run_rounds(reg, state, xs, u0, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tally()
        per_step[B] = {k: v / 4 for k, v in ntt_cuda.LAUNCHES.items()}
        print_launch_shapes(f"batch B={B}", 4, "batched step")
        uhat = torch.cat([u0[:, None], us[0, :, :-1]], dim=1)
        zx = torch.zeros(3, dtype=torch.float64, device=device)
        zu = torch.zeros(2, dtype=torch.float64, device=device)
        want, _ = law(None, xs, uhat, zx, zu)
        err = float((us[0] - want).abs().max())
        print(f"[batch] reference-hempc serving B={B}: {4 * B / wall:.2f} "
              f"steps/s aggregate, {4 / wall:.2f} per loop; NTT launches per "
              f"batched step {per_step[B]}; max |u - plaintext law| {err:.3e}; "
              f"peak device memory {torch.cuda.max_memory_allocated(device)} B "
              f"on {card}", flush=True)
        check(err <= 1e-8, f"batch serving B={B}: u off the law by {err}")
    check(per_step[1] == per_step[16] == per_step[64],
          f"NTT launches per step grow with the batch: {per_step}")
    rows_equal_1d("reference-hempc B=16", reg, 16, 4, device)
    del ref, reg

    # FLAGSHIP fused on phase 4's keys: 8 loops
    ctx, keys, rk, _, _ = flagship
    mats = make_fused_materials(ctx, rk, model, plant, 4, device)
    reg = make_fused_regulator(ctx, keys, model, plant, 4, mats)
    x, _ = closed_loop("flagship-fused B=8", reg, 8, 2e-9)
    check(bool(np.allclose(x[0, -1], FLAGSHIP_FINAL_STATE, rtol=1e-4, atol=0)),
          f"batch fused loop 0 final state {x[0, -1]}")
    rows_equal_1d("flagship-fused B=8", reg, 8, 4, device)
    return total


def phase_limb(device, flagship, card):
    """The limb axis at FLAGSHIP on phase 4's keys: LimbOps on local limb
    meshes of 2 and 3 shards, K1/K2 at the shard shapes, 4 loops x 40
    steps of the reference-shaped regulator on LocalLimbMesh(2) against
    the unsharded batched regulator, and two gloo ranks sharing the
    card."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.bench import batch as BB
    from hectr_tpu_torch.bench import run_multiproc
    from hectr_tpu_torch.ckks import gemv as G
    from hectr_tpu_torch.ckks import keyswitch as K
    from hectr_tpu_torch.ckks import ntt as T
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.control.simulate import simulate_batch
    from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
    from hectr_tpu_torch.ops import ntt_cuda
    from hectr_tpu_torch.parallel import make_mesh
    from hectr_tpu_torch.parallel.limb_ops import LimbOps

    ctx, keys, rot_keys, _, _ = flagship
    k = ctx.max_limbs
    model, plant = cli.cstr_setup()
    v = torch.linspace(-1.0, 1.0, ctx.slots, dtype=torch.float64,
                       device=device)
    zero = torch.zeros_like(v)
    ct = S.encrypt(ctx, keys, S.encode(ctx, (v, zero), k),
                   S.TorchSampler(80, device))
    prod = S.mul_pt(ctx, ct, S.encode(ctx, (2.0 * v, zero), k,
                                      scale=ctx.pair_scale(k)))
    M = np.random.default_rng(81).normal(size=(ctx.slots, ctx.slots)) / 4
    shard_shapes = collections.Counter()
    total = dict.fromkeys(LOOP_KERNELS, 0)

    def tally():
        shard_shapes.update(ntt_cuda.LAUNCH_SHAPES)
        launches = launch_counters.by_kernel()
        for name in total:
            total[name] += launches[name]

    # the ops on local limb meshes of 2 and 3, the sharded path alone
    # counted; the single-device references and comparisons follow
    launch_counters.reset()
    got = {}
    for D in (2, 3):
        ops = LimbOps(ctx, make_mesh(limb=D, device=device))
        keys_l = ops.shard_keys(rot_keys)
        lct = ops.shard_ct(ct)
        gv = ops.gemv_apply(ops.gemv_materials(M, k, rot_keys, device, "bsgs"),
                            lct)
        got[D] = {
            "rescale_pair": ops.gather_ct(ops.rescale_pair(ops.shard_ct(prod))),
            "digits": torch.cat(ops.decompose(ops.shard_data(ct.data[1]), k),
                                dim=-2),
            "key_switch": torch.cat(ops.key_switch(
                ops.shard_data(ct.data[1]), keys_l[1], k), dim=-2),
            "rotate": ops.gather_ct(ops.rotate(lct, 1, keys_l)),
            "gemv": ops.gather_ct(gv),
            "decoded": ops.decode(ops.decrypt(ops.shard_keyset(keys), gv)),
            # each shard's rows of the extended digits: data, then special
            "order": torch.cat([torch.cat([
                torch.arange(*ops.rows.data_rows(s, k)),
                k + torch.arange(*ops.rows.special_rows(s))])
                for s in ops.held]),
        }
    torch.cuda.synchronize()
    tally()
    print_launch_shapes("limb ops", 1, "phase (D = 2 and 3)")
    want = {
        "rescale_pair": S.rescale_pair(ctx, prod),
        "digits": K.decompose_digits(ctx, ct.data[1]),
        "key_switch": K.key_switch(ctx, ct.data[1], rot_keys[1]),
        "rotate": K.rotate(ctx, ct, 1, rot_keys),
        "gemv": G.gemv_apply(ctx, G.gemv_materials(ctx, M, k, rot_keys, device,
                                                   "bsgs"), ct),
    }
    expect = M @ v.cpu().numpy()
    errs = {}
    for D, g in got.items():
        for name, w in want.items():
            if name == "digits":
                same = torch.equal(g[name], w.index_select(
                    -2, g["order"].to(device)))
            elif name == "key_switch":
                same = torch.equal(g[name], w)
            else:
                same = torch.equal(g[name].data, w.data) and \
                    g[name].scale == w.scale
            check(same, f"limb: LimbOps {name} != single device at D={D}")
        errs[D] = float(np.abs(g["decoded"].cpu().numpy().real - expect).max())
        check(errs[D] <= 1e-6, f"limb: decoded gemv off by {errs[D]} at D={D}")
    print(f"[limb] LimbOps at FLAGSHIP ({k} + {len(ctx.special_primes)} rows), "
          f"D = 2, 3: rescale_pair, digit decomposition, key_switch, "
          f"rotate(1), BSGS gemv bit-equal to the single-device ops; decrypted "
          f"+ decoded gemv max err {errs}", flush=True)
    del got, want

    # B = 4 loops x 40 steps on LocalLimbMesh(2) against the unsharded
    # batched regulator with the same draws
    B, steps = 4, 40
    p = np.stack([cli.disturbance(steps)] * B)
    ops = LimbOps(ctx, make_mesh(limb=2, device=device))
    reg_l = make_hempc_regulator(ctx, keys, rot_keys, model, plant, 4,
                                 ops=ops)
    reg = make_hempc_regulator(ctx, keys, rot_keys, model, plant, 4)
    runs = {}
    for label, r in (("sharded", reg_l), ("unsharded", reg)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        launch_counters.reset()
        ops.gathered.clear()
        t0 = time.perf_counter()
        x, u, (_, canary) = simulate_batch(
            model, plant, p, 1.0, steps, device, r,
            hempc_init_state(S.TorchSampler(82, device), device, (B,)), 4)
        torch.cuda.synchronize()
        runs[label] = dict(x=x, u=u, canary=canary.cpu().numpy(),
                           wall=time.perf_counter() - t0,
                           peak=torch.cuda.max_memory_allocated(device),
                           launches=dict(ntt_cuda.LAUNCHES))
        if label == "sharded":
            tally()
            runs[label]["gathered"] = {w: n / steps
                                       for w, n in ops.gathered.items()}
            print_launch_shapes("limb loop", steps, "step")
    sh, un = runs["sharded"], runs["unsharded"]
    check(np.array_equal(sh["u"], un["u"]) and np.array_equal(sh["x"], un["x"]),
          "limb: sharded loop u / x differ from the unsharded batched loop")
    x_pt, u_pt, _ = simulate_batch(model, plant, p, 1.0, steps, device,
                                   horizon=4)
    dev = np.stack([deviations(sh["x"][b], sh["u"][b], x_pt[b], u_pt[b])
                    for b in range(B)])
    print(f"[limb] FLAGSHIP reference-shaped regulator on LocalLimbMesh(2), "
          f"{B} loops x {steps} steps: u and x bit-equal to the unsharded "
          f"batched regulator at every step; max |encrypted - plaintext| per "
          f"channel {dev.max(axis=0).tolist()}; canaries "
          f"{sh['canary'].min():.3e}..{sh['canary'].max():.3e}; final states "
          f"{sh['x'][:, -1].tolist()}", flush=True)
    check(bool((dev <= 2e-9).all()), f"limb: deviation {dev.max(axis=0)}")
    check(bool((sh["canary"] < 1e-5).all()), f"limb: canary {sh['canary']}")
    check(all(np.allclose(sh["x"][b, -1], FLAGSHIP_FINAL_STATE, rtol=1e-4,
                          atol=0) for b in range(B)),
          f"limb: final states {sh['x'][:, -1]}")

    # K1/K2 against plain at every shard shape the phase launched them at
    gen = torch.Generator(device=device)
    gen.manual_seed(83)
    shapes = sorted({shape for _, shape in shard_shapes})
    for shape in shapes:
        n, rows = shape[-1], shape[-2]
        t = T.ntt_tables(n, ctx.full_primes[:rows], device)
        x = random_residues(t.primes, shape[:-2], n, gen, device)
        check(torch.equal(T.ntt(x, t), T.ntt_plain(x, t))
              and torch.equal(T.intt(x, t), T.intt_plain(x, t)),
              f"limb: K1/K2 != plain at {list(shape)}")
    print(f"[limb] K1/K2 bit-equal to plain at the phase's {len(shapes)} "
          f"launch shapes: {[list(s) for s in shapes]}", flush=True)

    # device ms and CUDA launches per step (torch.profiler over one step
    # each), gathered bytes, peak memory, key bytes
    xs, u0 = BB.protocol_inputs(B, 1, device, seed=7)
    zx = torch.zeros(3, dtype=torch.float64, device=device)
    zu = torch.zeros(2, dtype=torch.float64, device=device)
    prof = {}
    for label, r in (("sharded", reg_l), ("unsharded", reg)):
        state = hempc_init_state(S.TorchSampler(84, device), device, (B,))
        r(state, xs[:, 0], u0, zx, zu)
        prof[label] = BB.profile_kernels(
            lambda r=r, state=state: r(state, xs[:, 0], u0, zx, zu))
    key_bytes = [0, 0]
    for key in rot_keys.values():
        for s, n in enumerate(ops.key_bytes(ops.shard_key(key))):
            key_bytes[s] += n
    print(f"[limb] per batched step of {B} loops at FLAGSHIP on {card}: "
          f"gathered bytes by op {json.dumps(sh['gathered'])} (sum "
          f"{sum(sh['gathered'].values()):.0f} B); sharded "
          f"{prof['sharded']['device_ms']:.3f} device ms, "
          f"{prof['sharded']['kernel_launches']} CUDA launches; unsharded "
          f"{prof['unsharded']['device_ms']:.3f} device ms, "
          f"{prof['unsharded']['kernel_launches']} CUDA launches; NTT "
          f"launches per step sharded "
          f"{ {n: c / steps for n, c in sh['launches'].items()} } unsharded "
          f"{ {n: c / steps for n, c in un['launches'].items()} }; 40-step "
          f"loop {sh['wall']:.3f} s sharded, {un['wall']:.3f} s unsharded; "
          f"peak device memory {sh['peak']} B sharded, {un['peak']} B "
          f"unsharded; BSGS key bytes per shard {key_bytes} (whole "
          f"{sum(key_bytes)})", flush=True)

    # two gloo ranks sharing the card, one FLAGSHIP regulator step each
    rec = run_multiproc.launch(2, "cuda", 15, 4, "flagship", 300.0, limb=2)
    check(rec["ok"] and rec["bitexact_per_shard"] and rec["ranks"] == 2,
          f"limb: two-rank run {rec}")
    for st in rec["limb_steps"]:
        print(f"[limb] {st['limb_mesh']}: one FLAGSHIP step over "
              f"{st['loops']} loops bit-equal on this rank's rows "
              f"({st['checked']} ciphertexts and plaintexts); timed step "
              f"{st['step_ms']:.1f} ms; gathered {st['gathered_bytes']} B; "
              f"digit-stack gather {st['gather_bytes']} B at "
              f"{st['gather_gb_per_s']:.4f} GB/s through the host (not a link "
              f"between cards); BSGS key blocks on this rank "
              f"{st['key_block_bytes']} B; device memory held for the "
              f"sharded step {st['held_bytes']} B, peak of the timed steps "
              f"{st['step_peak_bytes']} B, peak of the check "
              f"{st['check_peak_bytes']} B (both ranks share the card)",
              flush=True)
    print(f"[limb] two ranks on one card: {rec['elapsed_s']} s", flush=True)
    return total


def phase_qp(device, card):
    """The constrained encrypted loop at FLAGSHIP_QP, set up as
    scripts/run_flagship_qp_tpu.py sets it up, against its plaintext
    mirror and the JAX run's recorded mirror numbers; then the same
    regulator over 4 loops at once (simulate_batch), each under a share
    of the recorded disturbance, against the batched mirror."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.bench import batch as BB
    from hectr_tpu_torch.ckks import ntt as T
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.gemv import bsgs_rotations
    from hectr_tpu_torch.config import FLAGSHIP_QP
    from hectr_tpu_torch.control.mpc import mpc_hessian
    from hectr_tpu_torch.control.stages import weighting_matrices
    from hectr_tpu_torch.hempc.qp_enc import pgd_eta, pgd_limbs_required
    from hectr_tpu_torch.ops import ntt_cuda

    want = json.loads(QP_SUMMARY.read_text())
    bounds = BB.qp_bounds()
    iters, degree, horizon, steps = BB.QP_ITERS, BB.QP_DEGREE, 4, BB.QP_STEPS
    model, plant = cli.cstr_setup()
    p_seq = BB.qp_disturbance(plant)          # +10% inlet flow from k=2

    # the plaintext mirror on the host; the envelope B0 is widened until
    # the trajectory's input certificate fits under it
    B0, cert, x_m, u_m = BB.qp_envelope(model, plant, p_seq)
    cert = float(cert)
    ny, nx = np.shape(model.C)
    nu = np.shape(model.B)[1]
    Q, R = weighting_matrices(plant.xs, plant.us)
    H = mpc_hessian(ny, nx, nu, horizon, model.A, model.B, model.C, Q, R)
    lb = np.tile(bounds.dumin, horizon)
    ub = np.tile(bounds.dumax, horizon)
    eta = pgd_eta(H, lb, ub, B0)
    wq = want["qp"]
    rel_eta = abs(eta - wq["eta"]) / wq["eta"]
    rel_cert = (abs(cert - want["input_certificate"])
                / want["input_certificate"])
    print(f"[flagship-qp] mirror: eta {eta!r} (JAX run {wq['eta']!r}, rel. "
          f"{rel_eta:.2e}), envelope B0 {B0} (JAX run {wq['input_bound']}), "
          f"certificate {cert!r} (JAX run {want['input_certificate']!r}, rel. "
          f"{rel_cert:.2e})", flush=True)
    check(cert <= B0, f"mirror certificate {cert} > envelope {B0}")
    # cond(H) = 3.1e8, so the float64 gains (and with them the
    # certificate) agree across BLAS/LAPACK builds only to about
    # eps * cond(H) = 7e-8 relative; on one machine the port's mirror
    # equals the JAX package's to ~1e-15 (tests/test_torch_qp_enc.py)
    check(rel_eta <= 1e-7 and B0 == wq["input_bound"] and rel_cert <= 1e-7,
          "mirror differs from results/flagship_qp_tpu/summary.json")

    ctx = make_context(FLAGSHIP_QP)
    need = pgd_limbs_required(degree, iters, "w_scaled")
    check(need == wq["depth_ledger"]["needed"]
          and ctx.max_limbs - 2 - need == len(ctx.base_primes),
          f"depth ledger: {need} limbs below k_in = {ctx.max_limbs - 2}")
    t0 = time.perf_counter()
    reg = BB.qp_regulator(device, model, plant, B0)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    total = dict.fromkeys(LOOP_KERNELS, 0)

    def tally():
        launches = launch_counters.by_kernel()
        for k in total:
            total[k] += launches[k]

    def held_to_mirror(label, x, u, canary, x_m, u_m):
        dev = np.stack([deviations(x[b], u[b], x_m[b], u_m[b])
                        for b in range(x.shape[0])])
        box_ok = BB.qp_box_ok(u)
        active = BB.qp_activity(u[0])
        print(f"[flagship-qp] {label}: max |encrypted - mirror| per channel "
              f"(c, T, h, Tc, F) = {dev.max(axis=0).tolist()}; box honored "
              f"{box_ok}, activity of loop 0 {active:.4f}; canaries "
              f"{canary.tolist()}", flush=True)
        check(bool((dev < 1e-4).all()), f"flagship-qp {label} deviation {dev}")
        check(box_ok, f"flagship-qp {label}: du outside the box")
        check(active > 0.8, f"flagship-qp {label}: box not active ({active})")
        check(bool((canary < 1e-5).all()), f"flagship-qp {label} canary "
              f"{canary}")

    launch_counters.reset()
    x, u, canary, step_s = BB.qp_closed_loop(reg, model, plant, p_seq, device)
    tally()
    print_launch_shapes("flagship-qp", steps, "step")
    check(x.shape == (steps + 1, 3) and u.shape == (steps, 2)
          and bool(np.isfinite(x).all() and np.isfinite(u).all()),
          "flagship-qp: shapes or non-finite trajectory")
    print(f"[flagship-qp] keygen + compact relin + "
          f"{len(bsgs_rotations(ctx.slots))} compact BSGS keys + regulator "
          f"build {t_setup:.2f} s; median regulator step "
          f"{np.median(step_s) * 1e3:.1f} ms over {steps} steps on {card}; "
          f"launches {dict(total)}", flush=True)
    held_to_mirror("one loop", x[None], u[None], canary[None], x_m[None],
                   u_m[None])

    # 4 loops through the same regulator, loop b under (1, 0.75, 0.5,
    # 0.25)[b] x the disturbance: none larger, so B0 covers every loop
    scales = (1.0, 0.75, 0.5, 0.25)
    p4 = np.stack([BB.qp_disturbance(plant, steps, s) for s in scales])
    B0_4, cert4, x_m4, u_m4 = BB.qp_envelope(model, plant, p4)
    check(B0_4 == B0 and bool((cert4 <= B0).all()),
          f"4 loops: certificates {cert4} outside the envelope {B0}")
    torch.cuda.reset_peak_memory_stats(device)
    launch_counters.reset()
    x, u, canary, step_s = BB.qp_closed_loop(reg, model, plant, p4, device)
    tally()
    shapes = sorted({shape for _, shape in ntt_cuda.LAUNCH_SHAPES})
    print_launch_shapes("flagship-qp B=4", steps, "batched step")
    check(x.shape == (4, steps + 1, 3) and u.shape == (4, steps, 2)
          and bool(np.isfinite(x).all() and np.isfinite(u).all()),
          "flagship-qp B=4: shapes or non-finite trajectories")
    print(f"[flagship-qp] 4 loops x {steps} steps: median batched step "
          f"{np.median(step_s) * 1e3:.1f} ms = "
          f"{4 / np.median(step_s):.2f} loop-steps/s; certificates "
          f"{cert4.tolist()} under B0 {B0}; peak device memory "
          f"{torch.cuda.max_memory_allocated(device)} B on {card}", flush=True)
    held_to_mirror("4 loops", x, u, canary, x_m4, u_m4)
    rows_equal_1d("flagship-qp B=4", reg, 4, 1, device)

    # K1/K2 against plain at every batched shape the 4 loops launched
    gen = torch.Generator(device=device)
    gen.manual_seed(85)
    for shape in shapes:
        n, rows = shape[-1], shape[-2]
        t = T.ntt_tables(n, ctx.full_primes[:rows], device)
        a = random_residues(t.primes, shape[:-2], n, gen, device)
        check(torch.equal(T.ntt(a, t), T.ntt_plain(a, t))
              and torch.equal(T.intt(a, t), T.intt_plain(a, t)),
              f"flagship-qp: K1/K2 != plain at {list(shape)}")
    print(f"[flagship-qp] K1/K2 bit-equal to plain at the 4 loops' "
          f"{len(shapes)} launch shapes", flush=True)
    return total


def facade_problem():
    """The op chain's data of tests/test_he_facade.py (src/hempc.c:240-266);
    the port's facade tests build their problem here too."""
    rng = np.random.default_rng(0)
    xhat = np.zeros(16, np.complex128)
    xhat[:3] = rng.uniform(-1, 1, 3)
    xr = np.zeros(16, np.complex128)
    xr[:3] = rng.uniform(-1, 1, 3)
    uhat = np.zeros(16, np.complex128)
    uhat[:2] = rng.uniform(-1, 1, 2)
    ur = np.zeros(16, np.complex128)
    K_A = np.zeros((16, 16))
    K_A[:8, :3] = rng.normal(size=(8, 3))
    K_B = np.zeros((16, 16))
    K_B[:8, :2] = rng.normal(size=(8, 2))
    return xhat, xr, uhat, ur, K_A, K_B


def phase_he(device, card):
    """The reference's he_* call sequence at its exact parameters, and the
    native CRT oracle on the decrypted plaintext."""
    from hectr_tpu_torch import he, native
    from hectr_tpu_torch.ckks.encoding import unembed
    from hectr_tpu_torch.ckks.modmath import from_rns
    from hectr_tpu_torch.ckks.ntt import intt

    xhat, xr, uhat, ur, K_A, K_B = facade_problem()
    launch_counters.reset()
    t0 = time.perf_counter()
    hc = he.hectx_init(12, 109, 16, 50, seed=0, verbose=True, device=device)
    he.he_keypair(hc)
    he.he_genrk(hc)
    ct_xhat, ct_uhat, ct_xr, ct_ur = (he.he_enc_pk(hc, he.he_ecd(hc, v))
                                      for v in (xhat, uhat, xr, ur))
    xdiff = he.he_sub(hc, ct_xhat, ct_xr)
    udiff = he.he_sub(hc, ct_uhat, ct_ur)
    du = he.he_neg(hc, he.he_add(hc, he.he_gemv(hc, K_A, xdiff),
                                 he.he_gemv(hc, K_B, udiff)))
    u = he.he_add(hc, he.he_moddown(hc, he.he_copy_ct(hc, ct_uhat)), du)
    pt = he.he_dec(hc, u)
    got = he.he_dcd(hc, pt).cpu().numpy()
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    launches = launch_counters.by_kernel()
    print_launch_shapes("he", 1, "call sequence")
    want = uhat - (K_A @ (xhat - xr) + K_B @ (uhat - ur))
    err = float(np.max(np.abs(got.real - want.real)))
    canary = float(np.max(np.abs(got.imag)))
    print(f"[he] hectx_init(12, 109, 16, 50): realized logQ "
          f"{hc.realized_logq}, logQP {hc.realized_logqp}, depth {hc.depth}, "
          f"security ~{hc.security_bits:.1f} bits; {len(hc.rot_keys)} rotation "
          f"keys; whole call sequence {t_seq:.3f} s on {card}", flush=True)
    print(f"[he] max |u - (uhat - K_A (xhat - xr) - K_B (uhat - ur))| = "
          f"{err:.3e}, canary {canary:.3e}; launches {launches}", flush=True)
    check(hc.realized_logqp > hc.realized_logq > 0 and hc.security_bits > 0,
          "he: realized modulus not reported")
    check(err <= 1e-8, f"he: control law off by {err}")
    check(canary < 1e-5, f"he canary {canary}")

    # the exact host oracle on the base residues of the decrypted
    # plaintext: its coefficients over the scale decode to the same slots
    ctx = hc.ctx
    kb = len(ctx.base_primes)
    check(pt.limbs == kb, f"he: plaintext at {pt.limbs} limbs, not {kb}")
    t0 = time.perf_counter()
    res = intt(pt.data, ctx.tables(kb, device)).cpu()
    coeffs = native.crt_centered(res, ctx.base_primes)
    t_crt = time.perf_counter() - t0
    check(all(int(a) == int(b) for a, b in
              zip(coeffs, from_rns(res, ctx.base_primes))),
          "he: native CRT differs from the pure-Python CRT")
    stride = ctx.n // (2 * ctx.slots)
    m = torch.tensor([float(c) / float(pt.scale) for c in coeffs[::stride]],
                     dtype=torch.float64)
    re, im = unembed(m, ctx.slots)
    crt_err = float(max(np.abs(re.numpy() - got.real).max(),
                        np.abs(im.numpy() - got.imag).max()))
    print(f"[he] native crt_centered ({native.LIBRARY.name}, g++) on the "
          f"decrypted plaintext's {kb} base limbs x {ctx.n}: {t_crt:.3f} s; "
          f"its slots vs he_dcd max {crt_err:.3e}", flush=True)
    check(crt_err <= 1e-9, f"he: exact CRT decode differs by {crt_err}")
    he.hectx_exit(hc)
    return launches


def phase_medium(device, card):
    """MEDIUM at full width: FFT embedding on the card, encrypt/decrypt,
    rotations, a 5-level ct x ct chain and a dense BSGS gemv over all
    slots."""
    from hectr_tpu_torch.bench.suite import dense_gemv
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.encoding import embed_ri, unembed
    from hectr_tpu_torch.ckks.keyswitch import (gen_relin_key,
                                                gen_rotation_keys, mul_ct,
                                                rotate)
    from hectr_tpu_torch.config import MEDIUM

    ctx = make_context(MEDIUM)
    s, k = ctx.slots, ctx.max_limbs
    rng = np.random.default_rng(0)

    def sync():
        torch.cuda.synchronize()

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def decoded(ct):
        return S.decode(ctx, S.decrypt(ctx, keys, ct)).cpu().numpy()

    # 1. the FFT embedding on the card against the CPU
    vre, vim = rng.uniform(-5, 5, s), rng.uniform(-5, 5, s)
    m_cpu = embed_ri(torch.from_numpy(vre), torch.from_numpy(vim), s)
    m_dev = embed_ri(on(vre), on(vim), s)
    r_cpu, i_cpu = unembed(m_cpu, s)
    r_dev, i_dev = unembed(m_dev, s)
    e_embed = float((m_dev.cpu() - m_cpu).abs().max())
    e_unembed = float(max((r_dev.cpu() - r_cpu).abs().max(),
                          (i_dev.cpu() - i_cpu).abs().max()))
    e_round = float(max(np.abs(r_dev.cpu().numpy() - vre).max(),
                        np.abs(i_dev.cpu().numpy() - vim).max()))
    print(f"[medium] {ctx.preset.name}: logN={ctx.preset.logn}, {s} slots, "
          f"{k} data + {len(ctx.special_primes)} special limbs, "
          f"{ctx.dnum(k)} digits; FFT embedding card vs CPU: embed "
          f"{e_embed:.3e}, unembed {e_unembed:.3e}; unembed(embed(v)) - v "
          f"{e_round:.3e}", flush=True)
    check(max(e_embed, e_unembed, e_round) <= 1e-12,
          "medium: FFT embedding off on the card")

    launch_counters.reset()
    # 2. encrypt / decrypt of s complex slots
    t0 = time.perf_counter()
    keys = S.keygen(ctx, S.TorchSampler(61, device), device)
    enc = S.TorchSampler(62, device)
    v = vre + 1j * vim
    ct = S.encrypt(ctx, keys, S.encode(ctx, on(v), k), enc)
    got = decoded(ct)
    t_rt = time.perf_counter() - t0
    e_rt = float(max(np.abs(got.real - vre).max(), np.abs(got.imag - vim).max()))

    # 3. rotations by 1 and 7
    rk = gen_rotation_keys(ctx, keys, S.TorchSampler(63, device),
                           rotations=[1, 7])
    vr = rng.uniform(-3, 3, s)
    ct = S.encrypt(ctx, keys, S.encode(ctx, on(vr + 0j), k), enc)
    e_rot, c_rot = [], []
    for r in (1, 7):
        got = decoded(rotate(ctx, ct, r, rk))
        e_rot.append(float(np.abs(got.real - np.roll(vr, -r)).max()))
        c_rot.append(float(np.abs(got.imag).max()))
    del rk
    print(f"[medium] encrypt/decrypt of {s} complex slots U(-5,5): max err "
          f"{e_rt:.3e} (keygen + encode + encrypt + decrypt + decode "
          f"{t_rt:.3f} s); rotate by 1, 7: max err {e_rot}, max |imag| "
          f"{c_rot}", flush=True)
    check(e_rt <= 1e-6, f"medium roundtrip {e_rt}")
    check(max(e_rot) <= 1e-6 and max(c_rot) < 1e-4, "medium rotation")

    # 4. ct x ct chain: enc(v) * enc(w)^i, 12 -> 2 limbs
    relin = gen_relin_key(ctx, keys, S.TorchSampler(64, device), compact=True)
    v = rng.uniform(-0.7, 0.7, s) + 1j * rng.uniform(-0.7, 0.7, s)
    w = rng.uniform(-0.7, 0.7, s) + 1j * rng.uniform(-0.7, 0.7, s)
    a = S.encrypt(ctx, keys, S.encode(ctx, on(v), k), enc)
    b = S.encrypt(ctx, keys, S.encode(ctx, on(w), k), enc)
    step_ms = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        S.rescale_pair(ctx, mul_ct(ctx, a, b, relin))
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    want, chain_err, levels = v, [], []
    while a.limbs > 2:
        a = S.rescale_pair(ctx, mul_ct(ctx, a, S.mod_down_to(ctx, b, a.limbs),
                                       relin))
        want = want * w
        chain_err.append(float(np.abs(decoded(a) - want).max()))
        levels.append(a.limbs)
    del relin
    print(f"[medium] ct x ct chain (compact relin key): limbs {levels}, max "
          f"|dec - v w^i| per level {chain_err}; mul_ct + rescale at k={k}: "
          f"median {np.median(step_ms):.3f} ms over 5 calls on {card}",
          flush=True)
    check(len(chain_err) == (k - 2) // 2 and max(chain_err) <= 1e-6,
          f"medium ct x ct chain {chain_err}")

    # 5. dense BSGS gemv over every slot, the peak of each phase
    M = np.random.default_rng(9).normal(size=(s, s)) / np.sqrt(s)
    vg = rng.uniform(-2, 2, s)
    g = dense_gemv(ctx, keys, M, vg, device, True, 3,
                   S.TorchSampler(65, device), enc)
    launches = launch_counters.by_kernel()
    print_launch_shapes("medium", 1, "phase (keygen, chain, 3 gemvs)")
    print(f"[medium] dense {s} x {s} BSGS gemv at k={k}: {g['n_keys']} "
          f"compact keys ({g['key_bytes']} B on the card) in "
          f"{g['keys_s']:.2f} s; materials ({g['grid_plaintexts'][0]} x {g['grid_plaintexts'][1]} "
          f"diagonal plaintexts, {g['grid_bytes']} B) in {g['grid_s']:.2f} s; "
          f"median gemv {g['median_gemv_ms']:.1f} ms over 3 calls "
          f"({[round(x, 1) for x in g['gemv_ms']]}); max |dec - M v| "
          f"{g['max_err']:.3e}, max |imag| {g['max_imag']:.3e}; launches "
          f"{launches}", flush=True)
    print(f"[medium] device memory held before / peak in each phase: keys "
          f"{g['keys_held_bytes']} / {g['keys_peak_bytes']} B, grid "
          f"{g['grid_held_bytes']} / {g['grid_peak_bytes']} B, gemv "
          f"{g['gemv_held_bytes']} / {g['gemv_peak_bytes']} B on {card}",
          flush=True)
    check(g["max_err"] <= 1e-4 and g["max_imag"] < 1e-3,
          f"medium gemv {g['max_err']}, {g['max_imag']}")
    del keys
    torch.cuda.empty_cache()
    return launches


def phase_suite(device, card):
    """Three sections of the bench entry point through its main(): the
    JSON line it ends with names them, each with its value, unit, gate
    and result."""
    import contextlib
    import io

    from hectr_tpu_torch.bench import suite

    names = ("ntt_logn15", "kernel_parity", "compact_key_tradeoff")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rec = suite.main(["--sections", ",".join(names)])
    finally:
        *lines, last = buf.getvalue().splitlines() or [""]
        for line in lines:
            print(line, flush=True)
        print(f"[suite] JSON line: {last}", flush=True)
    got = json.loads(last)
    check(got == json.loads(json.dumps(rec)), "suite: JSON line != main()")
    check(got["card"] == card and list(got["sections"]) == list(names),
          f"suite: sections {list(got['sections'])} on {got['card']}")
    for name, r in got["sections"].items():
        check(r["ok"] is True and all(key in r for key in
                                      ("value", "unit", "gate", "seconds")),
              f"suite: section {name}: {r}")
        check(np.isfinite(r["value"]) and r["value"] > 0,
              f"suite: section {name} value {r['value']}")
    check(got["sections"]["compact_key_tradeoff"]["products_bit_equal"],
          "suite: stored and compact products differ")


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(2)
    device = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {name} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from hectr_tpu_torch.config import FLAGSHIP, REFERENCE_HEMPC
    from hectr_tpu_torch.ckks.gemv import bsgs_rotations
    from hectr_tpu_torch.ops import (build, codec_cuda, encrypt_cuda,
                                     keyswitch_cuda, mulmod_cuda, ntt_cuda,
                                     ntt_exchange_cuda, rns_cuda, stages_cuda)
    from hectr_tpu_torch.utils import read_traj_bin

    from hectr_tpu_torch.utils.pmu import Timer

    timer = Timer()          # each phase's wall time, device synchronized
    with timer.section("build"):
        sources = ("ntt.cu", "mulmod_chain.cu", "ntt_exchange.cu",
                   "keyswitch.cu", "rns_ops.cu", "codec.cu", "loop_stages.cu",
                   "encrypt.cu")
        libs = build.build(*sources)
        ntt_cuda.library()
        mulmod_cuda.library()
        ntt_exchange_cuda.library()
        keyswitch_cuda.library()
        rns_cuda.library()
        codec_cuda.library()
        stages_cuda.library()
        encrypt_cuda.library()
    print(f"[build] nvcc sm_90a hectr_tpu_torch/csrc/{{{','.join(sources)}}} "
          f"(in parallel) -> {[lib.name for lib in libs]} "
          f"{timer.sections['build']:.2f} s", flush=True)

    kernel_rows = {
        "ntt": {"name": "ntt_fwd", "route": "cuda",
                "source": "hectr_tpu_torch/csrc/ntt.cu",
                "replaces": "hectr_tpu/ops/ntt_pallas.py:272"},
        "intt": {"name": "ntt_inv", "route": "cuda",
                 "source": "hectr_tpu_torch/csrc/ntt.cu",
                 "replaces": "hectr_tpu/ops/ntt_pallas.py:315"},
        "mulmod_chain": {"name": "mulmod_chain", "route": "cuda",
                         "source": "hectr_tpu_torch/csrc/mulmod_chain.cu",
                         "replaces": "scripts/bench_vpu_ceiling.py:61"},
        # no Pallas kernel: the JAX package's cross-shard stages are XLA
        # code inside shard_map
        "exchange_fwd": {"name": "ntt_exchange_fwd", "route": "cuda",
                         "source": "hectr_tpu_torch/csrc/ntt_exchange.cu",
                         "replaces": "hectr_tpu/parallel/ntt_shard.py:117"},
        "exchange_inv": {"name": "ntt_exchange_inv", "route": "cuda",
                         "source": "hectr_tpu_torch/csrc/ntt_exchange.cu",
                         "replaces": "hectr_tpu/parallel/ntt_shard.py:137"},
        # no Pallas kernel either: XLA fuses the JAX package's key switch
        "base_convert": {"name": "base_convert", "route": "cuda",
                         "source": "hectr_tpu_torch/csrc/keyswitch.cu",
                         "replaces": "hectr_tpu/ckks/basecvt.py:134"},
        "key_inner_product": {"name": "key_inner_product", "route": "cuda",
                              "source": "hectr_tpu_torch/csrc/keyswitch.cu",
                              "replaces": "hectr_tpu/ckks/keyswitch.py:281"},
        "mod_down_tail": {"name": "mod_down_tail", "route": "cuda",
                          "source": "hectr_tpu_torch/csrc/keyswitch.cu",
                          "replaces": "hectr_tpu/ckks/keyswitch.py:302"},
        # nor here: XLA fuses the scheme ops' modular arithmetic
        "rns_map": {"name": "rns_map", "route": "cuda",
                    "source": "hectr_tpu_torch/csrc/rns_ops.cu",
                    "replaces": "hectr_tpu/ckks/modmath.py:85"},
        "mod_product_sum": {"name": "mod_product_sum", "route": "cuda",
                            "source": "hectr_tpu_torch/csrc/rns_ops.cu",
                            "replaces": "hectr_tpu/ckks/gemv.py:430"},
        # nor here: XLA fuses encode's and decode's float64 chains
        "encode_residues": {"name": "encode_residues", "route": "cuda",
                            "source": "hectr_tpu_torch/csrc/codec.cu",
                            "replaces": "hectr_tpu/ckks/scheme.py:162"},
        "crt_decode": {"name": "crt_decode", "route": "cuda",
                       "source": "hectr_tpu_torch/csrc/codec.cu",
                       "replaces": "hectr_tpu/ckks/scheme.py:187"},
        # nor here: XLA fuses the closed loop's plant and estimator
        "loop_stages": {"name": "loop_stages", "route": "cuda",
                        "source": "hectr_tpu_torch/csrc/loop_stages.cu",
                        "replaces": "hectr_tpu/control/simulate.py:171"},
        # nor here: XLA fuses encryption's residues, NTTs and combination
        "encrypt": {"name": "encrypt", "route": "cuda",
                    "source": "hectr_tpu_torch/csrc/encrypt.cu",
                    "replaces": "hectr_tpu/ckks/scheme.py:131"},
    }
    with timer.section("kernels"):
        phase_kernels(device, kernel_rows)

    with timer.section("reference-hempc"):
        x, u, dev, canary, launches_ref, _ = run_loop(
            "reference-hempc", REFERENCE_HEMPC, None, device, card)
    check(bool((dev <= 5e-10).all()), f"reference deviation {dev}")
    check(canary < 1e-5, f"reference canary {canary}")
    golden_x, golden_u = read_traj_bin(ROOT / "tests/golden/cstr-hempc.bin")
    golden = np.hstack([golden_x, golden_u])
    ours = np.hstack([x, np.vstack([u, u[-1:]])])
    rel = np.max(np.abs(ours - golden), axis=0) / np.max(np.abs(golden), axis=0)
    print(f"[reference-hempc] golden cstr-hempc.bin max relative error per "
          f"channel {rel.tolist()}", flush=True)
    check(bool((rel < 1e-6).all()), f"golden mismatch {rel}")

    with timer.section("flagship"):
        x, u, dev, canary, launches_flag, flagship = run_loop(
            "flagship", FLAGSHIP, bsgs_rotations(FLAGSHIP.slots), device, card)
    check(bool((dev <= 2e-9).all()), f"flagship deviation {dev}")
    check(canary < 1e-5, f"flagship canary {canary}")
    check(bool(np.allclose(x[-1], FLAGSHIP_FINAL_STATE, rtol=1e-4, atol=0)),
          f"flagship final state {x[-1]}")

    with timer.section("ceiling"):
        phase_ceiling(device, kernel_rows, card)
    with timer.section("fused"):
        launches_fused = phase_fused(device, flagship, card)
    with timer.section("parallel"):
        launches_par = phase_parallel(device, flagship, card, kernel_rows)
    with timer.section("batch"):
        launches_batch = phase_batch(device, flagship, card)
    with timer.section("limb"):
        launches_limb = phase_limb(device, flagship, card)
    del flagship
    with timer.section("flagship-qp"):
        launches_qp = phase_qp(device, card)
    with timer.section("he"):
        launches_he = phase_he(device, card)
    with timer.section("medium"):
        launches_medium = phase_medium(device, card)
    with timer.section("suite"):
        phase_suite(device, card)

    loops = (("reference-hempc", launches_ref), ("flagship", launches_flag),
             ("fused", launches_fused), ("parallel", launches_par),
             ("batch", launches_batch), ("limb", launches_limb),
             ("flagship-qp", launches_qp),
             ("he", launches_he), ("medium", launches_medium))
    for label, launches in loops:
        print(f"[launches] {label} phase: "
              f"{json.dumps({k: launches[k] for k in LOOP_KERNELS})}",
              flush=True)
        for kname in LOOP_KERNELS:
            check(launches[kname] > 0,
                  f"{kname} kernel never launched in the {label} phase")
    for kname in LOOP_KERNELS:
        kernel_rows[kname]["launches"] = sum(l[kname] for _, l in loops)
    for kname in (*ntt_exchange_cuda.LAUNCHES, *stages_cuda.LAUNCHES,
                  *encrypt_cuda.LAUNCHES):
        kernel_rows[kname]["launches"] = sum(l.get(kname, 0)
                                             for _, l in loops)
        check(kernel_rows[kname]["launches"] > 0,
              f"{kname} kernel never launched")
    print(f"[phases] wall time per phase (s) on {card}: "
          f"{json.dumps({k: round(v, 2) for k, v in timer.report().items()})}",
          flush=True)
    print(json.dumps({"kernels": list(kernel_rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
