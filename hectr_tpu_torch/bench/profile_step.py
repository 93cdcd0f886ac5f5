"""Where a step's time goes, on the card, by the port's own spans: the
benchmark's configuration first (preset ``reference-hempc-secure``, the
CSTR closed loop, one plant and 1,024 plants in one regulator), then the
FLAGSHIP reference-shaped and fused loops and the constrained
FLAGSHIP_QP loop.

    python -m hectr_tpu_torch.bench.profile_step

Each loop runs once warm, then STEPS steps on the host clock (ending in
the trajectories' copy to the host) and STEPS steps inside a
``pmu.recording()`` (the host's calls, total and self ms a step by span,
without the profiler), TURNS times in turns, then a short window under
torch.profiler TURNS times with the port's ranges and TURNS times
without them (``pmu.muted``), in turns: the ranges' and the recording's
cost.  The last recording and the first profiled window are reduced:

  * device ms and launches a step by kernel, and the NTT (K1/K2),
    key-switch (K6-K8), scheme-op (K9/K10) and codec (K11/K12) kernels'
    shares of the device time;
  * device ms and launches a step by innermost ``hectr.`` span, the
    launches whose host call the trace lacks counted apart, and the
    device's idle time a step by the innermost span open on the host at
    each gap's middle (``pmu.by_span``);
  * the K6-K8 roofline: the least time of the launches counted in
    ``ops.keyswitch_cuda.LAUNCH_SHAPES`` (each launch's bytes,
    ``bench.keyswitch_launch_work``, at the data sheet's bandwidth) over
    the kernels' device time;
  * the regulator's CUDA-graph captures, replays and uncaptured calls
    over the loop's runs (``pmu.COUNTS``), and the device ms and launches
    a step under ``regulator.replay``.  A replayed step opens no
    ``scheme.*``, ``gemv.*`` or ``keyswitch.*`` span: its kernels all
    fall under ``regulator.replay``;
  * the same for the loop's stages (``control.simulate``): ``loop.*``
    counts, among them ``loop.kernel``, a step's K13 launch for the CSTR
    plant (``StageKernel``), and the device ms and launches a step under
    ``loop.stages.kernel``, K13's launches;
  * encryption over the loop's runs: K14's launches
    (``ops.encrypt_cuda.LAUNCHES``, replays counted) and the card calls
    that took the composition instead (``pmu.COUNTS``
    ``scheme.encrypt.composed``), each also a step.

Each loop keeps one encryption sampler over its runs, so its regulator
captures once (in the first, warm run) and replays after; the CSTR
loops' stages are one K13 launch a step.

The tables go to standard error; the last line of standard output is one
JSON object.  Also printed: what a span costs on this host with nothing
listening (``span_off_us``).
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
import timeit

import numpy as np
import torch

from hectr_tpu_torch import bench
from hectr_tpu_torch.utils import pmu

NTT_KERNELS = ("ntt_fwd_kernel", "ntt_inv_kernel")
KEYSWITCH_KERNELS = ("base_convert_kernel", "key_inner_product_kernel",
                     "mod_down_tail_kernel")
RNS_KERNELS = ("rns_map_kernel", "mod_product_sum_kernel")
CODEC_KERNELS = ("encode_residues_kernel", "crt_decode_kernel",
                 "crt_unembed_kernel")
STEPS = 40         # the loops' episodes
WINDOW = 8         # profiled steps: a few whole steps, a short trace
QP_WINDOW = 2      # profiled FLAGSHIP_QP steps (each some 1,100 launches)
SERVED = 1024      # plants of the benchmark's served cell
TURNS = 3          # readings of each host-clock step time


def by_kernel(averages, steps: int) -> dict:
    """Device ms and launches a step, in all, by kernel and by kernel
    class, from ``prof.key_averages()``."""
    us, launches = pmu.device_ops(averages)
    device_us = sum(us.values())
    if device_us == 0:
        sys.exit("the profiler recorded no device time")

    def share(names):
        keys = [k for k in us if any(n in k for n in names)]
        total = sum(us[k] for k in keys)
        return total, {k: {"ms_per_step": us[k] / 1e3 / steps,
                           "launches_per_step": launches[k] / steps}
                       for k in keys}

    out = {"device_ms_per_step": device_us / 1e3 / steps,
           "kernel_launches_per_step": sum(launches.values()) / steps}
    for name, names in (("ntt", NTT_KERNELS), ("keyswitch", KEYSWITCH_KERNELS),
                        ("rns", RNS_KERNELS), ("codec", CODEC_KERNELS)):
        total, kernels = share(names)
        out[f"{name}_ms_per_step"] = total / 1e3 / steps
        out[f"{name}_share"] = total / device_us
        out[f"{name}_by_kernel"] = kernels
    out["top_ms_per_step"] = [[k, v / 1e3 / steps, launches[k] / steps]
                              for k, v in us.most_common(10)]
    return out


def keyswitch_roofline(shapes, kernel_ms: float) -> dict:
    """The K6-K8 launches counted under `shapes` (keys of
    ``keyswitch_cuda.LAUNCH_SHAPES``): their least time at the data
    sheet's bandwidth over `kernel_ms`, their device time."""
    nbytes = sum(n * bench.keyswitch_launch_work(key)[0]
                 for key, n in shapes.items())
    least_ms = nbytes / bench.HBM_BYTES_PER_S * 1e3
    return {"least_ms": least_ms, "device_ms": kernel_ms,
            "roofline": least_ms / kernel_ms if kernel_ms else None,
            "launches": sum(shapes.values())}


def profiled(run, steps: int, ranges: bool):
    """run() under torch.profiler (CPU and CUDA), the port's ranges open
    or muted: (the profile, host ms a step)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with contextlib.nullcontext() if ranges else pmu.muted():
            t0 = time.perf_counter()
            run()
            ms = (time.perf_counter() - t0) * 1e3 / steps
    return prof, ms


def profile_loop(label: str, run, steps: int, window: int) -> dict:
    """run(n): n closed-loop steps of one loop (or batch of loops), ending
    in a synchronize.  Host clock, recording, profiled windows."""
    from hectr_tpu_torch.ops import encrypt_cuda as EC
    from hectr_tpu_torch.ops import keyswitch_cuda as KC

    pmu.reset_counts()
    EC.reset_launches()
    ran = [0]

    def counted(n: int) -> None:
        run(n)
        ran[0] += n

    def timed(n: int) -> float:
        t0 = time.perf_counter()
        counted(n)
        return (time.perf_counter() - t0) * 1e3 / n

    counted(steps)
    # the host clock swings between turns: each reading several times, in
    # turns (plain, recorded, ...; profiled with ranges, muted, ...)
    clock = {"plain": [], "recorded": []}
    for _ in range(TURNS):
        clock["plain"].append(timed(steps))
        with pmu.recording() as rec:
            clock["recorded"].append(timed(steps))
    counted(window)
    KC.reset_launches()
    prof, first = profiled(lambda: counted(window), window, True)
    shapes = dict(KC.LAUNCH_SHAPES)
    clock.update(ranges=[first], muted=[])
    for turn in range(2 * TURNS - 1):
        ranges = turn % 2 == 1
        clock["ranges" if ranges else "muted"].append(
            profiled(lambda: counted(window), window, ranges)[1])
    kernels = by_kernel(prof.key_averages(), window)
    spans = pmu.by_span(prof.events(), window)
    roof = keyswitch_roofline(shapes, kernels["keyswitch_ms_per_step"]
                              * window)
    out = {"step_ms": {k: [float(np.median(v)), v] for k, v in clock.items()},
           "window_steps": window, **kernels,
           **spans, "keyswitch_roofline": roof,
           "regulator_counts": {k: v for k, v in pmu.COUNTS.items()
                                if k.startswith("regulator.")},
           "regulator_replay": spans["by_span"].get("regulator.replay"),
           "loop_counts": {k: v for k, v in pmu.COUNTS.items()
                           if k.startswith("loop.")},
           "loop_kernel": spans["by_span"].get("loop.stages.kernel"),
           "encrypt_counts": {
               "steps": ran[0], "k14_launches": EC.LAUNCHES["encrypt"],
               "composed": pmu.COUNTS.get("scheme.encrypt.composed", 0)},
           "host_ms_per_step": {name: {k: v / steps for k, v in row.items()}
                                for name, row in rec.table.items()}}
    _print(label, out, rec, steps)
    return out


def _print(label: str, out: dict, rec, steps: int) -> None:
    err = sys.stderr
    print(f"== {label}: device {out['device_ms_per_step']:.4f} ms and "
          f"{out['kernel_launches_per_step']:.2f} launches a step; step ms "
          "(median, each turn):", file=err)
    for k, (median, each) in out["step_ms"].items():
        print(f"{k:10s} {median:9.4f}  " + " ".join(f"{v:.4f}" for v in each),
              file=err)
    print("-- device ms and launches a step by span, its longest operations",
          file=err)
    for name, row in sorted(out["by_span"].items(),
                            key=lambda kv: -kv[1]["device_ms_per_step"]):
        print(f"{name:28s} {row['device_ms_per_step']:9.4f} ms "
              f"{row['launches_per_step']:8.2f} launches  " + "; ".join(
                  f"{op[:48]} {ms:.4f}" for op, ms, _ in row["top"]), file=err)
    print(f"unmatched: {out['unmatched_launches_per_step']:.2f} launches, "
          f"{out['unmatched_device_ms_per_step']:.4f} ms a step", file=err)
    print(f"-- idle ms a step by span (window "
          f"{out['window_ms_per_step']:.4f} ms a step)", file=err)
    for name, ms in out["idle_ms_per_step"].items():
        print(f"{name:28s} {ms:9.4f} ms", file=err)
    print(f"-- regulator: {out['regulator_counts']}; under regulator.replay "
          f"{out['regulator_replay']}", file=err)
    print(f"-- loop stages: {out['loop_counts']} (loop.kernel "
          f"{out['loop_counts'].get('loop.kernel', 0)}); under "
          f"loop.stages.kernel {out['loop_kernel']}", file=err)
    e = out["encrypt_counts"]
    print(f"-- encrypt: {e['k14_launches']} K14 launches "
          f"({e['k14_launches'] / e['steps']:.3f} a step), "
          f"{e['composed']} composed card calls "
          f"({e['composed'] / e['steps']:.3f} a step), over "
          f"{e['steps']} steps", file=err)
    r = out["keyswitch_roofline"]
    print(f"-- K6-K8: {r['launches']} launches, least {r['least_ms']:.4f} ms, "
          f"device {r['device_ms']:.4f} ms, roofline {r['roofline']}",
          file=err)
    print("-- host a step by span (pmu.recording)", file=err)
    for line in rec.lines(steps):
        print(line, file=err)


def span_off_us(n: int = 200_000) -> dict:
    """What a span costs with nothing listening, us a call: a `with`
    block, and a decorated function over the bare one."""
    def body():
        with pmu.span("off"):
            pass

    def bare(a):
        return a
    spanned = pmu.span("off")(bare)
    empty = timeit.timeit(lambda: None, number=n)
    return {"with_us": (timeit.timeit(body, number=n) - empty) / n * 1e6,
            "decorated_us": (timeit.timeit(lambda: spanned(1), number=n)
                             - timeit.timeit(lambda: bare(1), number=n))
            / n * 1e6}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: the profile is of the device")

    from hectr_tpu_torch import cli
    from hectr_tpu_torch.bench import batch as BB
    from hectr_tpu_torch.bench.ntt_kernels import card_line
    from hectr_tpu_torch.ckks.gemv import bsgs_rotations
    from hectr_tpu_torch.ckks.scheme import TorchSampler
    from hectr_tpu_torch.config import FLAGSHIP, REFERENCE_HEMPC_SECURE
    from hectr_tpu_torch.control.simulate import simulate, simulate_batch
    from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
    from hectr_tpu_torch.hempc.fused import (make_fused_materials,
                                             make_fused_regulator)

    device = torch.device("cuda", torch.cuda.current_device())
    horizon = 4
    model, plant = cli.cstr_setup()
    out = {"span_off_us": span_off_us()}
    print(f"span with nothing listening: {out['span_off_us']}",
          file=sys.stderr)

    def loop(reg, plants: int = 0):
        sampler = TorchSampler(2, device)

        def run(steps):
            p = cli.disturbance(steps)
            if plants:
                scale = np.linspace(0.5, 1.5, plants)[:, None, None]
                simulate_batch(model, plant, p[None] * scale, 1.0, steps,
                               device, regulator=reg, horizon=horizon,
                               regulator_state=hempc_init_state(
                                   sampler, device, (plants,)))
            else:
                simulate(model, plant, p, 1.0, steps, device, regulator=reg,
                         horizon=horizon, return_state=True,
                         regulator_state=hempc_init_state(sampler, device))
            torch.cuda.synchronize()
        return run

    ctx, keys, rot_keys = cli.hempc_keys(REFERENCE_HEMPC_SECURE, 0, device,
                                         bsgs_rotations(16))
    reg = make_hempc_regulator(ctx, keys, rot_keys, model, plant, horizon)
    out["reference-hempc-secure"] = profile_loop(
        "reference-hempc-secure, 1 plant", loop(reg), STEPS, WINDOW)
    out[f"reference-hempc-secure x{SERVED}"] = profile_loop(
        f"reference-hempc-secure, {SERVED} plants", loop(reg, SERVED), STEPS,
        WINDOW)
    del reg, keys, rot_keys
    torch.cuda.empty_cache()

    ctx, keys, rot_keys = cli.hempc_keys(FLAGSHIP, 0, device,
                                         bsgs_rotations(FLAGSHIP.slots))
    regs = {
        "flagship": make_hempc_regulator(ctx, keys, rot_keys, model, plant,
                                         horizon),
        "fused": make_fused_regulator(
            ctx, keys, model, plant, horizon,
            make_fused_materials(ctx, rot_keys, model, plant, horizon,
                                 device)),
    }
    for name, reg in regs.items():
        out[name] = profile_loop(name, loop(reg), STEPS, WINDOW)
    del regs, keys, rot_keys
    torch.cuda.empty_cache()

    p_seq = BB.qp_disturbance(plant)
    B0 = BB.qp_envelope(model, plant, p_seq)[0]
    reg = BB.qp_regulator(device, model, plant, B0)
    sampler = TorchSampler(54, device)

    def qp(steps):
        BB.closed_loop(model, plant, p_seq[:steps], device, reg,
                       hempc_init_state(sampler, device))
        torch.cuda.synchronize()
    out["flagship-qp"] = profile_loop("flagship-qp", qp, len(p_seq),
                                      QP_WINDOW)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card": card_line(),
        "torch": torch.__version__, "steps": STEPS, "loops": out}))


if __name__ == "__main__":
    main()
