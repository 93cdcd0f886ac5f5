"""Where a step's device time goes, on the card, kernel by kernel: the
FLAGSHIP reference-shaped regulator, the fused one, and the constrained
FLAGSHIP_QP regulator.

    python -m hectr_tpu_torch.bench.profile_step

Builds the FLAGSHIP keys (BSGS rotations) and both FLAGSHIP regulators,
times the reference-shaped and the fused loops over STEPS steps each
(warm: each loop has run once before; host clock around work that ends in
a synchronize), then builds the FLAGSHIP_QP regulator as
``bench.batch.qp_regulator`` does and times its 10-step loop (median
regulator step).  Each regulator is then profiled with torch.profiler over
a short warm window: device kernel time per step by kernel, kernel
launches per step, the NTT kernels' (K1/K2) and the key-switch kernels'
(K6-K8) share of the device time, and the device's busy share of the
profiled wall time.  Prints one JSON line.
"""

from __future__ import annotations

import collections
import json
import sys
import time

import numpy as np
import torch

NTT_KERNELS = ("ntt_fwd_kernel", "ntt_inv_kernel")
KEYSWITCH_KERNELS = ("base_convert_kernel", "key_inner_product_kernel",
                     "mod_down_tail_kernel")
STEPS = 40     # the smoke's loops
WINDOW = 8     # profiled FLAGSHIP steps: a few full steps, a short trace
QP_WINDOW = 2  # profiled FLAGSHIP_QP steps (each some 9,000 launches)


def _device_us(evt) -> float:
    """An event's own device time in us, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def breakdown(run, steps: int) -> dict:
    """Profile run() (`steps` regulator steps ending in a synchronize):
    device ms and launches per step, in all and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    by_kernel = collections.Counter()
    launches = collections.Counter()
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            by_kernel[evt.key] += _device_us(evt)
            launches[evt.key] += evt.count
    device_us = sum(by_kernel.values())
    if device_us == 0:
        sys.exit("the profiler recorded no device time")

    def share(names):
        keys = [k for k in by_kernel if any(n in k for n in names)]
        us = sum(by_kernel[k] for k in keys)
        return us, {k: {"ms_per_step": by_kernel[k] / 1e3 / steps,
                        "launches_per_step": launches[k] / steps}
                    for k in keys}

    ntt_us, ntt = share(NTT_KERNELS)
    ks_us, ks = share(KEYSWITCH_KERNELS)
    return {
        "window_steps": steps,
        "device_ms_per_step": device_us / 1e3 / steps,
        "kernel_launches_per_step": sum(launches.values()) / steps,
        "ntt_ms_per_step": ntt_us / 1e3 / steps,
        "ntt_share": ntt_us / device_us,
        "ntt_by_kernel": ntt,
        "keyswitch_ms_per_step": ks_us / 1e3 / steps,
        "keyswitch_share": ks_us / device_us,
        "keyswitch_by_kernel": ks,
        "busy_share": device_us / 1e6 / wall,
        "top_ms_per_step": [[k, v / 1e3 / steps,
                             launches[k] / steps]
                            for k, v in by_kernel.most_common(10)],
    }


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: the profile is of the device")

    from hectr_tpu_torch import cli
    from hectr_tpu_torch.bench import batch as BB
    from hectr_tpu_torch.bench.ntt_kernels import card_line
    from hectr_tpu_torch.ckks.gemv import bsgs_rotations
    from hectr_tpu_torch.ckks.scheme import TorchSampler
    from hectr_tpu_torch.config import FLAGSHIP
    from hectr_tpu_torch.control.simulate import simulate
    from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
    from hectr_tpu_torch.hempc.fused import (make_fused_materials,
                                             make_fused_regulator)

    device = torch.device("cuda", torch.cuda.current_device())
    horizon = 4
    ctx, keys, rot_keys = cli.hempc_keys(FLAGSHIP, 0, device,
                                         bsgs_rotations(FLAGSHIP.slots))
    model, plant = cli.cstr_setup()
    regs = {
        "flagship": make_hempc_regulator(ctx, keys, rot_keys, model, plant,
                                         horizon),
        "fused": make_fused_regulator(
            ctx, keys, model, plant, horizon,
            make_fused_materials(ctx, rot_keys, model, plant, horizon,
                                 device)),
    }

    def loop(reg, steps):
        simulate(model, plant, cli.disturbance(steps), 1.0, steps, device,
                 regulator=reg, horizon=horizon, return_state=True,
                 regulator_state=hempc_init_state(TorchSampler(2, device),
                                                  device))
        torch.cuda.synchronize()

    out = {}
    for name, reg in regs.items():
        loop(reg, STEPS)
        t0 = time.perf_counter()
        loop(reg, STEPS)
        rate = STEPS / (time.perf_counter() - t0)
        loop(reg, WINDOW)
        out[name] = {"steps_per_s": rate,
                     **breakdown(lambda reg=reg: loop(reg, WINDOW), WINDOW)}
    del regs, keys, rot_keys

    p_seq = BB.qp_disturbance(plant)
    B0 = BB.qp_envelope(model, plant, p_seq)[0]
    reg = BB.qp_regulator(device, model, plant, B0)
    BB.qp_closed_loop(reg, model, plant, p_seq[:QP_WINDOW], device)
    step_s = BB.qp_closed_loop(reg, model, plant, p_seq, device)[3]
    out["flagship-qp"] = {
        "steps_per_s": 1 / float(np.median(step_s)),
        **breakdown(lambda: BB.qp_closed_loop(reg, model, plant,
                                              p_seq[:QP_WINDOW], device),
                    QP_WINDOW)}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card": card_line(),
        "torch": torch.__version__, "steps": STEPS, "regulators": out}))


if __name__ == "__main__":
    main()
