"""Where a FLAGSHIP step's device time goes, on the card.

    python -m hectr_tpu_torch.bench.profile_step

Builds the FLAGSHIP keys (BSGS rotations) and both regulators, then
times the reference-shaped and the fused loops over STEPS steps each
(warm: each loop has run once before; host clock around work that ends
in a synchronize), and profiles WINDOW steps of the reference-shaped
loop with torch.profiler: device kernel time per step, the NTT kernels'
share of it, kernel launches per step, the device's busy share of the
profiled wall time and the kernels that take the most device time.
Prints one JSON line.
"""

from __future__ import annotations

import collections
import json
import sys
import time

import torch

NTT_KERNELS = ("ntt_fwd_kernel", "ntt_inv_kernel")
STEPS = 40     # the smoke's loops
WINDOW = 8     # profiled steps: a few full steps, a short trace


def _device_us(evt) -> float:
    """An event's own device time in us, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: the profile is of the device")
    from torch.profiler import ProfilerActivity, profile

    from hectr_tpu_torch import cli
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

    rates = {}
    for name, reg in regs.items():
        loop(reg, STEPS)
        t0 = time.perf_counter()
        loop(reg, STEPS)
        rates[name] = STEPS / (time.perf_counter() - t0)

    loop(regs["flagship"], WINDOW)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loop(regs["flagship"], WINDOW)
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
    ntt_us = sum(v for k, v in by_kernel.items()
                 if any(n in k for n in NTT_KERNELS))
    w = WINDOW
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card": card_line(),
        "torch": torch.__version__, "steps": STEPS,
        "steps_per_s": rates, "window_steps": w,
        "device_ms_per_step": device_us / 1e3 / w,
        "ntt_ms_per_step": ntt_us / 1e3 / w,
        "ntt_share": ntt_us / device_us,
        "kernel_launches_per_step": sum(launches.values()) / w,
        "ntt_launches_per_step": {
            k: launches[k] / w for k in launches
            if any(n in k for n in NTT_KERNELS)},
        "busy_share": device_us / 1e6 / wall,
        "top_ms_per_step": [[k, v / 1e3 / w]
                            for k, v in by_kernel.most_common(8)],
    }))


if __name__ == "__main__":
    main()
