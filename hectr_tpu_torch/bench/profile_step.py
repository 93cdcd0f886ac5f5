"""Where a step's device time goes, on the card, kernel by kernel and op by
op: the FLAGSHIP reference-shaped regulator, the fused one, and the
constrained FLAGSHIP_QP regulator.

    python -m hectr_tpu_torch.bench.profile_step

Builds the FLAGSHIP keys (BSGS rotations) and both FLAGSHIP regulators,
times the reference-shaped and the fused loops over STEPS steps each
(warm: each loop has run once before; host clock around work that ends in
a synchronize), then builds the FLAGSHIP_QP regulator as
``bench.batch.qp_regulator`` does and times its 10-step loop (median
regulator step).  Each regulator is then profiled with torch.profiler over
a short warm window: device kernel time per step by kernel, kernel
launches per step, the NTT kernels' (K1/K2), the key-switch kernels'
(K6-K8), the scheme ops' kernels' (K9/K10) and the encode and decode
kernels' (K11/K12) share of the device time, the device's busy share of
the profiled wall time, and device ms and launches per step by scheme op.

The ops are named by ``torch.profiler.record_function`` ranges that this
script opens around the op-set functions (``OPS``: encode, encrypt,
add/sub, gemv, rescale, decrypt, decode, mul_ct, the QP clip), by
replacing those functions, in every module of the package that holds
them, with wrappers that open their range during the profiled window
only.  A kernel belongs to the innermost range open when its launch was
made (the CUDA runtime's launch event, matched to the kernel by its
correlation id); launches outside every range count as "other".  The
library has no hook for this; the same script profiles a parent checkout
when copied into it.  Prints one JSON line.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import json
import sys
import time

import numpy as np
import torch

NTT_KERNELS = ("ntt_fwd_kernel", "ntt_inv_kernel")
KEYSWITCH_KERNELS = ("base_convert_kernel", "key_inner_product_kernel",
                     "mod_down_tail_kernel")
RNS_KERNELS = ("rns_map_kernel", "mod_product_sum_kernel")
CODEC_KERNELS = ("encode_residues_kernel", "crt_decode_kernel",
                 "crt_unembed_kernel")
# the op ranges: name -> the functions (module, attribute) it covers
OPS = {
    "encode": [("hectr_tpu_torch.ckks.scheme", "encode")],
    "encrypt": [("hectr_tpu_torch.ckks.scheme", "encrypt")],
    "add/sub": [("hectr_tpu_torch.ckks.scheme", f)
                for f in ("add", "sub", "neg", "add_pt")],
    "gemv": [("hectr_tpu_torch.ckks.gemv", "gemv_apply")],
    "rescale": [("hectr_tpu_torch.ckks.scheme", "rescale_pair")],
    "decrypt": [("hectr_tpu_torch.ckks.scheme", "decrypt")],
    "decode": [("hectr_tpu_torch.ckks.scheme", "decode_ri")],
    "mul_ct": [("hectr_tpu_torch.ckks.keyswitch", "mul_ct")],
    "QP clip": [("hectr_tpu_torch.hempc.qp_enc", "_clip_build")],
}
RANGE = "op:"
STEPS = 40     # the smoke's loops
WINDOW = 8     # profiled FLAGSHIP steps: a few full steps, a short trace
QP_WINDOW = 2  # profiled FLAGSHIP_QP steps (each some 9,000 launches)

_ranges_on = False


def _device_us(evt) -> float:
    """An event's own device time in us, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _is_kernel(evt) -> bool:
    """A device event that is no op range: the profiler also records each
    range open on the host as a span on the device's timeline."""
    return (str(getattr(evt, "device_type", "")).endswith("CUDA")
            and not evt.name.startswith(RANGE))


def _ranged(name: str, fn):
    """fn inside the range `name` while the profiled window is open."""
    from torch.profiler import record_function

    @functools.wraps(fn)
    def op(*args, **kwargs):
        if not _ranges_on:
            return fn(*args, **kwargs)
        with record_function(RANGE + name):
            return fn(*args, **kwargs)
    return op


def _clip_ranged(build):
    """``qp_enc._clip_build``, its `apply` closure ranged as "QP clip"."""
    @functools.wraps(build)
    def wrapped(*args, **kwargs):
        pts, apply = build(*args, **kwargs)
        return pts, _ranged("QP clip", apply)
    return wrapped


def install_ranges() -> None:
    """Replace every function of OPS, in each loaded module of the package
    that holds it, by its ranged wrapper (before the regulators are
    built, so that the closures they keep are the wrappers)."""
    for name, targets in OPS.items():
        for module, attr in targets:
            fn = getattr(importlib.import_module(module), attr)
            new = (_clip_ranged(fn) if name == "QP clip"
                   else _ranged(name, fn))
            for mod in list(sys.modules.values()):
                if getattr(mod, "__name__", "").startswith("hectr_tpu_torch"):
                    for key, val in list(vars(mod).items()):
                        if val is fn:
                            setattr(mod, key, new)


@contextlib.contextmanager
def ranges_on():
    global _ranges_on
    _ranges_on = True
    try:
        yield
    finally:
        _ranges_on = False


def by_op(events, steps: int) -> dict:
    """Device ms and launches per step by op range: each kernel to the
    innermost range open when its launch (the CUDA runtime event with the
    kernel's correlation id) was made."""
    kernels = collections.defaultdict(list)
    for evt in events:
        if _is_kernel(evt):
            kernels[evt.id].append(evt.time_range.end - evt.time_range.start)
    ranges = sorted((evt.time_range.start, evt.time_range.end,
                     evt.name[len(RANGE):]) for evt in events
                    if evt.name.startswith(RANGE)
                    and str(getattr(evt, "device_type", "")).endswith("CPU"))
    out = collections.defaultdict(lambda: [0.0, 0])
    for evt in events:
        if (str(getattr(evt, "device_type", "")).endswith("CPU")
                and "LaunchKernel" in evt.name and evt.id in kernels):
            t = evt.time_range.start
            name = "other"
            for start, end, rname in ranges:    # by start: the last is innermost
                if start > t:
                    break
                if t <= end:
                    name = rname
            for us in kernels.pop(evt.id):
                out[name][0] += us
                out[name][1] += 1
    unmatched = sum(sum(v) for v in kernels.values())
    return {
        "by_op": {name: {"device_ms_per_step": us / 1e3 / steps,
                         "launches_per_step": n / steps}
                  for name, (us, n) in sorted(out.items())},
        "unmatched_kernel_ms_per_step": unmatched / 1e3 / steps}


def breakdown(run, steps: int) -> dict:
    """Profile run() (`steps` regulator steps ending in a synchronize):
    device ms and launches per step, in all, by kernel and by op."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof, ranges_on():
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    by_kernel = collections.Counter()
    launches = collections.Counter()
    for evt in prof.key_averages():
        if (str(getattr(evt, "device_type", "")).endswith("CUDA")
                and not evt.key.startswith(RANGE)):
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
    rns_us, rns = share(RNS_KERNELS)
    codec_us, codec = share(CODEC_KERNELS)
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
        "rns_ms_per_step": rns_us / 1e3 / steps,
        "rns_share": rns_us / device_us,
        "rns_by_kernel": rns,
        "codec_ms_per_step": codec_us / 1e3 / steps,
        "codec_share": codec_us / device_us,
        "codec_by_kernel": codec,
        "busy_share": device_us / 1e6 / wall,
        "top_ms_per_step": [[k, v / 1e3 / steps,
                             launches[k] / steps]
                            for k, v in by_kernel.most_common(10)],
        **by_op(prof.events(), steps),
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

    install_ranges()
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
