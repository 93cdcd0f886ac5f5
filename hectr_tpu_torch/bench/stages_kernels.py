"""K13 on the card at the CSTR loops' shapes: one plant and 1,024.

    python -m hectr_tpu_torch.bench.stages_kernels

K13 (``ops.stages_cuda``: the closed loop's own stages for the CSTR plant)
on the benchmark's model (``cli.cstr_setup``, dt = 1), at one plant (rows
[]) and 1,024 ([1024]), on states around the steady state with the
disturbance row a strided view, as the loop passes it:

  * held to its plain version first, in each of its modes (an episode
    launches OBSERVE once, STEP_OBSERVE at 39 of its 40 steps and STEP at
    the last): every output within CHECK_GAP of its unit (xs, or us for
    ur) of ``Stages.step`` or ``.observe`` run uncaptured on the card;
  * timed in STEP_OBSERVE, the mode of nearly every step:
    its device time by CUDA-graph replay (``bench.cuda_graph_time_ms``)
    and its launches (torch.profiler);
  * the bound: its bytes in and out (``stages_bytes``) at the data sheet's
    3.35 TB/s, beside which one launch's latency is what bounds it;
  * the plain version: ``Stages.step`` uncaptured (CUDA events around
    back-to-back calls; its kernels wait on the host's launches), and the
    same captured as one CUDA graph of PyTorch's kernels, by CUDA-graph
    replay, with its launches;
  * the host's us a step through the loop's holder, ``StageKernel`` (one
    K13 launch), back to back on the host clock, ending in a
    synchronize.

One JSON line per case, the card's name and power limit last.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from hectr_tpu_torch import cli
from hectr_tpu_torch.bench import (HBM_BYTES_PER_S, cuda_graph_time_ms,
                                   cuda_time_ms)
from hectr_tpu_torch.bench.batch import profile_kernels
from hectr_tpu_torch.control import simulate as sim
from hectr_tpu_torch.control.plants import cstr
from hectr_tpu_torch.ops import stages_cuda as K

CASES = {"one plant": (), "1024 plants": (1024,)}
MODES = {"step": K.STEP, "step_observe": K.STEP_OBSERVE,
         "observe": K.OBSERVE}
CHECK_GAP = 1e-13
HOST_CALLS = 400


def stages_bytes(rows: int, nd: int) -> int:
    """What K13 reads and writes: each row's inputs (x 3, u 2, p 1, xhat 3,
    dhat nd, rsp 2 words) and its output (11 + nd words), and the
    constants once."""
    return 8 * (rows * 2 * (11 + nd) + K.WORDS)


def inputs(rows: tuple, device, seed: int = 0) -> dict:
    """x within 5% of xs, u of us, the disturbance within 20% of ps (a
    strided row of a [*rows, 40, 1] sequence), xhat near x, dhat and rsp
    small, in deviation units."""
    rng = np.random.default_rng(seed)
    _, plant = cli.cstr_setup()

    def dev(scale, n):
        return torch.from_numpy(rng.uniform(-0.05, 0.05, (*rows, n))
                                * np.abs(scale)).to(device)

    x = dev(plant.xs, 3)
    p_seq = torch.from_numpy(rng.uniform(-0.02, 0.02, (*rows, 40, 1))
                             ).to(device)
    return dict(x=x, u=dev(plant.us, 2), p=p_seq[..., 11, :],
                xhat=x + dev(plant.xs, 3) * 0.01,
                dhat=dev(plant.xs[[0, 2]], 2) * 0.1,
                rsp=dev(plant.us, 2) * 0.1)


def gap(got, want, plant, model) -> float:
    """The largest output gap, each part over its unit."""
    xs, us = np.abs(plant.xs), np.abs(plant.us)
    units = (xs, xs, np.abs(model.Cd).T @ xs, xs, us)
    worst = 0.0
    for g, w, unit in zip(got, want, units):
        if g.numel():
            unit = torch.as_tensor(unit, device=g.device)
            worst = max(worst, float(((g - w).abs() / unit).max()))
    return worst


def against_plain(consts, stages, ops: dict, mode: int) -> tuple:
    """K13 in `mode` on `ops` (``inputs``) and what ``Stages`` computes
    there uncaptured, as (got, want): (x,) in STEP; (x, xhat, dhat, xr,
    ur) in STEP_OBSERVE and in OBSERVE, where x is the input."""
    if mode == K.OBSERVE:
        got = K.loop_stages(consts, ops["x"], None, None, ops["xhat"],
                            ops["dhat"], ops["rsp"], K.OBSERVE)
        return got, (ops["x"], *stages.observe(ops["x"], ops["xhat"],
                                               ops["dhat"], ops["rsp"], 0))
    observe = mode == K.STEP_OBSERVE
    got = K.loop_stages(consts, **ops, mode=mode)
    want = stages.step(**ops, k=0, then_observe=observe)
    return (got, want) if observe else (got[:1], want[:1])


def host_us(step, ops, calls: int = HOST_CALLS) -> float:
    """Host us a step through a holder's ``step`` (after warm calls)."""
    for _ in range(3):
        step(**ops, k=0, then_observe=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        step(**ops, k=0, then_observe=True)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def measure(device) -> list[dict]:
    """Each case checked, then timed (module docstring)."""
    model, plant = cli.cstr_setup()
    stages = sim.Stages(model, plant, 1.0, device)
    consts = K.pack(stages, cstr.cstr_scalars())
    out = []
    for label, rows in CASES.items():
        ops = inputs(rows, device)
        gaps = {name: gap(*against_plain(consts, stages, ops, mode), plant,
                          model) for name, mode in MODES.items()}
        worst = max(gaps.values())
        if not worst <= CHECK_GAP:
            raise AssertionError(f"K13 at {label}: {gaps} of a unit from "
                                 f"the plain stages (limit {CHECK_GAP})")

        def kernel():
            return K.loop_stages(consts, **ops, mode=K.STEP_OBSERVE)

        def plain():
            return stages.step(**ops, k=0, then_observe=True)

        holder = sim.StageKernel()
        holder.stages(model, plant, 1.0, device)
        n = int(np.prod(rows))
        ms = cuda_graph_time_ms(kernel)
        bound_ms = stages_bytes(n, consts.nd) / HBM_BYTES_PER_S * 1e3
        out.append({
            "kernel": "loop_stages", "case": label, "rows": list(rows),
            "max_gap": worst, "gaps": gaps, "ms": ms,
            "launches": profile_kernels(kernel)["kernel_launches"],
            "bound_ms": bound_ms, "bound_by": "bytes",
            "share_of_bound": bound_ms / ms,
            "plain_ms": cuda_time_ms(plain),
            "plain_graph_ms": cuda_graph_time_ms(plain),
            "plain_launches": profile_kernels(plain)["kernel_launches"],
            "host_us": host_us(holder.step, ops)})
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    device = torch.device("cuda", torch.cuda.current_device())
    for rec in measure(device):
        print(json.dumps(rec), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())


if __name__ == "__main__":
    main()
