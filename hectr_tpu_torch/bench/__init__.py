"""Measurements on the card.  Each needs a CUDA device and fails
without one: a time taken on the CPU is not a device time."""

from __future__ import annotations

import subprocess

import torch

# NVIDIA's H100 SXM data sheet: device memory bandwidth
HBM_BYTES_PER_S = 3.35e12
# CUDA Programming Guide, arithmetic instruction throughput, compute
# capability 9.0: 64 32-bit integer multiply(-add)s per clock per SM; a
# lazy Shoup multiply is three of them (IMAD.HI, IMUL, IMAD)
IMAD_PER_CLOCK_PER_SM = 64
IMAD_PER_LAZY_MULT = 3


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps`
    calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_graph_time_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one fn() in ms, without the host's share: `reps`
    calls captured into a CUDA graph (after warm-up calls on a side
    stream), the graph replayed `replays` times between CUDA events.
    fn must launch on the current stream, as the kernels' wrappers do."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0].split()[0]) * 1e6


def lazy_mult_peak_per_s() -> float:
    """Lazy Shoup multiplies per second at the card's integer multiply
    peak: SMs x 64 IMADs per clock x the maximum SM clock / 3."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * IMAD_PER_CLOCK_PER_SM * max_sm_clock_hz() / IMAD_PER_LAZY_MULT


def ntt_bound(rows: int, limbs: int, logn: int, mult_peak: float
              ) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one NTT kernel call over
    `rows` int64 rows of 2^logn on `limbs` primes: each input read once
    (the rows, the limbs' twiddle and companion tables, the primes), each
    output written once, against its N log2 N / 2 lazy Shoup multiplies
    a row at the multiply peak."""
    n = 1 << logn
    nbytes = rows * n * 8 * 2 + limbs * (n * 4 * 2 + 4)
    mults = rows * logn * (n // 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mults / mult_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
