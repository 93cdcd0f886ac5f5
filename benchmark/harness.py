"""One run of one cell: set-up, the measured window, the check, the
result line.

Set-up builds the port's deployment of the cell's configuration from the
seed (``program.Deployment``) and runs one warm episode at the cell's
batch, which builds and loads every kernel and warms every plan the
window uses.  The window then drives back-to-back episodes of the cell's
traffic through the port's closed loop until ``seconds`` have passed
(whole episodes).  The harness hands ``simulate`` a thin regulator that
calls the port's regulator and copies the decoded move to the host, as
the plant reads it every step; that copy ends the step on the host clock.
Each step's wall time runs from the end of the step before it, so the
window's steps cover its whole time, episode starts included.

A traced run (``trace``) runs the same window, then profiles
``trace_episodes`` more episodes after one that warms the profiler up;
its host spans are those of the window before the profiler started.

Once the window has closed and the device's peak memory has been read,
the port's state is freed and the reference runs the same episodes
(``reference.loop``); ``correct`` compares them.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from benchmark import correct, program, spec
from benchmark import traffic as T
from benchmark.reference.loop import reference_episodes
from benchmark.trace import Tracer, TraceReading, breakdown, reduce


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    plants: int
    setup_s: float
    window_s: float
    steps: int                  # closed-loop steps, all plants at once
    step_s: np.ndarray          # wall time of each step the host spans cover
    regulator_s: np.ndarray     # the regulator span of those steps
    memory_peak_bytes: int
    trace: TraceReading | None


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """Episodes back to back through the deployment, each step timed; with
    `trace_episodes`, that many more episodes profiled at the end (after
    one that warms the profiler up)."""

    def __init__(self, deployment, pool: np.ndarray, trace_episodes: int = 0):
        self.deployment, self.pool = deployment, pool
        self.trace_episodes = trace_episodes
        self.regulator = deployment.regulator
        self.tracer = None
        self.records = []        # (pool index, x, u, canary on the device)
        self.reg_start, self.step_end, self.episode_of = [], [], []
        self.untraced = 0        # episodes before the profiler started
        self.ntt_shapes = None

    def _timed(self, state, xhat, uhat, xr, ur):
        start = time.perf_counter()
        if self.tracer is not None:
            self.tracer.span("regulator")
        u, state = self.regulator(state, xhat, uhat, xr, ur)
        u.cpu()                   # the move crosses to the plant
        end = time.perf_counter()
        if self.tracer is not None:
            self.tracer.span("plant_estimator")
        self.reg_start.append(start)
        self.step_end.append(end)
        self.episode_of.append(len(self.records))
        return u, state

    def episode(self, index: int) -> None:
        index %= len(self.pool)
        if self.tracer is not None:
            self.tracer.span("episode_start")
        x, u, canary = self.deployment.episode(self.pool[index], self._timed)
        self.records.append((index, x, u, canary))
        tracer = self.tracer
        if tracer is not None:
            if tracer.done == tracer.episodes:     # the last profiled one
                self.ntt_shapes = program.ntt_launch_shapes()
            tracer.end_episode()
            if tracer.done == 1:                   # the profiler is warm
                program.reset_ntt_launches()

    def run(self, seconds: float) -> float:
        """Whole episodes until `seconds` have passed (at least one), then
        the profiled ones; returns the wall time of the episodes before
        the profiled ones."""
        self.t0 = time.perf_counter()
        e = 0
        while e == 0 or time.perf_counter() - self.t0 < seconds:
            self.episode(e)
            e += 1
        self.untraced = e
        window_s = time.perf_counter() - self.t0
        if self.trace_episodes:
            self.tracer = Tracer(self.trace_episodes)
            while self.tracer.recording:
                self.episode(e)
                e += 1
        return window_s


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run `cell` once on `device`; returns the result line's fields and
    the checks (``checks``, last)."""
    seeds = T.seeds(seed)
    pool = T.pool(cell.traffic, seeds["traffic"])
    t = time.perf_counter()
    deployment = program.Deployment(cell.config, seed, pool, device)
    warm = Window(deployment, pool)
    t_warm = time.perf_counter()
    warm.episode(0)
    sync(device)
    window = Window(deployment, pool,
                    int(cell.traffic["trace_episodes"]) if trace else 0)
    setup_s = time.perf_counter() - t_start
    phases = {"imports": t - t_start, **deployment.timings,
              "warm_episode": time.perf_counter() - t_warm}
    print("setup " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()),
          file=sys.stderr)
    window_s = window.run(seconds)
    sync(device)
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)

    step_s = np.diff(np.array([window.t0] + window.step_end))
    regulator_s = np.array(window.step_end) - np.array(window.reg_start)
    host = np.array(window.episode_of) < window.untraced
    step_s, regulator_s = step_s[host], regulator_s[host]
    quarters = np.array_split(step_s * 1e3, 4)
    print(f"window {window.untraced} episodes, {len(step_s)} steps, "
          f"{window_s:.3f} s; step ms by quarter: mean "
          + " ".join(f"{q.mean():.4f}" for q in quarters if q.size)
          + ", median " + " ".join(f"{np.median(q):.4f}" for q in quarters
                                   if q.size)
          + f"; regulator span mean {regulator_s.mean() * 1e3:.4f} ms",
          file=sys.stderr)
    reading = None
    if window.tracer is not None:
        spans, ops = window.tracer.events
        reading = reduce(spans, ops, ntt_shapes=window.ntt_shapes,
                         steps=window.trace_episodes * deployment.steps)
    run = Run(plants=deployment.plants, setup_s=setup_s,
              window_s=window_s, steps=int(host.sum()), step_s=step_s,
              regulator_s=regulator_s, memory_peak_bytes=int(memory),
              trace=reading)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    used = [r[0] for r in window.records]
    x = np.stack([r[1] for r in window.records])
    u = np.stack([r[2] for r in window.records])
    canary = np.stack([r[3].cpu().numpy() for r in window.records])
    del deployment, warm, window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    x_ref, u_ref = reference_episodes(cell.config, pool, used)
    checks, failed, attempted = correct.compare(cell.config, x, u, canary,
                                                x_ref, u_ref)
    out = {"correct": correct.passed(checks, failed), "attempted": attempted,
           "failed": failed, "metrics": metrics,
           "device": {"memory_peak_bytes": int(memory)}}
    if reading is not None:
        out["device"].update(busy_s=reading.busy_s, window_s=reading.window_s)
        out["breakdown"] = breakdown(reading)
    out["checks"] = checks
    return out
