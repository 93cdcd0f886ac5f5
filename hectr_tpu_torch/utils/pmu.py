"""Per-section timing -- the libpmu TEST_DO/TEST_DONE equivalent, as
``hectr_tpu/utils/pmu.py``.

The reference brackets keygen, rotation keygen and the closed loop with
libpmu macros (src/ctr.c:528-533,570,597).  Here a section waits for the
CUDA device before it starts and before it stops (where the JAX package
calls jax.effects_barrier), so asynchronous launches are not left out,
and can capture a torch.profiler trace for perfetto.
"""

from __future__ import annotations

import contextlib
import pathlib
import sys
import time

import torch


def _profile():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Accumulates named section timings; prints each to stderr."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, label: str, trace_dir: str | None = None):
        """Time the body; with `trace_dir`, also write a torch.profiler
        Chrome trace of it there (``<label>.json``)."""
        with (_profile() if trace_dir else contextlib.nullcontext()) as prof:
            _sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                _sync()
                dt = time.perf_counter() - t0
                self.sections[label] = self.sections.get(label, 0.0) + dt
                print(f"[pmu] {label}: {dt:.3f}s", file=sys.stderr)
        if prof is not None:
            out = pathlib.Path(trace_dir)
            out.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out / f"{label}.json"))

    def report(self) -> dict[str, float]:
        return dict(self.sections)


@contextlib.contextmanager
def timed(label: str):
    """One-off section timer (TEST_DO(label) ... TEST_DONE parity)."""
    with Timer().section(label):
        yield
