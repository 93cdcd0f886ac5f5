"""The kernels' launch counters under CUDA-graph replay.

Each wrapper of ``ops`` counts its launches on the host, where it makes
them (``LAUNCHES``, and ``LAUNCH_SHAPES`` / ``OP_LAUNCHES`` by shape or
primitive).  A CUDA graph's capture runs the wrappers once, launching
nothing; each replay launches what the capture recorded without running
them.  ``Replayed`` keeps the counters true across both: a capture
inside ``Replayed.capture()`` leaves every counter as it found it and
keeps what it would have added, and ``Replayed.replay()`` adds that once
for each replay, so the counters read what the uncaptured calls would
have made them read (and ``reset_launches`` clears them as usual).
"""

from __future__ import annotations

import contextlib

from hectr_tpu_torch.ops import (codec_cuda, keyswitch_cuda, mulmod_cuda,
                                 ntt_cuda, ntt_exchange_cuda, rns_cuda,
                                 stages_cuda)


def counters() -> list[dict]:
    """Every launch counter (a dict or a Counter)."""
    return [ntt_cuda.LAUNCHES, ntt_cuda.LAUNCH_SHAPES,
            ntt_exchange_cuda.LAUNCHES, ntt_exchange_cuda.LAUNCH_SHAPES,
            keyswitch_cuda.LAUNCHES, keyswitch_cuda.LAUNCH_SHAPES,
            rns_cuda.LAUNCHES, rns_cuda.OP_LAUNCHES, codec_cuda.LAUNCHES,
            mulmod_cuda.LAUNCHES, stages_cuda.LAUNCHES]


class Replayed:
    """The launches one capture counted, added again at each replay."""

    def __init__(self):
        self.adds: list[tuple[dict, object, int]] = []

    @contextlib.contextmanager
    def capture(self):
        """Run the body (a capture) with every counter left as it was;
        what the body added is kept for ``replay``."""
        held = counters()
        before = [dict(c) for c in held]
        try:
            yield self
        finally:
            self.adds = [(c, key, n - b.get(key, 0))
                         for c, b in zip(held, before)
                         for key, n in c.items() if n != b.get(key, 0)]
            for c, b in zip(held, before):
                c.clear()
                c.update(b)

    def replay(self) -> None:
        """Count the captured launches once more."""
        for c, key, n in self.adds:
            c[key] = c.get(key, 0) + n
