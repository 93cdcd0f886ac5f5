"""The kernels' launch counters: one registry, and their counts under
CUDA-graph replay.

Each wrapper of ``ops`` counts its launches on the host, where it makes
them (``LAUNCHES``, and ``LAUNCH_SHAPES`` / ``OP_LAUNCHES`` by shape or
primitive).  Each kernel module registers its counters here when it is
imported (``register``) and takes its ``reset_launches`` from
``resetter``; ``counters()``, ``by_kernel()`` and ``reset()`` reach
every registered counter, so a kernel module is counted once it is
imported, and one that is not imported launches nothing.  A dict of
names is zeroed name by name, a Counter emptied.  A Counter of other
work issued from the host (the encrypted QP's multiplies and rescales,
``hempc.qp_enc.COUNTS``) registers here too, so that replays count it;
``by_kernel`` leaves it out with the other Counters.

A CUDA graph's capture runs the wrappers once, launching nothing; each
replay launches what the capture recorded without running them.
``Replayed`` keeps the counters true across both: a capture inside
``Replayed.capture()`` leaves every counter as it found it and keeps
what it would have added, and ``Replayed.replay()`` adds that once for
each replay, so the counters read what the uncaptured calls would have
made them read (and ``reset_launches`` clears them as usual).
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable

_COUNTERS: list[dict] = []


def register(counter: dict) -> dict:
    """Add a launch counter (a dict or a Counter) to the registry;
    returns it."""
    _COUNTERS.append(counter)
    return counter


def counters() -> list[dict]:
    """Every registered launch counter."""
    return list(_COUNTERS)


def by_kernel() -> dict:
    """The launches by kernel name: every module's ``LAUNCHES`` (the
    registered dicts of names) merged, its Counters by shape or primitive
    left out."""
    return {name: n for c in _COUNTERS
            if not isinstance(c, collections.Counter) for name, n in c.items()}


def _zero(counter: dict) -> None:
    if isinstance(counter, collections.Counter):
        counter.clear()
    else:
        for name in counter:
            counter[name] = 0


def resetter(*held: dict) -> Callable[[], None]:
    """A module's ``reset_launches``: zeroes `held`, its own counters."""
    def reset_launches() -> None:
        for counter in held:
            _zero(counter)
    return reset_launches


def reset() -> None:
    """Zero every registered counter."""
    resetter(*_COUNTERS)()


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
