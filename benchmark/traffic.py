"""The one traffic generator: every cell's traffic is a data file of
parameters that this module reads.

A traffic file gives the plants served at once (``plants``), the steps of
an episode (``episode_steps``), how many distinct episodes a run may draw
(``pool_episodes``; a window that runs out of them starts over), how many
episodes a traced run profiles (``trace_episodes``) and the disturbance.
The disturbance is a step in the inlet flow F0 (the upstream's published
disturbance, tests/hectr.c): each plant of each episode gets its own size,
``published`` times a factor drawn uniformly from ``scale``, and its own
onset step, drawn uniformly from ``onset_share`` of the episode.  The
set-points are zero, as in the upstream loop.  The loop is closed: a
plant's next step waits for its previous move.
"""

from __future__ import annotations

import numpy as np

STREAMS = ("keygen", "rotations", "encryption", "traffic")


def seeds(seed: int) -> dict[str, int]:
    """Independent 32-bit seeds for each random stream of a run."""
    if seed < 0:
        raise ValueError(f"--seed must be >= 0, got {seed}")
    words = np.random.SeedSequence(seed).generate_state(len(STREAMS),
                                                        dtype=np.uint32)
    return {name: int(w) for name, w in zip(STREAMS, words)}


def stream(seed: int, name: str) -> int:
    """The 32-bit seed of the random stream `name` that a regulator form
    draws from (a relinearisation key, say): from the run's seed and the
    name, independent of ``seeds``' streams and of every other name."""
    if seed < 0 or not name:
        raise ValueError(f"a stream needs a seed >= 0 and a name, got "
                         f"{seed}, {name!r}")
    sequence = np.random.SeedSequence(seed, spawn_key=tuple(name.encode()))
    return int(sequence.generate_state(1, dtype=np.uint32)[0])


def episodes(traffic: dict, seed: int, count: int) -> np.ndarray:
    """`count` episodes of disturbances [count, plants, episode_steps, 1]
    (deviations of F0 from its steady state), drawn from `seed`."""
    dist = traffic["disturbance"]
    if dist["kind"] != "inlet_flow_step" or traffic["setpoints"] != "zero":
        raise ValueError(f"traffic of disturbance {dist['kind']!r} and "
                         f"set-points {traffic['setpoints']!r}: the generator "
                         f"makes inlet-flow steps about zero set-points")
    B, N = int(traffic["plants"]), int(traffic["episode_steps"])
    rng = np.random.default_rng(seed)
    lo, hi = dist["scale"]
    size = dist["published"] * rng.uniform(lo, hi, (count, B))
    first, last = (int(np.floor(s * N)) for s in dist["onset_share"])
    onset = rng.integers(first, max(last, first + 1), (count, B))
    steps = np.arange(N)
    p = np.where(steps[None, None, :] >= onset[..., None], size[..., None], 0.0)
    return p[..., None]


def pool(traffic: dict, seed: int) -> np.ndarray:
    """The episodes a run with this traffic seed draws from, in order:
    [pool_episodes, plants, N, 1].  The warm-up episode is the first."""
    return episodes(traffic, seed, int(traffic["pool_episodes"]))
