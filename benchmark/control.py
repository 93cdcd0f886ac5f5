"""The control of the benchmark's comparison: the reference's closed loop
computed in float32, the nearest precision below the configuration's
float64, put in the port's place and judged by ``correct.compare``.  It
must come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --episodes <E>

For each seed it draws the cell's traffic as a run with that seed does,
takes the first E episodes of it (as many as a run's window holds), and
prints one JSON line per seed with the numbers compared, their limits
and whether the control passed.  Exits 1 if any seed's control passed.
NumPy only: it needs no card and imports nothing of the port.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(cell, seed: int, episodes: int) -> dict:
    import numpy as np

    from benchmark import correct
    from benchmark import traffic as T
    from benchmark.reference.loop import reference_episodes

    pool = T.pool(cell.traffic, T.seeds(seed)["traffic"])
    used = np.arange(episodes) % len(pool)
    x, u = reference_episodes(cell.config, pool, used)
    x32, u32 = reference_episodes(cell.config, pool, used, np.float32)
    canary = np.zeros(x.shape[:2])
    checks, failed, attempted = correct.compare(cell.config, x32, u32, canary,
                                                x, u)
    return {"workload": cell.name, "seed": seed, "episodes": episodes,
            "correct": correct.passed(checks, failed), "failed": failed,
            "attempted": attempted, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--episodes", type=int, required=True)
    args = ap.parse_args(argv)
    from benchmark import spec

    cell = spec.cell(args.workload)
    passed = False
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = control(cell, seed, args.episodes)
        passed |= rec["correct"]
        print(json.dumps(rec), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
