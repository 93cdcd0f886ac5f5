"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout, on the machine it is started on, which
must hold as many CUDA cards as the cell asks for: without them it exits
with code 2 and prints no result.  With ``--trace 0`` the result's
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a profiled window.  The last line of
standard output is one JSON object: ``correct``, ``attempted`` and
``failed`` (loop-steps), ``metrics``, ``device``, ``breakdown`` when
traced, and ``checks``, each number compared beside its limit, which
also end standard error.  A run exits with code 3 and prints no result
if JAX, Flax or the JAX package was loaded in this process.

The port's kernels build at first use into hectr_tpu_torch/csrc/build
inside the checkout; nothing else is written.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "hectr_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the port, hectr_tpu_torch, is another name)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark import harness

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": cell.chips, **out["device"]}
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
