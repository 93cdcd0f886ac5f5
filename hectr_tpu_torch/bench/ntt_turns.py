"""K1/K2 of this checkout against another checkout's, in turns.

    python -m hectr_tpu_torch.bench.ntt_turns OTHER_CHECKOUT

OTHER_CHECKOUT is another version of the repository, e.g. a parent
commit unpacked with ``git archive`` into a git-ignored directory.  Four
processes run ``ntt_turns_worker.py``, in the order other, this, this,
other, each against one checkout's ``hectr_tpu_torch`` (its kernels built
from its own sources into its own build directory): the kernels are held
bit-equal to that checkout's plain versions and timed by CUDA-graph
replay at ``ntt_kernels.SHAPES``.  One JSON line per shape and kernel
(each checkout's mean of its two runs, the four runs, other / this), the
card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

import torch

from hectr_tpu_torch.bench.ntt_kernels import SHAPES, card_line

WORKER = pathlib.Path(__file__).with_name("ntt_turns_worker.py")
THIS = pathlib.Path(__file__).resolve().parents[2]


def run(root: pathlib.Path) -> dict:
    """{(kernel, shape): ms} from one worker against `root`."""
    shapes = json.dumps([[label, list(lead), preset]
                         for label, lead, preset in SHAPES])
    out = subprocess.run([sys.executable, str(WORKER), shapes],
                         env={**os.environ, "PYTHONPATH": str(root)},
                         capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"worker against {root} failed:\n{out.stderr}")
    return {(r["kernel"], tuple(r["shape"])): r["ms"]
            for r in map(json.loads, out.stdout.splitlines())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path,
                    help="the root of another checkout of the repository")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: kernel times are device metrics")
    other = args.other.resolve()
    runs = [run(root) for root in (other, THIS, THIS, other)]
    for key in runs[1]:
        old = (runs[0][key] + runs[3][key]) / 2
        new = (runs[1][key] + runs[2][key]) / 2
        print(json.dumps({"kernel": key[0], "shape": list(key[1]),
                          "other_ms": old, "ms": new, "speedup": old / new,
                          "runs": [r[key] for r in runs]}), flush=True)
    print(json.dumps({"card": card_line(), "torch": torch.__version__}))


if __name__ == "__main__":
    main()
