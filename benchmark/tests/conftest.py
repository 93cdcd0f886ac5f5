"""The benchmark's tests import its modules as ``benchmark.*`` from the
checkout's root, and its scripts (run.py, control.py) by file name."""

import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
for path in (HERE.parent, HERE):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import torch  # noqa: E402

# the harness runs on the CPU here, several test processes at once
torch.set_num_threads(2)
