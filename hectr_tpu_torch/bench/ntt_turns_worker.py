"""One process of ``hectr_tpu_torch.bench.ntt_turns``.

    PYTHONPATH=CHECKOUT python ntt_turns_worker.py SHAPES_JSON

Times the NTT kernels of the checkout that PYTHONPATH names through its
public dispatch (``ckks.ntt.ntt`` / ``intt``, which every version of the
port has) at the shapes given, each held bit-equal to that checkout's
plain versions first.  It imports torch, that checkout's
``hectr_tpu_torch`` and, by file path, the timing helpers beside this
file, so it runs against any version of the port.  One JSON line per
shape and kernel.
"""

import importlib.util
import json
import pathlib
import sys

import torch

from hectr_tpu_torch import config
from hectr_tpu_torch.ckks import ntt as T
from hectr_tpu_torch.ckks.context import make_context

# bench/__init__.py imports only torch, so this checkout's copy loads
# beside the other checkout's package
_spec = importlib.util.spec_from_file_location(
    "ntt_turns_timing", pathlib.Path(__file__).with_name("__init__.py"))
timing = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(timing)


def main() -> None:
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    for label, lead, preset in json.loads(sys.argv[1]):
        ctx = make_context(getattr(config, preset))
        primes = ctx.full_primes[:lead[-1]]
        t = T.ntt_tables(ctx.n, primes, device)
        a = torch.stack([torch.randint(0, p, (*lead[:-1], ctx.n),
                                       generator=gen, device=device)
                         for p in primes], dim=-2)
        for name, x, fn, plain in (("ntt", a, T.ntt, T.ntt_plain),
                                   ("intt", T.ntt(a, t), T.intt,
                                    T.intt_plain)):
            if not torch.equal(fn(x, t), plain(x, t)):
                raise AssertionError(f"{name} != plain at {label}")
            ms = timing.cuda_graph_time_ms(lambda: fn(x, t))
            print(json.dumps({"kernel": name, "shape": [*lead, ctx.n],
                              "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
