"""The kernels' launch counters in one registry (``ops.launches``): each
kernel module registers its own counters when it is imported and takes
its ``reset_launches`` from the registry, which imports no kernel
module.  CPU only; no JAX."""

import importlib
import os
import subprocess
import sys

import pytest

from hectr_tpu_torch.ops import launches

# each kernel module and the counters it keeps
OWN = {"ntt_cuda": ("LAUNCHES", "LAUNCH_SHAPES"),
       "ntt_exchange_cuda": ("LAUNCHES", "LAUNCH_SHAPES"),
       "keyswitch_cuda": ("LAUNCHES", "LAUNCH_SHAPES"),
       "rns_cuda": ("LAUNCHES", "OP_LAUNCHES"),
       "codec_cuda": ("LAUNCHES",),
       "mulmod_cuda": ("LAUNCHES",),
       "stages_cuda": ("LAUNCHES",),
       "encrypt_cuda": ("LAUNCHES", "LAUNCH_SHAPES")}


def module(name: str):
    return importlib.import_module(f"hectr_tpu_torch.ops.{name}")


def own(name: str) -> list[dict]:
    return [getattr(module(name), attr) for attr in OWN[name]]


@pytest.fixture
def counted_everywhere():
    """Every kernel module imported and each of its counters holding a
    count; the counters restored after."""
    held = [c for name in OWN for c in own(name)]
    before = [dict(c) for c in held]
    for c in held:
        c[next(iter(c), ("test", 1))] = 3
    yield
    for c, b in zip(held, before):
        c.clear()
        c.update(b)


def is_zero(counter: dict) -> bool:
    return all(n == 0 for n in counter.values())


@pytest.mark.parametrize("name", OWN)
def test_a_modules_counters_are_registered_once(name):
    """Once imported, each of a module's counters is in
    ``launches.counters()``, by identity, once; its ``LAUNCHES`` names
    are in ``launches.by_kernel()``."""
    held = own(name)
    registered = [id(c) for c in launches.counters()]
    for c in held:
        assert registered.count(id(c)) == 1
    assert set(module(name).LAUNCHES) <= set(launches.by_kernel())


@pytest.mark.parametrize("name", OWN)
def test_reset_launches_zeroes_its_own_counters_only(name,
                                                     counted_everywhere):
    """A module's ``reset_launches`` zeroes its ``LAUNCHES`` (keeping the
    kernel names) and empties its Counter, and leaves every other
    module's counters as they were."""
    others = [(c, dict(c)) for other in OWN if other != name
              for c in own(other)]
    names = list(module(name).LAUNCHES)
    module(name).reset_launches()
    assert list(module(name).LAUNCHES) == names
    assert all(is_zero(c) for c in own(name))
    assert all(c == before and not is_zero(c) for c, before in others)


def test_reset_zeroes_every_counter(counted_everywhere):
    """``launches.reset()`` zeroes every registered counter, every kernel
    module's among them."""
    assert not any(is_zero(c) for name in OWN for c in own(name))
    launches.reset()
    assert all(is_zero(c) for c in launches.counters())
    assert all(is_zero(c) for name in OWN for c in own(name))
    assert all(n == 0 for n in launches.by_kernel().values())


def test_the_registry_imports_no_kernel_module():
    """Importing ``ops.launches`` alone imports no kernel module."""
    code = ("import sys, hectr_tpu_torch.ops.launches; "
            "print(sorted(m for m in sys.modules if m.endswith('_cuda')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
