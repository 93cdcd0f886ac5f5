"""The closed loop's own stages as one CUDA graph a step
(``control.simulate`` ``StageGraph``) and the stiff step's solves.

On the CPU: ``stiff_step``'s LAPACK solve without its check bit-equal to
``torch.linalg.solve``; the card's pivoted solve against LAPACK; the CPU
loop uncaptured, counting nothing; the graph's keys, captures, copies
and counts with a stand-in for the CUDA graph, bit-equal to the
uncaptured loop.  On the card (marked ``cuda``; they skip elsewhere),
for a plant that K13 does not take (the CSTR's right-hand side
wrapped; the CSTR's own stages are K13's, ``test_torch_loop_kernel.py``):
episodes through the captured stages bit-equal to the uncaptured stages
with the plaintext and the encrypted regulator, and what the graph adds
to the card's peak memory.  The file imports neither jax nor the JAX
package, so it runs where the card is:

    python -m pytest tests/test_torch_loop_graph.py --noconftest -o addopts="" -q
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from hectr_tpu_torch import cli
from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.control import ode
from hectr_tpu_torch.control import simulate as sim
from hectr_tpu_torch.control.plants import cstr
from hectr_tpu_torch.hempc import make_hempc_regulator
from hectr_tpu_torch.utils import pmu
from loop_cases import (CPU, HORIZON, assert_bit_equal, card,  # noqa: F401
                        disturbances, episodes, graph_setup, loop_counts,
                        regulator_and_sampler, secure, shifted_setup)


# ---- the stiff step's solves ------------------------------------------------


@pytest.mark.parametrize("batch", [(), (5,)])
def test_stiff_step_bit_equal_checked_solve_on_the_cpu(batch):
    """``stiff_step`` solves with ``torch.linalg.solve_ex`` (no status
    check) on the CPU: bit-equal to the checked ``torch.linalg.solve``,
    for one state and a batch."""
    rng = np.random.default_rng(3)
    xs = cstr.CSTR_STEADY_STATE["xs"]
    x = torch.from_numpy(xs * rng.uniform(0.9, 1.1, (*batch, 3)))
    u = torch.from_numpy(np.array([290.0, 0.1]) * rng.uniform(0.9, 1.1,
                                                              (*batch, 2)))
    p = torch.from_numpy(rng.uniform(0.05, 0.15, (*batch, 1)))
    dt = 0.5
    A = torch.eye(3, dtype=torch.float64) - dt * cstr.cstr_jacobian(x, u, p)
    want = x + dt * torch.linalg.solve(A, cstr.cstr_ode(x, u, p))
    got = ode.stiff_step(cstr.cstr_ode, cstr.cstr_jacobian, x, u, p, dt)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_pivoted_solve_against_lapack(n):
    """``solve_pivoted`` (the card's solve) on CPU tensors: one system
    and a batch, the CSTR's own systems, and systems whose leading entry
    is zero or tiny (which need the row swaps), within 1e-12 of LAPACK
    relative to the solution."""
    rng = np.random.default_rng(n)
    A = rng.normal(size=(64, n, n))
    if n > 1:
        A[:16, 0, 0] = 0.0
        A[16:32, 0, 0] = 1e-14
        A[32:48] = np.eye(n)[::-1] + 1e-3 * A[32:48]  # anti-diagonal
    A, b = torch.from_numpy(A), torch.from_numpy(rng.normal(size=(64, n)))
    want = torch.linalg.solve(A, b)
    got = ode.solve_pivoted(A, b)
    assert got.shape == want.shape
    scale = want.abs().amax(-1, keepdim=True)
    assert ((got - want).abs() / scale).max() < 1e-12
    one = ode.solve_pivoted(A[0], b[0])
    assert one.shape == (n,)
    assert ((one - want[0]).abs().max() / scale[0]) < 1e-12


def test_pivoted_solve_of_the_plants_systems():
    """The stiff step's systems (I - dt J) at states around the CSTR's
    steady state: ``solve_pivoted`` within 1e-14 of LAPACK."""
    rng = np.random.default_rng(5)
    xs = cstr.CSTR_STEADY_STATE["xs"]
    x = torch.from_numpy(xs * rng.uniform(0.8, 1.2, (256, 3)))
    u = torch.from_numpy(np.array([290.0, 0.1]) * rng.uniform(0.8, 1.2,
                                                              (256, 2)))
    p = torch.from_numpy(rng.uniform(0.05, 0.15, (256, 1)))
    A = torch.eye(3, dtype=torch.float64) - 0.5 * cstr.cstr_jacobian(x, u, p)
    b = cstr.cstr_ode(x, u, p)
    want = torch.linalg.solve(A, b)
    err = (ode.solve_pivoted(A, b) - want).abs() / want.abs().amax(
        -1, keepdim=True)
    assert err.max() < 1e-14


# ---- the loop's stages off the card -----------------------------------------


def test_cpu_loop_stays_uncaptured_and_counts_nothing(monkeypatch):
    """On the CPU no graph is made, K13 is not packed for and nothing is
    counted; the loop's stage graph and kernel are left as they were."""
    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph on the CPU path")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(sim, "_GRAPH", sim.StageGraph())
    monkeypatch.setattr(sim, "_KERNEL", sim.StageKernel())
    pmu.reset_counts()
    episodes(disturbances(2, 3), CPU)
    episodes(disturbances(1, 3, (2,)), CPU)
    assert dict(pmu.COUNTS) == {}
    assert sim._GRAPH.graph is None and sim._GRAPH.constants is None
    assert sim._KERNEL.constants is None


class StandIn:
    """A stand-in for ``torch.cuda.CUDAGraph`` whose replay runs the
    stages on the held inputs into the held outputs."""

    def __init__(self):
        self.holder = sim._GRAPH

    def replay(self):
        g = self.holder
        for held, t in zip(g.outputs, g.constants.step(*g.inputs, 0, True)):
            held.copy_(t)


class Capture:
    """A stand-in for ``torch.cuda.graph``: the body runs (on the held
    inputs, uninitialised), as the capture records it."""

    def __init__(self, graph, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_stage_graph_bookkeeping_with_a_stand_in_graph(monkeypatch):
    """``StageGraph`` on the CPU with a stand-in for the CUDA graph:
    one capture a key and a replay at every later step; a model and
    plant built anew with the same values reuse the graph and its
    constants; a new batch shape, then other plant values, capture again
    and free the graph before; every episode bit-equal to the uncaptured
    loop, and every tensor a step hands out a new one, never the graph's
    own."""
    holder = sim.StageGraph()
    monkeypatch.setattr(sim, "_GRAPH", holder)
    runs = [(disturbances(2, 3), cli.cstr_setup),
            (disturbances(1, 4), cli.cstr_setup),
            (disturbances(1, 3, (2,)), cli.cstr_setup),
            (disturbances(1, 2, (2,)), shifted_setup)]
    want = [episodes(p, CPU, setup=setup) for p, setup in runs]

    monkeypatch.setattr(sim, "_runner", lambda plant, device: sim._GRAPH)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandIn)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    handed = []

    def mpc(state, xhat, uhat, xr, ur):
        handed.append((xhat, xr, ur))
        return plain(state, xhat, uhat, xr, ur)

    plain = sim.make_mpc_regulator(*cli.cstr_setup(), HORIZON, CPU)
    pmu.reset_counts()
    got, graphs, constants = [], [], []
    for p, setup in runs:
        got.append(episodes(p, CPU, reg=mpc, setup=setup))
        graphs.append(holder.graph)
        constants.append(holder.constants)
    assert loop_counts() == {"loop.uncaptured": 3, "loop.capture": 3,
                             "loop.replay": 5 + 4 + 2 + 1}
    assert graphs[0] is graphs[1]
    assert constants[0] is constants[1] is constants[2] is not constants[3]
    graphs = [weakref.ref(g) for g in graphs]
    gc.collect()
    assert [g() is None for g in graphs] == [True, True, True, False]
    for a, b in zip(got, want):
        assert_bit_equal(a, b)
    held = {t.data_ptr() for t in (*holder.inputs, *holder.outputs)}
    ptrs = [t.data_ptr() for ts in handed for t in ts]
    assert not held & set(ptrs)
    assert len(handed) == 3 * 2 + 4 + 3 + 2
    pmu.reset_counts()


# ---- on the card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [(), (4,)])
@pytest.mark.parametrize("kind", ["plaintext", "encrypted"])
def test_captured_stages_bit_equal_uncaptured(card, request, monkeypatch,
                                              kind, batch):
    """Two 40-step episodes of a plant K13 does not take (the CSTR's
    right-hand side wrapped), one plant and four, with the plaintext and
    the encrypted regulator: moves, states and canaries through the
    replayed stages bit-equal to the same stages run uncaptured on the
    card; one capture, 79 replays, one uncaptured step.  The plaintext
    loop within 1e-10 of the CPU's."""
    reg, sampler = regulator_and_sampler(kind, request, card)
    p = disturbances(2, 40, batch)
    monkeypatch.setattr(sim, "_GRAPH", sim.StageGraph())
    pmu.reset_counts()
    got = episodes(p, card, reg, sampler(), setup=graph_setup)
    torch.cuda.synchronize()
    counts = loop_counts()
    with monkeypatch.context() as m:
        m.setattr(sim, "_runner", lambda plant, device: None)
        want = episodes(p, card, reg, sampler(), setup=graph_setup)
    assert_bit_equal(got, want)
    assert counts == {"loop.uncaptured": 1, "loop.capture": 1,
                      "loop.replay": 79}
    if kind == "plaintext":
        for (x, u, _), (xc, uc, _) in zip(got, episodes(p, CPU)):
            np.testing.assert_allclose(x, xc, rtol=1e-10, atol=0)
            np.testing.assert_allclose(u, uc, rtol=1e-10, atol=0)
    pmu.reset_counts()


@pytest.mark.cuda
def test_stage_graph_adds_under_half_a_megabyte_to_the_peak(card, secure,
                                                           monkeypatch):
    """The card's peak memory over a one-plant episode of the encrypted
    loop at reference-hempc-secure (a plant K13 does not take: the CSTR's
    right-hand side wrapped), with the stages uncaptured, then with the
    stage graph captured in that episode and replayed: less than 0.5 MB
    apart."""
    ctx, keys, rk = secure
    reg = make_hempc_regulator(ctx, keys, rk, *cli.cstr_setup(), HORIZON)
    sampler = S.TorchSampler(5, card)
    p = disturbances(3, 40)
    monkeypatch.setattr(sim, "_GRAPH", sim.StageGraph())

    def peak(pe):
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats(card)
        episodes(pe[None], card, reg, sampler, setup=graph_setup)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(card)

    with monkeypatch.context() as m:
        m.setattr(sim, "_runner", lambda plant, device: None)
        peak(p[0])                       # the regulator's own capture
        without = peak(p[1])
    with_graph = peak(p[2])
    print(f"peak without the stage graph {without} B, with {with_graph} B")
    assert sim._GRAPH.graph is not None
    assert with_graph - without < 0.5e6
