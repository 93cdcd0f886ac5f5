"""The encrypted regulator as one CUDA graph a step (``hempc.regulator``
``StepGraph``) and the launch counters under replay
(``ops.launches.Replayed``).

On the CPU: the launch accounting as a unit, and the regulator staying
uncaptured wherever the graph cannot run (the CPU, an injected sampler,
a limb mesh), its moves bit-equal to the uncaptured step's.  On the card
(marked ``cuda``; they skip elsewhere): whole episodes replayed, bit-equal
to the closure's uncaptured step on the same seeds, with the counters.
The file imports neither jax nor the JAX package, so it runs where the
card is:

    python -m pytest tests/test_torch_regulator_graph.py --noconftest -o addopts="" -q
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from hectr_tpu_torch import cli
from hectr_tpu_torch import config as cfg
from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.ckks.gemv import bsgs_rotations
from hectr_tpu_torch.control.simulate import simulate, simulate_batch
from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
from hectr_tpu_torch.ops import (codec_cuda, keyswitch_cuda, launches,
                                 mulmod_cuda, ntt_cuda, ntt_exchange_cuda,
                                 rns_cuda, stages_cuda)
from hectr_tpu_torch.utils import pmu

CPU = torch.device("cpu")
HORIZON = 4
SMALL = cfg.CKKSPreset(name="graph-test", logn=10, slots=16, scale_bits=50,
                       limb_bits=25, mult_depth=1)


def reset_all_launches():
    for mod in (ntt_cuda, ntt_exchange_cuda, keyswitch_cuda, rns_cuda,
                codec_cuda, mulmod_cuda, stages_cuda):
        mod.reset_launches()


def counted() -> list[dict]:
    return [dict(c) for c in launches.counters()]


def episodes(reg, sampler, p, device):
    """Closed-loop episodes back to back through `reg` with one sampler
    (p [E, N, 1] for one plant, [E, B, N, 1] for B plants): x, u and the
    canary of each, on the host."""
    out = []
    for pe in p:
        batch = pe.shape[:-2]
        state = hempc_init_state(sampler, device, batch)
        if batch:
            x, u, (_, c) = simulate_batch(*cli.cstr_setup(), pe, 1.0,
                                          pe.shape[-2], device, reg, state,
                                          HORIZON)
        else:
            x, u, (_, c) = simulate(*cli.cstr_setup(), pe, 1.0, pe.shape[-2],
                                    device, regulator=reg,
                                    regulator_state=state, horizon=HORIZON,
                                    return_state=True)
        out.append((x, u, c.cpu()))
    return out


def regulator_counts() -> dict:
    """``pmu.COUNTS``' regulator keys (the loop counts its stage graph's
    own on the card)."""
    return {k: v for k, v in pmu.COUNTS.items() if k.startswith("regulator.")}


def assert_bit_equal(a, b):
    assert len(a) == len(b)
    for (x, u, c), (x1, u1, c1) in zip(a, b):
        assert np.array_equal(x, x1) and np.array_equal(u, u1)
        assert torch.equal(c, c1)


def disturbances(episodes_: int, steps: int, batch=()):
    """Inlet-flow steps of 0.5-1.5x the reference's, one per episode and
    plant: [episodes, *batch, steps, 1]."""
    rng = np.random.default_rng(11)
    scale = rng.uniform(0.5, 1.5, (episodes_, *batch, 1, 1))
    return cli.disturbance(steps)[None] * scale


# ---- the launch counters under replay (pure Python) -------------------------


def test_replayed_counts_a_capture_once_per_replay():
    """A capture leaves every counter as it found it (no zero entries
    added); each replay adds what the capture counted, and still does
    after reset_launches."""
    reset_all_launches()
    ntt_cuda.LAUNCHES["ntt"] += 5
    ntt_cuda.LAUNCH_SHAPES["ntt", (3, 8)] += 5
    before = counted()
    rep = launches.Replayed()
    with rep.capture():
        ntt_cuda.LAUNCHES["ntt"] += 2
        ntt_cuda.LAUNCHES["intt"] += 1
        ntt_cuda.LAUNCH_SHAPES["ntt", (3, 8)] += 2
        ntt_cuda.LAUNCH_SHAPES["intt", (2, 8)] += 1
        rns_cuda.OP_LAUNCHES["add_mod"] += 4
    assert counted() == before
    rep.replay()
    rep.replay()
    assert ntt_cuda.LAUNCHES == {"ntt": 9, "intt": 2}
    assert ntt_cuda.LAUNCH_SHAPES == {("ntt", (3, 8)): 9,
                                      ("intt", (2, 8)): 2}
    assert rns_cuda.OP_LAUNCHES == {"add_mod": 8}
    ntt_cuda.reset_launches()
    rns_cuda.reset_launches()
    rep.replay()
    assert ntt_cuda.LAUNCHES == {"ntt": 2, "intt": 1}
    assert dict(ntt_cuda.LAUNCH_SHAPES) == {("ntt", (3, 8)): 2,
                                            ("intt", (2, 8)): 1}
    assert dict(rns_cuda.OP_LAUNCHES) == {"add_mod": 4}
    reset_all_launches()


def test_a_failed_capture_leaves_the_counters():
    """A capture that raises leaves the counters as they were."""
    reset_all_launches()
    rep = launches.Replayed()
    with pytest.raises(RuntimeError):
        with rep.capture():
            ntt_cuda.LAUNCHES["ntt"] += 3
            raise RuntimeError("capture failed")
    assert ntt_cuda.LAUNCHES == {"ntt": 0, "intt": 0}


# ---- the regulator stays uncaptured off the card ---------------------------


@pytest.fixture(scope="module")
def small():
    ctx, keys, rk = cli.hempc_keys(SMALL, 0, CPU, bsgs_rotations(16))
    return ctx, keys, rk


class NumpySampler:
    """An injected sampler (not a TorchSampler): numpy draws."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def encryption(self, ctx, k, batch, device):
        def draw(f):
            return torch.from_numpy(f((*batch, ctx.n))).to(device)
        return (draw(lambda s: self.rng.integers(-1, 2, s)),
                draw(lambda s: np.round(3.2 * self.rng.normal(size=s))
                     .astype(np.int64)),
                draw(lambda s: np.round(3.2 * self.rng.normal(size=s))
                     .astype(np.int64)))


@pytest.mark.parametrize("sampler", ["torch", "numpy"])
def test_regulator_stays_uncaptured_on_the_cpu(small, monkeypatch, sampler):
    """On the CPU, with the port's sampler or an injected one, every call
    runs the uncaptured step: no graph is made, the counters show only
    uncaptured calls, and the moves, states and canaries are bit-equal
    to the closure's uncaptured step on the same draws."""
    ctx, keys, rk = small
    model, plant = cli.cstr_setup()
    reg = make_hempc_regulator(ctx, keys, rk, model, plant, HORIZON)

    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph on the CPU path")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    make = {"torch": lambda: S.TorchSampler(5, CPU),
            "numpy": lambda: NumpySampler(5)}[sampler]
    p = disturbances(2, 3)
    pmu.reset_counts()
    got = episodes(reg, make(), p, CPU)
    assert pmu.COUNTS == {"regulator.uncaptured": 6}
    assert_bit_equal(got, episodes(reg.uncaptured, make(), p, CPU))
    pmu.reset_counts()


def test_batched_regulator_stays_uncaptured_on_the_cpu(small):
    """Two plants in one regulator on the CPU: uncaptured, bit-equal."""
    ctx, keys, rk = small
    model, plant = cli.cstr_setup()
    reg = make_hempc_regulator(ctx, keys, rk, model, plant, HORIZON)
    p = disturbances(1, 2, (2,))
    pmu.reset_counts()
    got = episodes(reg, S.TorchSampler(6, CPU), p, CPU)
    assert pmu.COUNTS == {"regulator.uncaptured": 2}
    assert_bit_equal(got, episodes(reg.uncaptured, S.TorchSampler(6, CPU), p,
                                   CPU))
    pmu.reset_counts()


def test_limb_mesh_regulator_stays_uncaptured(small):
    """On a limb mesh (LimbOps) the step is never captured, and equals
    the single device's on the same draws."""
    from hectr_tpu_torch.parallel import make_mesh
    from hectr_tpu_torch.parallel.limb_ops import LimbOps

    ctx, keys, rk = small
    model, plant = cli.cstr_setup()
    p = disturbances(1, 2)
    pmu.reset_counts()
    reg = make_hempc_regulator(ctx, keys, rk, model, plant, HORIZON,
                               ops=LimbOps(ctx, make_mesh(limb=2, device=CPU)))
    got = episodes(reg, S.TorchSampler(7, CPU), p, CPU)
    assert pmu.COUNTS == {"regulator.uncaptured": 2}
    one = make_hempc_regulator(ctx, keys, rk, model, plant, HORIZON)
    assert_bit_equal(got, episodes(one.uncaptured, S.TorchSampler(7, CPU), p,
                                   CPU))
    pmu.reset_counts()


def test_step_graph_bookkeeping_with_a_stand_in_graph(small, monkeypatch):
    """StepGraph's keys, captures, copies and counts on the CPU, with a
    stand-in for the CUDA graph: its capture draws nothing (the
    generator's state is put back, as a capture leaves it) and its replay
    runs the step on the held inputs into the held outputs.  Episodes,
    a change of batch and a second sampler come out bit-equal to the
    uncaptured step, counted as the card counts them; a returned move is
    never the held output."""
    from hectr_tpu_torch.hempc.regulator import StepGraph

    ctx, keys, rk = small
    model, plant = cli.cstr_setup()
    reg = make_hempc_regulator(ctx, keys, rk, model, plant, HORIZON)
    graph = StepGraph(reg.uncaptured)
    held = {}

    class StandIn:
        def register_generator_state(self, gen):
            self.gen = gen

        def replay(self):
            u, (_, c) = graph.step((held["sampler"], graph.inputs[-1]),
                                   *graph.inputs[:-1])
            graph.outputs[0].copy_(u)
            graph.outputs[1].copy_(c)

    class capture:
        def __init__(self, g):
            self.g = g

        def __enter__(self):
            self.state = self.g.gen.get_state()

        def __exit__(self, *exc):
            self.g.gen.set_state(self.state)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandIn)
    monkeypatch.setattr(torch.cuda, "graph", capture)

    def run(sampler, p):
        held["sampler"] = sampler
        return episodes(graph, sampler, p, CPU)

    pmu.reset_counts()
    a, b = S.TorchSampler(3, CPU), S.TorchSampler(4, CPU)
    got = run(a, disturbances(2, 3)) + run(a, disturbances(1, 2, (2,))) \
        + run(b, disturbances(1, 2))
    assert dict(pmu.COUNTS) == {"regulator.uncaptured": 3,
                                "regulator.capture": 3,
                                "regulator.replay": 7}
    a, b = S.TorchSampler(3, CPU), S.TorchSampler(4, CPU)
    want = episodes(reg.uncaptured, a, disturbances(2, 3), CPU) \
        + episodes(reg.uncaptured, a, disturbances(1, 2, (2,)), CPU) \
        + episodes(reg.uncaptured, b, disturbances(1, 2), CPU)
    assert_bit_equal(got, want)
    zeros = [torch.zeros(n, dtype=torch.float64) for n in (3, 2, 3, 2)]
    u, (_, c) = graph((b, torch.zeros(())), *zeros)
    assert u.data_ptr() != graph.outputs[0].data_ptr()
    assert c.data_ptr() != graph.outputs[1].data_ptr()
    pmu.reset_counts()


# ---- on the card ------------------------------------------------------------


@pytest.fixture(scope="module")
def secure_card():
    """The benchmark configuration's ring (reference-hempc-secure) on the
    card, BSGS rotation keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    device = torch.device("cuda", torch.cuda.current_device())
    ctx, keys, rk = cli.hempc_keys(cfg.REFERENCE_HEMPC_SECURE, 0, device,
                                   bsgs_rotations(16))
    return ctx, keys, rk, device


def replayed_against_uncaptured(reg, p, device, seed=3):
    """Episodes through the closure (graph) and through its uncaptured
    step, each from TorchSampler(seed): (graph runs, uncaptured runs,
    the counts of the graph runs, the launch counters after each)."""
    reset_all_launches()
    want = episodes(reg.uncaptured, S.TorchSampler(seed, device), p, device)
    torch.cuda.synchronize()
    want_launches = counted()
    reset_all_launches()
    pmu.reset_counts()
    got = episodes(reg, S.TorchSampler(seed, device), p, device)
    torch.cuda.synchronize()
    counts = regulator_counts()
    return got, want, counts, counted(), want_launches


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [(), (4,)])
def test_replayed_episodes_bit_equal_uncaptured(secure_card, batch):
    """Two 40-step episodes with one sampler at the benchmark's ring, one
    plant and four: moves, states and canaries bit-equal to the
    uncaptured step on the same seed; one capture, 79 replays, one
    uncaptured call; every launch counter as the uncaptured path left
    it."""
    ctx, keys, rk, device = secure_card
    reg = make_hempc_regulator(ctx, keys, rk, *cli.cstr_setup(), HORIZON)
    got, want, counts, after, want_launches = replayed_against_uncaptured(
        reg, disturbances(2, 40, batch), device)
    assert_bit_equal(got, want)
    assert counts == {"regulator.capture": 1, "regulator.replay": 79,
                      "regulator.uncaptured": 1}
    assert after == want_launches
    assert ntt_cuda.LAUNCHES["ntt"] > 0


@pytest.mark.cuda
def test_new_batch_shape_captures_again_and_frees_the_old_graph(secure_card):
    """One closure, one plant then four: a second capture, the first
    graph freed; each bit-equal to the uncaptured step."""
    ctx, keys, rk, device = secure_card
    reg = make_hempc_regulator(ctx, keys, rk, *cli.cstr_setup(), HORIZON)
    sampler = S.TorchSampler(4, device)
    pmu.reset_counts()
    one = episodes(reg, sampler, disturbances(1, 3), device)
    holder = [c.cell_contents for c in reg.__closure__
              if type(c.cell_contents).__name__ == "StepGraph"][0]
    first = weakref.ref(holder.graph)
    four = episodes(reg, sampler, disturbances(1, 3, (4,)), device)
    gc.collect()
    assert first() is None and holder.graph is not None
    assert regulator_counts() == {"regulator.capture": 2,
                                  "regulator.replay": 4,
                                  "regulator.uncaptured": 2}
    sampler = S.TorchSampler(4, device)
    assert_bit_equal(one, episodes(reg.uncaptured, sampler,
                                   disturbances(1, 3), device))
    assert_bit_equal(four, episodes(reg.uncaptured, sampler,
                                    disturbances(1, 3, (4,)), device))


@pytest.mark.cuda
def test_second_sampler_gets_its_own_capture(secure_card):
    """Episodes from one sampler, then from another: a capture for each,
    every move bit-equal to the uncaptured step from the same seeds."""
    ctx, keys, rk, device = secure_card
    reg = make_hempc_regulator(ctx, keys, rk, *cli.cstr_setup(), HORIZON)
    p = disturbances(1, 5)
    pmu.reset_counts()
    a = episodes(reg, S.TorchSampler(8, device), p, device)
    b = episodes(reg, S.TorchSampler(9, device), p, device)
    assert regulator_counts() == {"regulator.capture": 2,
                                  "regulator.replay": 8,
                                  "regulator.uncaptured": 2}
    assert_bit_equal(a, episodes(reg.uncaptured, S.TorchSampler(8, device), p,
                                 device))
    assert_bit_equal(b, episodes(reg.uncaptured, S.TorchSampler(9, device), p,
                                 device))
    assert not np.array_equal(a[0][1], b[0][1])


@pytest.mark.cuda
def test_tracing_op_set_stays_uncaptured(secure_card):
    """An op set that traces (records each op's result) runs every step
    uncaptured, and traces each of them."""
    from hectr_tpu_torch.ckks.scheme_ops import SchemeOps

    ctx, keys, rk, device = secure_card
    ops = SchemeOps(ctx)
    ops.trace = []
    reg = make_hempc_regulator(ctx, keys, rk, *cli.cstr_setup(), HORIZON,
                               ops=ops)
    pmu.reset_counts()
    got = episodes(reg, S.TorchSampler(10, device), disturbances(1, 2), device)
    assert regulator_counts() == {"regulator.uncaptured": 2}
    per_step = len(ops.trace) // 2
    assert per_step > 0 and len(ops.trace) == 2 * per_step
    ops.trace = None
    assert_bit_equal(got, episodes(reg.uncaptured, S.TorchSampler(10, device),
                                   disturbances(1, 2), device))


@pytest.mark.cuda
def test_flagship_qp_replayed_bit_equal_uncaptured():
    """The constrained FLAGSHIP_QP regulator (the encrypted PGD QP inside
    the captured step), two episodes at one plant of the constrained
    loop's own length (``bench.batch.QP_STEPS``: past some 15 steps of
    its +10% inlet step the plaintext mirror leaves the clip's certified
    domain): bit-equal to the uncaptured step, counted as one capture and
    2 QP_STEPS - 1 replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    from hectr_tpu_torch.bench import batch as BB

    device = torch.device("cuda", torch.cuda.current_device())
    model, plant = cli.cstr_setup()
    p = np.stack([BB.qp_disturbance(plant, BB.QP_STEPS, s)
                  for s in (1.0, 0.7)])
    B0 = max(BB.qp_envelope(model, plant, pe)[0] for pe in p)
    reg = BB.qp_regulator(device, model, plant, B0)
    got, want, counts, after, want_launches = replayed_against_uncaptured(
        reg, p, device)
    assert_bit_equal(got, want)
    assert counts == {"regulator.capture": 1,
                      "regulator.replay": 2 * BB.QP_STEPS - 1,
                      "regulator.uncaptured": 1}
    assert after == want_launches
