"""The CSTR closed loop's own stages as one launch of K13 a step
(``ops.stages_cuda``, ``control.simulate`` ``StageKernel``).

On the CPU: which path the loop's stages take (K13 for the CSTR plant on
a card, the stage graph for any other plant there, the plain stages on
the CPU); the constant buffer's packing against the ``Stages``' tensors;
the wrapper's refusals of what K13 does not take; and the kernel path's
counts, packing and outputs with a stand-in for the launch, bit-equal to
the uncaptured loop.  On the card (marked ``cuda``; they skip
elsewhere): K13 against the uncaptured stages at one plant, 4 and 1,024,
every mode; whole episodes through K13 against the uncaptured card loop
with the plaintext and the encrypted regulator, one launch a step; and a
plant K13 does not take still through the stage graph.  The file imports
neither jax nor the JAX package, so it runs where the card is:

    python -m pytest tests/test_torch_loop_kernel.py --noconftest -o addopts="" -q
"""

import types

import numpy as np
import pytest
import torch

from hectr_tpu_torch import cli
from hectr_tpu_torch.bench import stages_kernels as SK
from hectr_tpu_torch.control import simulate as sim
from hectr_tpu_torch.control.plants import cstr
from hectr_tpu_torch.control.stages import actuate
from hectr_tpu_torch.ops import stages_cuda as K
from hectr_tpu_torch.utils import pmu
from loop_cases import (CPU, assert_bit_equal, card,  # noqa: F401
                        disturbances, episodes, graph_setup, loop_counts,
                        regulator_and_sampler, secure, shifted_setup,
                        wrapped_ode)

CUDA = torch.device("cuda", 0)


# ---- which path the stages take --------------------------------------------


def wrapped_jacobian(x, u, p):
    return cstr.cstr_jacobian(x, u, p)


@pytest.mark.parametrize("plant, device, path", [
    ("cstr", CUDA, "kernel"),
    ("wrapped ode", CUDA, "graph"),
    ("wrapped jacobian", CUDA, "graph"),
    ("cstr", CPU, "plain"),
])
def test_stages_path_by_plant_identity_and_device(plant, device, path):
    """On a card, the CSTR plant (its right-hand side and Jacobian by
    identity) takes K13 and any other plant the stage graph; on the CPU
    the stages run plain.  Nothing is built to decide it."""
    _, p = cli.cstr_setup()
    if plant == "wrapped ode":
        p = sim.Plant(ode=wrapped_ode, jacobian=p.jacobian, xs=p.xs,
                      us=p.us, ps=p.ps)
    elif plant == "wrapped jacobian":
        p = sim.Plant(ode=p.ode, jacobian=wrapped_jacobian, xs=p.xs,
                      us=p.us, ps=p.ps)
    runner = sim._runner(p, device)
    assert runner is {"kernel": sim._KERNEL, "graph": sim._GRAPH,
                      "plain": None}[path]


# ---- the constant buffer ----------------------------------------------------


def unpack(consts: K.Constants, name: str, shape: tuple) -> torch.Tensor:
    off = K.LAYOUT[name]
    if len(shape) == 1:
        return consts.buffer[off:off + shape[0]]
    stride = 5 if name == "Ginv" else K.ROW
    return consts.buffer[off:off + shape[0] * stride].view(
        shape[0], stride)[:, :shape[1]]


def shapes_of(ny: int, nd: int) -> dict:
    return {"A": (3, 3), "B": (3, 2), "C": (ny, 3), "Bd": (3, nd),
            "Cd": (ny, nd), "Hr": (2, ny), "Lx": (3, ny), "Ld": (nd, ny),
            "Ginv": (5, 5), "xs": (3,), "us": (2,), "ps": (1,)}


def random_stages(ny: int, nd: int, seed: int = 0, **replace):
    """A stand-in for ``Stages`` with random constants of K13's shapes
    (nonzero, so a misplaced word shows), `replace` overriding any."""
    rng = np.random.default_rng(seed)
    tensors = {name: torch.from_numpy(rng.uniform(0.5, 1.5, shape))
               for name, shape in shapes_of(ny, nd).items()}
    tensors.update(replace)
    return types.SimpleNamespace(**tensors, dt=0.75)


def assert_packed(consts: K.Constants, stages, ny: int, nd: int) -> None:
    used = torch.zeros(K.WORDS, dtype=torch.bool)
    for name, shape in shapes_of(ny, nd).items():
        assert torch.equal(unpack(consts, name, shape), getattr(stages, name))
        unpack(types.SimpleNamespace(buffer=used), name, shape).fill_(True)
    scalars = cstr.cstr_scalars()
    off = K.LAYOUT["plant"]
    assert consts.buffer[off:off + len(K.PLANT) + 1].tolist() == [
        scalars[k] for k in K.PLANT] + [stages.dt / 2]
    used[off:off + len(K.PLANT) + 1] = True
    # every other word zero
    assert not consts.buffer[~used].any()
    assert (consts.ny, consts.nd) == (ny, nd)
    assert consts.widths == [3, 3, nd, 3, 2]


@pytest.mark.parametrize("ny, nd", [(3, 0), (3, 1), (3, 2), (3, 3), (1, 2)])
def test_packing_against_random_constants(ny, nd):
    """Every constant at its offset and row stride (LAYOUT, the kernel's),
    the plant's scalars after them, every other word zero."""
    stages = random_stages(ny, nd)
    consts = K.pack(stages, cstr.cstr_scalars())
    assert consts.buffer.dtype == torch.float64
    assert consts.buffer.shape == (K.WORDS,)
    assert_packed(consts, stages, ny, nd)


def test_packing_of_the_cstr_loops_stages():
    """The CSTR loop's own ``Stages`` (its model, gains and steady state
    at dt = 1) packed bit for bit, and the plant's scalars what
    ``cstr_ode`` computes with: its third row (F0 - F) / S and the
    Arrhenius factor K0 exp(-E/R / T) from them to an ulp."""
    model, plant = cli.cstr_setup()
    stages = sim.Stages(model, plant, 1.0, CPU)
    consts = K.pack(stages, cstr.cstr_scalars())
    assert_packed(consts, stages, 3, 2)
    q = cstr.cstr_scalars()
    assert float(consts.buffer[K.LAYOUT["plant"] + len(K.PLANT)]) == 0.5
    x = torch.tensor([0.9, 330.0, 0.7], dtype=torch.float64)
    u = torch.tensor([301.0, 0.105], dtype=torch.float64)
    p = torch.tensor([0.11], dtype=torch.float64)
    f = cstr.cstr_ode(x, u, p)
    np.testing.assert_allclose(float(f[2]), (0.11 - 0.105) * q["inv_S"],
                               rtol=1e-15)
    kT = q["K0"] * np.exp((1.0 / 330.0) * q["neg_E"])
    J = cstr.cstr_jacobian(x, u, p)
    np.testing.assert_allclose(float(J[1, 0]), q["heat"] * kT, rtol=1e-15)


# ---- the wrapper's refusals -------------------------------------------------


def cpu_constants():
    model, plant = cli.cstr_setup()
    return K.pack(sim.Stages(model, plant, 1.0, CPU), cstr.cstr_scalars())


@pytest.mark.parametrize("replace, error", [
    ({"A": torch.ones(4, 4, dtype=torch.float64)}, ValueError),      # nx 4
    ({"B": torch.ones(3, 3, dtype=torch.float64)}, ValueError),      # nu 3
    ({"ps": torch.ones(2, dtype=torch.float64)}, ValueError),        # np 2
    ({"C": torch.ones(4, 3, dtype=torch.float64)}, ValueError),      # ny 4
    ({"Bd": torch.ones(3, 4, dtype=torch.float64)}, ValueError),     # nd 4
    ({"Bd": torch.tensor(float("nan"), dtype=torch.float64)}, ValueError),
    ({"Ginv": torch.ones(5, 5, dtype=torch.float32)}, TypeError),
])
def test_pack_refuses_models_k13_does_not_take(replace, error):
    """Another plant's state, move or disturbance width, more than three
    outputs or disturbances, a model without Bd (``_f64(None)``, a 0-d
    NaN) and a non-float64 constant: refused before anything is built."""
    with pytest.raises(error):
        K.pack(random_stages(3, 2, **replace), cstr.cstr_scalars())


def step_operands(rows=(2,)):
    f = dict(dtype=torch.float64)
    return dict(x=torch.zeros(*rows, 3, **f), u=torch.zeros(*rows, 2, **f),
                p=torch.zeros(*rows, 1, **f),
                xhat=torch.zeros(*rows, 3, **f),
                dhat=torch.zeros(*rows, 2, **f),
                rsp=torch.zeros(*rows, 2, **f))


@pytest.mark.parametrize("change, error, match", [
    ({"x": torch.zeros(2, 3, dtype=torch.float32)}, TypeError, "float64"),
    ({"dhat": torch.zeros(2, 2, dtype=torch.int64)}, TypeError, "float64"),
    ({"x": torch.zeros(2, 4, dtype=torch.float64)}, ValueError, "rows of 3"),
    ({"u": torch.zeros(2, 3, dtype=torch.float64)}, ValueError, "rows of 2"),
    ({"dhat": torch.zeros(2, 3, dtype=torch.float64)}, ValueError,
     "rows of 2"),
    ({"p": torch.zeros(3, 1, dtype=torch.float64)}, ValueError, "has rows"),
    ({"x": torch.zeros(2, 6, dtype=torch.float64)[:, ::2]}, ValueError,
     "contiguous"),
    ({"rsp": torch.zeros(2, 2, dtype=torch.float64).t()}, ValueError,
     "contiguous"),
    ({"mode": 3}, ValueError, "no mode"),
])
def test_loop_stages_refuses_what_k13_does_not_take(change, error, match):
    """Another dtype, another row width, rows that do not match x's, a
    row whose words are not contiguous, an unknown mode: refused before
    the library is built."""
    ops = step_operands()
    mode = change.pop("mode", K.STEP_OBSERVE)
    ops.update(change)
    with pytest.raises(error, match=match):
        K.loop_stages(cpu_constants(), mode=mode, **ops)


def test_loop_stages_refuses_rows_at_several_strides():
    """x [2, 3, 3] cut from [2, 4, 3]: its six rows lie at two strides."""
    ops = step_operands((2, 3))
    ops["x"] = torch.zeros(2, 4, 3, dtype=torch.float64)[:, :3]
    with pytest.raises(ValueError, match="several strides"):
        K.loop_stages(cpu_constants(), mode=K.STEP_OBSERVE, **ops)


def test_loop_stages_refuses_tensors_off_the_card():
    """Operands and constants on the CPU: refused, and nothing launched."""
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="cpu"):
        K.loop_stages(cpu_constants(), mode=K.STEP_OBSERVE, **step_operands())
    assert K.LAUNCHES == before


def test_loop_stages_reads_rows_at_their_strides(monkeypatch):
    """The strides the launch is given: p_seq[..., k, :]'s rows N words
    apart, views of one [B, 13] output 13 apart, a one-row rsp 0 (it is
    broadcast), a merged [2, 2] batch as one stride; the output one new
    [*lead, 13] tensor split into (x, xhat, dhat, xr, ur)."""
    seen = []
    monkeypatch.setattr(K, "_launch", lambda consts, out, tensors, strides,
                        rows, mode: seen.append((out, strides, rows, mode)))
    f = dict(dtype=torch.float64)
    prev = torch.zeros(4, 13, **f)
    x, xhat, dhat = prev[:, :3], prev[:, 3:6], prev[:, 6:8]
    p = torch.zeros(4, 40, 1, **f)[:, 7]
    parts = K.loop_stages(cpu_constants(), x, torch.zeros(4, 2, **f), p, xhat,
                          dhat, torch.zeros(2, **f), K.STEP_OBSERVE)
    out, strides, rows, mode = seen[-1]
    assert strides == [13, 2, 40, 13, 13, 0] and rows == 4
    assert mode == K.STEP_OBSERVE
    assert out.shape == (4, 13) and out.is_contiguous()
    assert [t.shape[-1] for t in parts] == [3, 3, 2, 3, 2]
    assert all(t.data_ptr() == out.data_ptr() + 8 * off for t, off in
               zip(parts, (0, 3, 6, 8, 11)))
    grid = torch.zeros(2, 2, 13, **f)
    K.loop_stages(cpu_constants(), grid[..., :3], None, None, grid[..., 3:6],
                  grid[..., 6:8], torch.zeros(2, 2, 2, **f), K.OBSERVE)
    out, strides, rows, mode = seen[-1]
    assert strides == [13, 0, 0, 13, 13, 2] and rows == 4
    assert out.shape == (2, 2, 13)


# ---- the kernel path, with a stand-in for the launch ------------------------


def test_stage_kernel_bookkeeping_with_a_stand_in_launch(monkeypatch):
    """``StageKernel`` on the CPU with the launch replaced by the plain
    stages on the operands it is given: one ``loop.kernel`` a step and
    one ``loop.observe`` an episode, no graph; the constants packed once
    for a model and plant built anew with the same values and again for
    other values; the modes an episode asks for (observe, step and
    observe, a last plain step); every episode bit-equal to the
    uncaptured loop; each call's outputs views of one new tensor."""
    holder = sim.StageKernel()
    monkeypatch.setattr(sim, "_KERNEL", holder)
    runs = [(disturbances(2, 3), cli.cstr_setup),
            (disturbances(1, 4), cli.cstr_setup),
            (disturbances(1, 3, (2,)), cli.cstr_setup),
            (disturbances(1, 2, (2,)), shifted_setup)]
    want = [episodes(p, CPU, setup=setup) for p, setup in runs]

    modes, outs = [], []

    def stand_in(consts, out, tensors, strides, rows, mode):
        assert consts is holder.packed
        x, u, p, xhat, dhat, rsp = tensors
        stages = holder.constants
        if mode == K.OBSERVE:
            parts = (x, *stages.observe(x, xhat, dhat, rsp, 0))
        elif mode == K.STEP_OBSERVE:
            parts = stages.step(x, u, p, xhat, dhat, rsp, 0, True)
        else:
            parts = (actuate(stages.plant.ode, stages.plant.jacobian, x, u, p,
                             stages.xs, stages.us, stages.ps, stages.dt),)
        out[..., :sum(t.shape[-1] for t in parts)] = torch.cat(parts, -1)
        modes.append(mode)
        outs.append(out)

    monkeypatch.setattr(sim, "_runner", lambda plant, device: sim._KERNEL)
    monkeypatch.setattr(K, "_launch", stand_in)
    pmu.reset_counts()
    got, packed = [], []
    for p, setup in runs:
        got.append(episodes(p, CPU, setup=setup))
        packed.append(holder.packed)
    steps = 2 * 3 + 4 + 3 + 2
    assert loop_counts() == {"loop.kernel": steps, "loop.observe": 5}
    assert packed[0] is packed[1] is packed[2] is not packed[3]
    episode = [[K.OBSERVE] + [K.STEP_OBSERVE] * (n - 1) + [K.STEP]
               for n in (3, 3, 4, 3, 2)]
    assert modes == sum(episode, [])
    assert len({o.data_ptr() for o in outs}) == len(outs)
    for a, b in zip(got, want):
        assert_bit_equal(a, b)
    pmu.reset_counts()


# ---- on the card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(), (4,), (1024,)])
@pytest.mark.parametrize("mode", ["step", "step_observe", "observe"])
def test_kernel_against_uncaptured_stages(card, rows, mode):
    """K13 against ``Stages.step`` (and ``.observe``) run uncaptured on the
    card, at one plant, 4 and 1,024, on states around the steady state
    (``bench.stages_kernels.inputs``): every output within 1e-13 of its
    unit (xs, us); one launch."""
    model, plant = cli.cstr_setup()
    stages = sim.Stages(model, plant, 1.0, card)
    consts = K.pack(stages, cstr.cstr_scalars())
    ops = SK.inputs(rows, card, seed=len(rows) * 10 + len(mode))
    before = K.LAUNCHES["loop_stages"]
    got, want = SK.against_plain(consts, stages, ops, SK.MODES[mode])
    torch.cuda.synchronize()
    assert K.LAUNCHES["loop_stages"] == before + 1
    assert [g.shape for g in got] == [w.shape for w in want]
    gap = SK.gap(got, want, plant, model)
    assert gap <= 1e-13, gap


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [(), (64,)])
@pytest.mark.parametrize("kind", ["plaintext", "encrypted"])
def test_kernel_episodes_against_the_uncaptured_card_loop(card, request,
                                                          monkeypatch, kind,
                                                          batch):
    """Two 40-step episodes, one plant and 64, with the plaintext and the
    encrypted regulator: each channel of x and u through K13 within 1e-12
    of its xs / us of the same episodes with the stages uncaptured on the
    card, canaries
    below 1e-5; one ``loop.kernel`` and one K13 launch a step, one
    ``loop.observe`` an episode, no graph."""
    reg, sampler = regulator_and_sampler(kind, request, card)
    _, plant = cli.cstr_setup()
    p = disturbances(2, 40, batch)
    monkeypatch.setattr(sim, "_KERNEL", sim.StageKernel())
    pmu.reset_counts()
    before = K.LAUNCHES["loop_stages"]
    got = episodes(p, card, reg, sampler())
    torch.cuda.synchronize()
    counts = loop_counts()
    launches = K.LAUNCHES["loop_stages"] - before
    with monkeypatch.context() as m:
        m.setattr(sim, "_runner", lambda plant, device: None)
        want = episodes(p, card, reg, sampler())
    assert counts == {"loop.kernel": 80, "loop.observe": 2}
    assert launches == 82
    for (x, u, c), (x1, u1, _) in zip(got, want):
        assert (np.abs(x - x1) / np.abs(plant.xs)).max() <= 1e-12
        assert (np.abs(u - u1) / np.abs(plant.us)).max() <= 1e-12
        assert c is None or float(c.max()) < 1e-5
    pmu.reset_counts()


@pytest.mark.cuda
def test_a_plant_k13_does_not_take_keeps_the_stage_graph(card, monkeypatch):
    """The CSTR with its right-hand side wrapped, five steps: on the card
    its stages run once uncaptured, are captured, then replayed four
    times, and K13 never launches."""
    monkeypatch.setattr(sim, "_GRAPH", sim.StageGraph())
    pmu.reset_counts()
    before = K.LAUNCHES["loop_stages"]
    episodes(disturbances(1, 5), card, setup=graph_setup)
    assert loop_counts() == {"loop.uncaptured": 1, "loop.capture": 1,
                             "loop.replay": 4}
    assert K.LAUNCHES["loop_stages"] == before
    pmu.reset_counts()
