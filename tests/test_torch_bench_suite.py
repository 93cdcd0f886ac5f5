"""The bench entry point (``hectr_tpu_torch.bench.suite``) on the CPU:
its sections are ``bench.py``'s, it refuses what it does not know and
runs only on the card; the serving protocol's law check; and the two
relinearisation-key layouts its compact_key_tradeoff section compares
give the same products.  The sections themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py's phase "suite")."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from hectr_tpu_torch import cli
from hectr_tpu_torch.bench import batch as BB
from hectr_tpu_torch.bench import suite
from hectr_tpu_torch.ckks import keyswitch as K
from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.ckks.context import make_context
from hectr_tpu_torch.config import CKKSPreset
from hectr_tpu_torch.control.simulate import make_mpc_regulator
from hectr_tpu_torch.hempc.qp_enc import make_pgd_mirror_regulator

CPU = torch.device("cpu")
BENCH_PY = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
# bench.py's names the suite leaves out (a TPU compile shape, see the
# suite's docstring) or renames (there is no Pallas here)
LEFT_OUT = {"hempc_step_logn15_L20_fused_mono"}
RENAMED = {"pallas_parity": "kernel_parity"}


def bench_py_sections() -> list[str]:
    """The names of bench.py's `sections` list and of its `extra_surface`
    list (the standalone scripts' results), read from its source."""
    tree = ast.parse(BENCH_PY.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    lists = {}
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("sections", "extra_surface")
                and isinstance(node.value, ast.List)):
            lists[node.targets[0].id] = [
                (e.elts[0] if isinstance(e, ast.Tuple) else e).value
                for e in node.value.elts]
    return lists["sections"] + lists["extra_surface"]


def test_sections_are_bench_pys():
    names = bench_py_sections()
    assert len(names) == 19 and "pallas_parity" in names
    want = [RENAMED.get(n, n) for n in names if n not in LEFT_OUT]
    assert list(suite.SECTIONS) == want + ["hempc_qp_batch_logn15"]
    for fn, unit, gate in suite.SECTIONS.values():
        assert callable(fn) and unit and gate
    for name in LEFT_OUT:
        assert name in suite.__doc__


@pytest.mark.parametrize("arg", ["nope", "ntt_logn15,pallas_parity", ","])
def test_unknown_section_is_refused(arg, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit) as e:
        suite.main(["--sections", arg])
    assert e.value.code == 2
    assert "unknown sections" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], ["--sections", "kernel_parity"]])
def test_suite_raises_without_cuda(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        suite.main(argv)
    assert suite.parse(argv) == (list(suite.SECTIONS) if not argv
                                 else ["kernel_parity"])


@pytest.mark.parametrize("batch", [(), (3,)])
def test_stored_and_compact_relin_keys_bit_equal(batch):
    """compact_key_tradeoff's claim at logN=8: from the same draws the
    compact relinearisation key is the stored key without its Shoup
    companions (half the bytes), and mul_ct + rescale_pair through
    either gives the same residues."""
    ctx = make_context(CKKSPreset(name="suite-ks", logn=8, slots=16,
                                  scale_bits=50, limb_bits=25, mult_depth=5,
                                  special_limbs=2, digit_width=2))
    keys = S.keygen(ctx, S.TorchSampler(0, CPU), CPU)
    stored = K.gen_relin_key(ctx, keys, S.TorchSampler(1, CPU))
    compact = K.gen_relin_key(ctx, keys, S.TorchSampler(1, CPU), compact=True)
    assert torch.equal(compact, stored[:, :2])
    assert 2 * K._key_bytes(ctx, True) == K._key_bytes(ctx) == \
        stored.numel() * 8
    rng = np.random.default_rng(4)
    k = ctx.max_limbs
    v = torch.from_numpy(rng.uniform(-1, 1, (*batch, ctx.slots)))
    w = torch.from_numpy(rng.uniform(-1, 1, ctx.slots))
    enc = S.TorchSampler(3, CPU)
    a = S.encrypt(ctx, keys, S.encode(ctx, (v, torch.zeros_like(v)), k), enc)
    b = S.encrypt(ctx, keys, S.encode(ctx, (w, torch.zeros_like(w)), k), enc)
    out = [S.rescale_pair(ctx, K.mul_ct(ctx, a, b, key)) for key in
           (stored, compact)]
    assert torch.equal(out[0].data, out[1].data)
    re, _ = S.decode_ri(ctx, S.decrypt(ctx, keys, out[1]))
    assert float((re - v * w).abs().max()) < 1e-6


@pytest.mark.parametrize("kind", ["law", "mirror"])
def test_law_error_reads_every_step(kind):
    """bench.batch.law_error evaluates the law on the loop's own inputs:
    zero for the law's (the mirror's) own rounds over 3 loops, each step
    fed the u before it, and the distance of a perturbed step found."""
    model, plant = cli.cstr_setup()
    law = (make_mpc_regulator(model, plant, BB.HORIZON, CPU) if kind == "law"
           else make_pgd_mirror_regulator(model, plant, BB.HORIZON,
                                          BB.qp_bounds(), CPU, iters=2,
                                          degree=7, input_bound=7.0))
    xs, u0 = BB.protocol_inputs(3, 4, CPU)
    us, _ = BB.run_rounds(law, None, xs, u0, 2)
    assert us.shape == (2, 3, 4, 2)
    assert BB.law_error(law, xs, u0, us) == 0.0
    us[1, 2, 3, 0] += 1e-3
    assert BB.law_error(law, xs, u0, us) == pytest.approx(1e-3, rel=1e-6)


def test_qp_box_and_activity():
    u = np.zeros((2, 4, 2))
    u[0, 1:, 0] = [0.25, 0.5, 0.5]
    u[1, 1:, 1] = 0.004
    assert BB.qp_box_ok(u) and BB.qp_activity(u[0]) == 1.0
    u[1, 2, 1] = 0.0090
    assert not BB.qp_box_ok(u)
