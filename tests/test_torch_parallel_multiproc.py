"""The process meshes run for real on the CPU (2 and 4 gloo ranks on the
coefficient axis, limb meshes of 2 and 3 ranks and pod meshes of 2 x 2 x
1 and 1 x 2 x 2 through ``hectr_tpu_torch.bench.run_multiproc``: each
rank asserts its own shard bit-equal to the single-device port, which
the other test files hold bit-equal to the JAX package),
``init_distributed`` and ``make_pod_mesh``, the ``scaling`` subcommand
and the entry points.

Every group takes a free port from the OS and every launch has a time
limit of its own, after which its ranks are killed.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from hectr_tpu.ckks import ntt as JN
from hectr_tpu_torch import cli, entry
from hectr_tpu_torch.bench import run_multiproc
from hectr_tpu_torch.ckks import ntt as TN
from hectr_tpu_torch.ckks.primes import find_ntt_primes
from hectr_tpu_torch.config import CKKSPreset
from hectr_tpu_torch.parallel import ProcessLimbMesh, ProcessMesh
from hectr_tpu_torch.parallel import multihost
from hectr_tpu_torch.parallel.ntt_shard import (
    local_ntt_fns,
    ppermute_bytes_per_transform,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
REPORT_FIELDS = {"logn", "limbs", "devices", "single_dev_ntt_per_s",
                 "sharded_ntt_per_s", "speedup", "efficiency",
                 "ppermute_bytes_per_transform"}


@pytest.mark.parametrize("ranks", [2, 4])
def test_process_mesh_bit_equal_on_every_rank(ranks):
    """NTT and round trip at logN = 10, then negacyclic_mul, rescale_pair,
    rotate and the hoisted gemv at REFERENCE_HEMPC, one shard per gloo
    rank."""
    rec = run_multiproc.launch(ranks, "cpu", 10, 4, "reference-hempc", 240.0)
    assert rec["ok"] and rec["bitexact_per_shard"] and rec["ranks"] == ranks
    assert rec["backend"] == "gloo" and rec["device"] == "cpu"
    assert rec["mesh"] == f"process mesh, gloo, {ranks} ranks, rank 0 on cpu"
    assert rec["exchange_bytes"] == 4 * (1024 // ranks) * 4     # int32 wire
    assert len(rec["exchange_gb_per_s"]) == ranks


@pytest.mark.parametrize("ranks,batch,limb", [
    (2, 1, 2),      # a limb mesh over 2 ranks
    (3, 1, 3),      # 3 ranks: uneven rows, a world that is no power of two
    (4, 2, 2),      # make_pod_mesh(2, 2, 1): the batch x limb step
    (4, 1, 2),      # make_pod_mesh(1, 2, 2): limb and coefficient subgroups
])
def test_pod_mesh_bit_equal_on_every_rank(ranks, batch, limb):
    """One closed-loop step of the REFERENCE_HEMPC regulator on each
    rank's limb subgroup, x_next, u and every ciphertext bit-equal on its
    rows to the unsharded step (``entry.limb_step``); with a coefficient
    axis of 2, the sharded NTT and scheme ops on each coefficient
    subgroup too."""
    rec = run_multiproc.launch(ranks, "cpu", 10, 4, "reference-hempc", 240.0,
                               batch=batch, limb=limb)
    assert rec["ok"] and rec["bitexact_per_shard"] and rec["ranks"] == ranks
    coeff = ranks // (batch * limb)
    assert rec["pod"].startswith(
        f"{{'batch': {batch}, 'limb': {limb}, 'coeff': {coeff}}}: process "
        f"limb mesh, gloo, {limb} ranks, rank 0 on cpu")
    steps = rec["limb_steps"]
    assert len(steps) == ranks
    assert all(s["checked"] == 17 and s["loops"] == 2 for s in steps)
    assert {s["limb_mesh"] for s in steps} == {
        f"process limb mesh, gloo, {limb} ranks, rank {r} on cpu"
        for r in range(limb)}
    # the shards of one key add up to the whole (6 BSGS keys, 4 + 1 rows)
    key = 4 * 4 * 5 * 4096 * 8
    assert sum(s["key_block_bytes"] for s in steps) == 6 * key * batch * coeff
    # device memory is read on a card only
    assert all(s[f] is None for s in steps
               for f in ("held_bytes", "step_peak_bytes", "check_peak_bytes"))
    # every rank of a batch group computed the same loops
    for g in range(batch):
        group = [s["x_next"] for s in steps[g * limb * coeff:
                                            (g + 1) * limb * coeff]]
        assert all(x == group[0] for x in group)
    if batch > 1:
        assert steps[0]["x_next"] != steps[-1]["x_next"]
    assert ("mesh" in rec) == (coeff > 1)
    with pytest.raises(ValueError, match="do not split"):
        run_multiproc.launch(3, "cpu", 10, 4, "reference-hempc", 60.0,
                             batch=2, limb=1)


def test_a_failing_rank_fails_the_run():
    """Chunks of one coefficient: every rank raises, the launcher reports
    it with the ranks' output and leaves no child behind."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="need at least 2"):
        run_multiproc.launch(4, "cpu", 2, 1, "reference-hempc", 120.0)
    assert time.monotonic() - t0 < 120.0


def test_init_distributed_without_coordinator(monkeypatch):
    monkeypatch.delenv("HECTR_COORDINATOR", raising=False)
    assert multihost.init_distributed() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("device,cards,nccl,ranks,want", [
    ("cpu", 4, True, 4, "gloo"),      # a card per rank, but CPU tensors
    ("cuda", 4, True, 4, "nccl"),
    ("cuda:1", 4, True, 2, "nccl"),
    ("cuda", 1, True, 2, "gloo"),     # ranks sharing one card
    ("cuda", 4, False, 4, "gloo"),
    ("cpu", 0, False, 2, "gloo"),
])
def test_backend_follows_device_and_cards(monkeypatch, device, cards, nccl,
                                          ranks, want):
    """What ``init_distributed`` hands ``init_process_group``, on a host
    with `cards` cards: NCCL only for CUDA tensors with a card per rank."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: nccl)
    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    assert multihost.init_distributed("127.0.0.1:1", ranks, 1, device) is True
    assert seen == [(want, {"init_method": "tcp://127.0.0.1:1",
                            "world_size": ranks, "rank": 1})]


def test_single_rank_group_in_process(monkeypatch):
    """The environment's names, a second call, and a process mesh of one
    rank: its transform is the single-device one, bit-equal to the JAX
    package's."""
    monkeypatch.setenv("HECTR_COORDINATOR",
                       f"127.0.0.1:{run_multiproc.free_port()}")
    monkeypatch.setenv("HECTR_NUM_PROCS", "1")
    monkeypatch.setenv("HECTR_PROC_ID", "0")
    try:
        assert multihost.init_distributed(device=CPU) is True
        assert multihost.init_distributed(device=CPU) is True   # twice: no error
        assert dist.get_backend() == "gloo"
        pod = multihost.make_pod_mesh(device=CPU)
        assert dict(pod.shape) == {"batch": 1, "limb": 1, "coeff": 1}
        assert pod.batch_index == 0 and pod.device == CPU
        assert isinstance(pod.limb, ProcessLimbMesh) and pod.limb.size == 1
        mesh = pod.coeff
        assert isinstance(mesh, ProcessMesh)
        assert (mesh.size, mesh.rank, mesh.shards) == (1, 0, (0,))
        with pytest.raises(ValueError):
            multihost.make_pod_mesh(batch=2, device=CPU)
        assert mesh.describe(CPU) == "process mesh, gloo, 1 ranks, rank 0 on cpu"
        n = 1 << 8
        primes = tuple(find_ntt_primes(30, 3, 2 * n))
        a = np.random.default_rng(0).integers(
            0, np.array(primes).reshape(-1, 1), size=(3, n))
        t = TN.ntt_tables(n, primes, CPU)
        fwd, inv = local_ntt_fns(t, mesh)
        x = mesh.shard(torch.from_numpy(a))
        assert x.shape == (3, 1, n)
        got = fwd(x)
        jt = JN.build_ntt_tables(n, primes)
        want = np.asarray(jax.jit(lambda v: JN.ntt(v, jt))(
            a.astype(np.uint32)))
        assert np.array_equal(mesh.gather(got).numpy().astype(np.uint32), want)
        assert torch.equal(inv(got), x)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_scaling_efficiency_report():
    from hectr_tpu_torch.parallel import LocalMesh

    rep = multihost.ntt_scaling_efficiency(8, 3, LocalMesh(4), CPU, iters=2)
    assert REPORT_FIELDS <= set(rep)
    assert (rep["logn"], rep["limbs"], rep["devices"]) == (8, 3, 4)
    assert rep["single_dev_ntt_per_s"] > 0 and rep["sharded_ntt_per_s"] > 0
    assert rep["efficiency"] == rep["speedup"] / 4
    assert rep["ppermute_bytes_per_transform"] == \
        ppermute_bytes_per_transform(256, 3, 4) == 2 * 64 * 4 * 3
    assert rep["mesh"] == "local mesh, 4 shards on cpu"


def test_cli_scaling_prints_one_json_line(capsys, monkeypatch, tmp_path):
    monkeypatch.delenv("HECTR_COORDINATOR", raising=False)
    cli.main(["scaling", "--device", "cpu", "--logn", "8", "--depth", "2",
              "--out-dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert REPORT_FIELDS <= set(rep)
    assert (rep["logn"], rep["limbs"], rep["devices"]) == (8, 6, 2)


def test_dryrun_multichip_on_a_small_ring(capsys):
    """Sections (a)-(d) over 4 shards on the CPU, the large ring cut to
    logN = 9 (two specials, width-2 digits, as FLAGSHIP)."""
    small = CKKSPreset(name="dryrun-test", logn=9, slots=16, scale_bits=50,
                       limb_bits=25, mult_depth=2, special_limbs=2,
                       digit_width=2)
    rec = entry.dryrun_multichip(4, "cpu", small)
    out = capsys.readouterr().out
    assert "bit-exact @ logN=9 x 6 limbs" in out
    line = [x for x in out.splitlines() if x.startswith("MULTICHIP_SCALING ")]
    assert len(line) == 1
    assert json.loads(line[0][len("MULTICHIP_SCALING "):]) == rec
    assert rec["mode"] == "local-mesh" and rec["device"] == "cpu"
    assert set(rec["chain_ntt_per_s"]) == {"1dev", "2dev", "4dev"}
    assert rec["ppermute_bytes_per_transform"] == \
        ppermute_bytes_per_transform(512, 6, 4)
    assert rec["link_prediction"]["limbs"] == 6
    assert "published, not measured" in rec["link"]
    with pytest.raises(ValueError):
        entry.dryrun_multichip(1, "cpu", small)


def test_entry_runs_one_regulator_step():
    fn, args = entry.entry("cpu")
    u = fn(*args)
    assert u.shape == (2,) and u.dtype == torch.float64
    # zero state, zero targets: the move is zero up to the CKKS noise
    assert float(u.abs().max()) < 1e-8
