"""The port's spans (``hectr_tpu_torch.utils.pmu``): off with nothing
listening, the same top-level scheme-op ranges on both op sets, the
recording's self time, ``by_span``'s reduction of a trace and the
kernel filters that drop the ranges' device-side mirrors.  CPU only; no
JAX."""

import contextlib
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent
from torch.profiler import ProfilerActivity, profile

from hectr_tpu_torch import cli
from hectr_tpu_torch.bench import batch as BB
from hectr_tpu_torch.bench import profile_step as PS
from hectr_tpu_torch.ckks.gemv import bsgs_rotations
from hectr_tpu_torch.ckks.scheme import TorchSampler
from hectr_tpu_torch.ckks.scheme_ops import SchemeOps
from hectr_tpu_torch.config import CKKSPreset
from hectr_tpu_torch.control.simulate import simulate_batch
from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
from hectr_tpu_torch.parallel import make_mesh
from hectr_tpu_torch.parallel.limb_ops import LimbOps
from hectr_tpu_torch.utils import pmu

CPU = torch.device("cpu")
PRESET = CKKSPreset(name="pmu-test", logn=8, slots=16, scale_bits=50,
                    limb_bits=25, mult_depth=1)


@pytest.fixture
def ranges_opened(monkeypatch):
    """Counts the ``record_function`` ranges the spans open."""
    opened = []

    def fake(name, args=None):
        opened.append((name, args))
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", fake)
    return opened


def test_span_off_enters_no_range_and_records_nothing(ranges_opened):
    spanned = pmu.span("test.fn")(lambda a: a + 1)
    assert pmu.span("test.with") is pmu.span("test.with", 3)
    with pmu.span("test.with", 3):
        assert spanned(1) == 2
    assert ranges_opened == []
    with pmu.recording() as rec:
        pass
    assert rec.spans == [] and rec.table == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with pmu.span("test.with", 3):
            spanned(1)
        with pmu.muted(), pmu.span("test.muted"):
            pass
    assert ranges_opened == [("hectr.test.with", "3"),
                             ("hectr.test.fn", None)]


def _step_ranges(ops, ctx, keys, rot_keys):
    """One closed-loop step on `ops` under the profiler: (the top-level
    ``hectr.scheme.*`` ranges in order, the op set's trace)."""
    model, plant = cli.cstr_setup()
    reg = make_hempc_regulator(ctx, keys, rot_keys, model, plant, 4, ops=ops)
    ops.trace = []
    p = cli.disturbance(1)[None]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        simulate_batch(model, plant, p, 1.0, 1, CPU, reg,
                       hempc_init_state(TorchSampler(5, CPU), CPU, (1,)), 4)
    trace, ops.trace = ops.trace, None
    scheme = sorted((e.time_range.start, -e.time_range.end, e.name)
                    for e in prof.events()
                    if e.name.startswith("hectr.scheme."))
    top, end = [], -1.0
    for start, neg_end, name in scheme:
        if start >= end:            # not inside the last top-level range
            top.append(name)
            end = -neg_end
    return top, [name for name, _ in trace]


def test_scheme_ranges_line_up_on_both_op_sets():
    """The top-level scheme-op ranges of one regulator step are the same
    on ``SchemeOps`` and on ``LimbOps`` (limb mesh of 2), and they are the
    op trace that ``entry.limb_step`` lines up, then the decode."""
    ctx, keys, rot_keys = cli.hempc_keys(PRESET, 0, CPU, bsgs_rotations(16))
    single, trace = _step_ranges(SchemeOps(ctx), ctx, keys, rot_keys)
    limb, limb_trace = _step_ranges(LimbOps(ctx, make_mesh(limb=2,
                                                           device="cpu")),
                                    ctx, keys, rot_keys)
    assert single == limb and trace == limb_trace
    assert single == [f"hectr.scheme.{n}" for n in trace] + [
        "hectr.scheme.decode_ri"]
    assert trace.count("encrypt") == 4 and trace.count("gemv_apply") == 2


def test_recording_self_time_on_a_fake_clock(monkeypatch):
    ticks = iter([0, 1, 3, 6, 10, 11, 15, 20, 30, 34])
    monkeypatch.setattr(pmu, "_clock", lambda: next(ticks))
    with pmu.recording() as rec:
        with pmu.span("a", 5):          # 0 .. 20
            with pmu.span("b"):         # 1 .. 10
                with pmu.span("c"):     # 3 .. 6
                    pass
            with pmu.span("b"):         # 11 .. 15
                pass
        with pmu.span("c"):             # 30 .. 34, outside a: no step
            pass
    assert [s[:2] + s[4:] for s in rec.spans] == [
        ["a", -1, 5], ["b", 0, 5], ["c", 1, 5], ["b", 0, 5], ["c", -1, None]]
    ms = 1e-6
    assert rec.table["a"] == {"calls": 1, "total_ms": pytest.approx(20 * ms),
                              "self_ms": pytest.approx((20 - 9 - 4) * ms)}
    assert rec.table["b"] == {"calls": 2, "total_ms": pytest.approx(13 * ms),
                              "self_ms": pytest.approx(10 * ms)}
    assert rec.table["c"] == {"calls": 2, "total_ms": pytest.approx(7 * ms),
                              "self_ms": pytest.approx(7 * ms)}
    for name, row in rec.table.items():
        assert row["self_ms"] <= row["total_ms"]
    with pytest.raises(RuntimeError):
        with pmu.recording(), pmu.recording():
            pass


def _event(cid, name, start, end, device=DeviceType.CPU, annotation=False):
    return FunctionEvent(cid, name, thread=1, start_us=start, end_us=end,
                         device_type=device, is_user_annotation=annotation)


def test_by_span_on_a_synthetic_trace():
    """Innermost span wins, a device operation whose launch the trace
    lacks is unmatched, an aten op sharing an id is no launch, the ranges'
    device mirrors are no operations, and each idle gap takes the span
    open at its middle."""
    cuda = DeviceType.CUDA
    events = [
        _event(0, "hectr.loop.regulator", 0, 100),
        _event(0, "hectr.scheme.encrypt", 5, 40),
        _event(0, "hectr.loop.plant", 150, 250),
        _event(1, "cudaLaunchKernel", 10, 12),
        _event(3, "aten::mul", 6, 7),
        _event(2, "cudaLaunchKernel", 50, 52),
        _event(5, "cudaMemcpyAsync", 120, 121),
        _event(3, "cudaLaunchKernel", 160, 161),
        _event(1, "ntt_fwd_kernel", 20, 30, cuda),
        _event(2, "rns_map_kernel", 60, 70, cuda),
        _event(4, "base_convert_kernel", 80, 90, cuda),
        _event(5, "Memcpy DtoH", 130, 140, cuda),
        _event(3, "crt_decode_kernel", 200, 210, cuda),
        _event(0, "hectr.scheme.encrypt", 20, 45, cuda, annotation=True),
    ]
    got = pmu.by_span(events, steps=2)
    per = 1e-3 / 2                      # us -> ms a step over 2 steps
    assert got["by_span"] == {
        name: {"device_ms_per_step": pytest.approx(10 * per),
               "launches_per_step": 0.5,
               "top": [[op, pytest.approx(10 * per), 0.5]]}
        for name, op in (("loop.plant", "crt_decode_kernel"),
                         ("loop.regulator", "rns_map_kernel"),
                         ("none", "Memcpy DtoH"),
                         ("scheme.encrypt", "ntt_fwd_kernel"))}
    assert got["unmatched_launches_per_step"] == 0.5
    assert got["unmatched_device_ms_per_step"] == pytest.approx(10 * per)
    assert got["idle_ms_per_step"] == {
        "scheme.encrypt": pytest.approx(20 * per),
        "loop.regulator": pytest.approx(40 * per),
        "none": pytest.approx(40 * per),
        "loop.plant": pytest.approx(100 * per)}
    assert got["window_ms_per_step"] == pytest.approx(250 * per)


def test_inclusive_ms_counts_nested_spans_in_their_parents():
    """``profile_step.inclusive_ms``: a span's device time takes every
    operation launched while it was open, its nested spans' included;
    the ranges' device mirrors are neither spans nor operations, and a
    name that never opened reads 0."""
    cuda = DeviceType.CUDA
    events = [
        _event(0, "hectr.qp.pgd", 0, 100),
        _event(0, "hectr.scheme.clip", 5, 40),
        _event(0, "hectr.scheme.clip", 60, 90),
        _event(0, "hectr.loop.plant", 150, 250),
        _event(1, "cudaLaunchKernel", 10, 12),
        _event(2, "cudaLaunchKernel", 50, 52),
        _event(3, "cudaLaunchKernel", 70, 71),
        _event(4, "cudaLaunchKernel", 160, 161),
        _event(1, "ntt_fwd_kernel", 20, 30, cuda),
        _event(2, "rns_map_kernel", 60, 64, cuda),
        _event(3, "key_inner_product_kernel", 80, 100, cuda),
        _event(4, "crt_decode_kernel", 200, 210, cuda),
        _event(0, "hectr.qp.pgd", 20, 110, cuda, annotation=True),
    ]
    got = PS.inclusive_ms(events, ("qp.pgd", "scheme.clip", "loop.plant",
                                   "qp.grad"), steps=2)
    per = 1e-3 / 2
    assert got == {"qp.pgd": pytest.approx(34 * per),
                   "scheme.clip": pytest.approx(30 * per),
                   "loop.plant": pytest.approx(10 * per), "qp.grad": 0.0}


def _row(key, count, us, device="DeviceType.CUDA", annotation=False):
    return types.SimpleNamespace(key=key, count=count, device_type=device,
                                 self_device_time_total=us,
                                 is_user_annotation=annotation)


def test_kernel_filters_drop_the_ranges_device_mirrors():
    rows = [_row("ntt_fwd_kernel", 4, 40.0),
            _row("base_convert_kernel", 2, 10.0),
            _row("hectr.scheme.encrypt", 4, 400.0, annotation=True),
            _row("hectr.loop.regulator", 1, 900.0),
            _row("aten::add", 3, 0.0, device="DeviceType.CPU"),
            _row("ntt_fwd_kernel", 2, 0.0)]
    # an older torch names a row's device time self_cuda_time_total
    del rows[-1].self_device_time_total
    rows[-1].self_cuda_time_total = 20.0
    assert pmu.device_us(rows[-1]) == 20.0
    us, launches = pmu.device_ops(rows)
    assert us == {"ntt_fwd_kernel": 60.0, "base_convert_kernel": 10.0}
    assert launches == {"ntt_fwd_kernel": 6, "base_convert_kernel": 2}
    assert BB.kernel_totals(rows) == {"kernel_launches": 8,
                                      "device_ms": pytest.approx(0.07)}
    got = PS.by_kernel(rows, steps=2)
    assert got["kernel_launches_per_step"] == 4
    assert got["device_ms_per_step"] == pytest.approx(0.035)
    assert got["ntt_share"] == pytest.approx(6 / 7)
    assert [k for k, *_ in got["top_ms_per_step"]] == ["ntt_fwd_kernel",
                                                       "base_convert_kernel"]


def test_keyswitch_roofline_prices_the_counter_keys():
    """Each K6-K8 counter key is priced by ``bench.keyswitch_work`` alone;
    the roofline is their least time over the kernels' device time."""
    from hectr_tpu_torch import bench

    N = 1 << 13
    shapes = {("base_convert", (1, 4, 1, N), 5): 2,
              ("key_inner_product", (4, 5, N), (4, 4, 5, N), True): 3,
              ("key_inner_product", (4, 5, N), (4, 2, 5, N), False): 1,
              ("mod_down_tail", (2, 4, N)): 4}
    want = [bench.keyswitch_work("base_convert", (1, 4, 1, N), 5),
            bench.keyswitch_work("key_inner_product", (4, 5, N), perm=True),
            bench.keyswitch_work("key_inner_product", (4, 5, N),
                                 key_words=2),
            bench.keyswitch_work("mod_down_tail", (2, 4, N))]
    for key, work in zip(shapes, want):
        assert bench.keyswitch_launch_work(key) == work
    nbytes = sum(n * w[0] for n, w in zip(shapes.values(), want))
    roof = PS.keyswitch_roofline(shapes, 0.5)
    assert roof["launches"] == 10
    assert roof["least_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert roof["roofline"] == pytest.approx(roof["least_ms"] / 0.5)
    assert np.isfinite(roof["least_ms"])
