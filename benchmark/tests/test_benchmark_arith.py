"""The harness's arithmetic on synthetic inputs: percentiles, rates, the
trace's union, idle share and gaps, the readers, the traffic."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import readings, spec, yardstick
from benchmark import traffic as T
from benchmark.harness import Run
from benchmark.trace import TraceReading, breakdown, reduce, union

SERVED = next(w["name"] for w in spec.benchmark()["workloads"]
              if spec.cell(w["name"]).traffic["plants"] > 1)


def run_of(**kw) -> Run:
    base = dict(plants=1, setup_s=1.5, window_s=2.0,
                steps=8, step_s=np.full(8, 0.25), regulator_s=np.full(8, 0.2),
                memory_peak_bytes=3 * 2**30, trace=None)
    base.update(kw)
    return Run(**base)


@pytest.mark.parametrize("values,q,want", [
    ([5.0], 95, 5.0),
    (list(range(1, 101)), 95, 95.0),
    (list(range(1, 101)), 100, 100.0),
    (list(range(100, 0, -1)), 50, 50.0),
    (list(range(1, 21)), 95, 19.0),
    ([], 95, None),
])
def test_percentile_nearest_rank(values, q, want):
    assert readings.percentile(values, q) == want


def test_rates_and_step_times():
    run = run_of(plants=16, steps=40, window_s=4.0)
    assert readings.loop_steps_per_s(run) == 160.0
    assert readings.per_step_ms(run) == 100.0
    assert readings.per_step_ms(run_of(steps=0)) is None


def test_union_merges_overlaps_and_touching():
    assert union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [(0, 2.5), (3, 4)]


def test_reduce_busy_idle_and_labelled_gaps():
    spans = [("episode_start", 0.0, 1.0), ("regulator", 1.0, 6.0),
             ("plant_estimator", 6.0, 10.0)]
    ops = [("k1", 1.5, 3.0), ("k2", 2.5, 4.0), ("k1", 7.0, 8.0),
           ("k3", 9.5, 11.0)]                  # the last one leaves the window
    r = reduce(spans, ops, ntt_shapes={("ntt", (2, 4)): 3}, steps=2)
    assert r.window_s == 10.0
    assert r.busy_s == pytest.approx(2.5 + 1.0 + 0.5)
    assert r.device_ops == {"k1": [2, 2.5], "k2": [1, 1.5], "k3": [1, 1.5]}
    assert r.gaps == [("episode_start", 1.5), ("regulator", 3.0),
                      ("plant_estimator", 1.5)]
    run = run_of(trace=r)
    assert readings.idle_share(run) == pytest.approx(60.0)
    b = breakdown(r)
    assert b["device_ops"][0] == ["k1", 2.5]
    assert b["idle_gaps"][0] == ["regulator (all gaps)", 3.0]
    assert len(b["idle_gaps"]) <= 10 and len(b["device_ops"]) <= 10


def test_idle_share_needs_device_time():
    r = TraceReading(window_s=1.0, busy_s=0.0, steps=1, device_ops={}, gaps=[],
                     ntt_shapes={})
    assert readings.idle_share(run_of(trace=r)) is None
    assert readings.idle_share(run_of()) is None


def test_ntt_roofline_and_keyswitch_reader():
    shape = (16, 34, 1 << 15)
    least = yardstick.ntt_least_s(shape)
    r = TraceReading(window_s=1.0, busy_s=0.5, steps=10,
                     device_ops={"void ntt_fwd_kernel<2>(long*)": [4, 8 * least],
                                 "key_inner_product_kernel": [20, 0.03],
                                 "mod_down_tail_kernel": [10, 0.01]},
                     gaps=[], ntt_shapes={("ntt", shape): 4})
    run = run_of(plants=16, trace=r)
    assert spec.reader("ntt_roofline.serve")(run) == pytest.approx(50.0)
    assert spec.reader("keyswitch_ms_per_loop_step.serve")(run) == \
        pytest.approx(0.04 / 160 * 1e3)
    assert spec.reader("launches_per_step.latency")(run) == 3.4
    assert spec.reader("ntt_roofline.serve")(run_of()) is None


def test_ntt_least_time_is_the_byte_bound_at_the_loops_shapes():
    rows, n = 11 * 24, 1 << 15
    want = (rows * n * 16 + 24 * (n * 8 + 4)) / yardstick.HBM_BYTES_PER_S
    assert yardstick.ntt_least_s((11, 24, n)) == pytest.approx(want)


def test_host_readers():
    run = run_of()
    assert spec.reader("step_ms_p95")(run) == pytest.approx(250.0)
    assert spec.reader("regulator_ms.latency")(run) == pytest.approx(200.0)
    assert spec.reader("plant_estimator_ms.latency")(run) == pytest.approx(50.0)
    assert spec.reader("peak_device_gib")(run) == 3.0
    assert spec.reader("setup_s")(run) == 1.5


def test_traffic_repeats_from_the_seed():
    traffic = spec.cell(SERVED).traffic
    seed = 2**31 + 977
    a = T.pool(traffic, T.seeds(seed)["traffic"])
    b = T.pool(traffic, T.seeds(seed)["traffic"])
    c = T.pool(traffic, T.seeds(seed + 1)["traffic"])
    N = traffic["episode_steps"]
    assert a.shape == (traffic["pool_episodes"], traffic["plants"], N, 1)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    size = a.max(axis=(2, 3))
    assert np.all((size >= 0.005) & (size <= 0.015))
    onset = (a[..., 0] == 0).sum(axis=-1)
    assert onset.min() >= 0 and onset.max() < N // 2
    assert all(0 <= s < 2**32 for s in T.seeds(seed).values())
    with pytest.raises(ValueError):
        T.seeds(-1)


def test_a_named_stream_repeats_from_the_seed_and_its_name():
    seed = 2**31 + 977
    streams = T.seeds(seed)
    relin = T.stream(seed, "relin")
    assert relin == T.stream(seed, "relin") and 0 <= relin < 2**32
    others = {T.stream(seed + 1, "relin"), T.stream(seed, "relin2"),
              *(T.stream(seed, name) for name in streams), *streams.values()}
    assert relin not in others and len(others) == 2 + 2 * len(streams)
    assert streams == {"keygen": 2052213626, "rotations": 2900422116,
                       "encryption": 3372975877, "traffic": 3419413705}
    for bad in ((-1, "relin"), (seed, "")):
        with pytest.raises(ValueError):
            T.stream(*bad)
