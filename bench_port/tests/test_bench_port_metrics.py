"""The metric arithmetic: window rates, tails over all samples, idle share
as a union of intervals, bytes of a product counted from the operator."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from harness import readers, roofline, spec, stats, trace


def test_window_rate_divides_the_time_taken_by_the_items_done():
    assert stats.per_item(31.5, 7) == 4.5
    assert stats.per_item(31.5, 0) is None


def test_p95_is_nearest_rank_over_all_samples():
    v = list(range(1, 101))            # 1..100
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v[::-1], 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    assert stats.percentile([], 95) is None


def test_union_of_intervals_counts_overlap_once():
    assert stats.merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]
    assert stats.merge([(0, 2), (1, 3), (5, 9), (6, 7)]) == [(0, 3), (5, 9)]
    assert stats.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]


def _event(name, start, end, device):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_idle_share_from_a_trace():
    events = [
        _event(trace.WINDOW, 0.0, 1000.0, False),
        _event("bench.solve", 0.0, 900.0, False),
        _event("aten::item", 400.0, 600.0, False),
        _event("kernel_a", 100.0, 300.0, True),
        _event("kernel_b", 200.0, 400.0, True),     # overlaps kernel_a
        _event("kernel_a", 600.0, 800.0, True),
        _event("kernel_c", 990.0, 1200.0, True),    # clipped to the window
        _event("bench.solve", 0.0, 900.0, True),    # a span's device image
        _event("Activity Buffer Request", 820.0, 980.0, False),
    ]
    s = trace.summarise(events)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(510e-6)
    assert s["device_ops"][0] == ["kernel_a", pytest.approx(400e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(200e-6)      # 400..600
    # 0..100 and 800..990: inside the harness's solve span
    assert gaps["bench.solve"] == pytest.approx(290e-6)
    run = SimpleNamespace(profile=s, on_card=True)
    assert readers.idle_share(run) == pytest.approx(1 - 0.51)


def test_kernel_names_lose_their_parameter_lists():
    name = ("void (anonymous namespace)::csr_spmv_kernel<float, 1, 16>"
            "(long, long const*, float*)")
    assert trace.short_name(name) == \
        "(anonymous namespace)::csr_spmv_kernel<float, 1, 16>"
    assert trace.short_name("Memcpy DtoH (Device -> Pinned)") == \
        "Memcpy DtoH"
    assert len(trace.short_name("k" * 500)) == trace.NAME_CHARS


def test_bytes_counted_from_a_tiny_dia_csr_and_const_dia():
    import omp_amg_tpu_torch as amg

    n = 10
    dia = amg.Dia(data=torch.ones((3, n), dtype=torch.bfloat16),
                  offsets=(-1, 0, 1))
    assert roofline.spmv_bytes(dia) == 3 * n * 2 + n * 4 + n * 4
    csr = amg.Csr(indptr=torch.arange(n + 1, dtype=torch.int64),
                  indices=torch.arange(n, dtype=torch.int32),
                  vals=torch.ones(n, dtype=torch.float32), n_cols=n + 2)
    assert roofline.spmv_bytes(csr) == (n + 1) * 8 + n * 4 + n * 4 \
        + (n + 2) * 4 + n * 4
    cd = amg.ConstDia(coeffs=(6.0, -1.0), offsets=(0, 1),
                      taps=((0, 0, 0), (0, 0, 1)), dims=(2, 2, 3))
    assert roofline.spmv_bytes(cd) == 12 * 8 + 2 * 16
    # the bound is bytes over the peak; a kernel at the bound reads 100 %
    assert roofline.roofline_pct(3.35e9, 1.0, 3.35e12) == pytest.approx(100)
    with pytest.raises(TypeError):
        roofline.spmv_bytes(amg.Dia(data=np.ones((1, 3)), offsets=(0,)))


def test_every_metric_has_a_reader_that_is_silent_on_an_empty_run():
    bench = spec.load_benchmark()
    empty = SimpleNamespace(setup_s=None, window_s=None, solves=[], steps=[],
                            graphs=None, profile=None, solver=None,
                            on_card=False)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.reader(m["name"])(empty) is None, m["name"]
