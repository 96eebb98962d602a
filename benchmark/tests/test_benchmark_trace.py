"""Reading a profile: the marker's alignment of host spans with the device's
timeline, the per-layer readers over it, and the breakdown, on synthetic
events."""

import pytest

from benchmark import drive
from benchmark import run as bench_run
from benchmark.manifest import metric_reader


def _trace():
    # host seconds: marker launched at 10.0; the stretch 10.001 .. 10.011;
    # the device's clock reads the marker's start as 5_000 us
    activities = [
        ("sm90_xmma_fprop_implicit_gemm_bf16", 6000, 9000),
        ("spin_kernel", 5000, 5001),
        ("void gn_apply<__nv_bfloat16>", 9000, 10000),
        ("attn_bf16_any<2>", 12000, 12500),
        ("Memcpy DtoH (Device -> Pageable)", 14000, 15000),
    ]
    spans = [("bench.inputs", 10.001, 10.002), ("bench.dispatch", 10.002, 10.0105),
             ("bench.fetch", 10.0105, 10.011)]
    tr = drive.read_trace(activities, 2, 10.0, (10.001, 10.011), spans)
    tr["requests"] = 1
    return tr


def test_spans_are_put_on_the_devices_timeline_by_the_marker():
    tr = _trace()
    assert tr["stretch_us"] == pytest.approx((6000, 16000))
    assert [k[0] for k in tr["kernels"]] == ["sm90_xmma_fprop_implicit_gemm_bf16",
                                             "void gn_apply<__nv_bfloat16>",
                                             "attn_bf16_any<2>",
                                             "Memcpy DtoH (Device -> Pageable)"]
    assert tr["spans"][0] == ("bench.inputs", pytest.approx(6000), pytest.approx(7000))


def test_a_profile_without_the_marker_is_refused():
    with pytest.raises(RuntimeError):
        drive.read_trace([("gemm", 0, 1)], 1, 0.0, (0.0, 1.0), [])


def test_per_layer_readers_over_the_trace():
    record = {"trace": _trace(), "bounds_per_forward": {"groupnorm": 250e-6, "attention": 50e-6},
              "window": {"start": 1.0, "end": 1.03, "requests": 3}}
    # busy 6000..10000, 12000..12500, 14000..15000 of 6000..16000: 5.5 ms for
    # the stretch's one request, against the untraced window's 10 ms a request
    assert metric_reader("device.idle_share")(record) == pytest.approx(45.0)
    record["window"]["end"] = 1.0165
    # a window whose period is the card's busy time per request: never idle
    assert metric_reader("device.idle_share")(record) == pytest.approx(0.0, abs=1e-9)
    assert metric_reader("unet.conv_ms_per_nfe")(record) == pytest.approx(1.5)
    # 2 forwards x 250 us of bound over 1000 us of GroupNorm kernels
    assert metric_reader("kernels.groupnorm_roofline")(record) == pytest.approx(50.0)
    assert metric_reader("kernels.attention_roofline")(record) == pytest.approx(20.0)
    assert metric_reader("kernels.attention_roofline")({"peak_bytes": 0}) is None


def test_breakdown_names_idle_gaps_by_the_open_span():
    b = bench_run.breakdown(_trace())
    assert b["device_ops"][0] == ["sm90_xmma_fprop_implicit_gemm_bf16", pytest.approx(0.003)]
    gaps = dict((round(s * 1e6), n) for n, s in b["idle_gaps"])
    assert gaps == {1500: "bench.dispatch", 2000: "bench.dispatch", 1000: "bench.dispatch"}
