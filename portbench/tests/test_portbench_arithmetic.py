"""The p95, union-of-intervals, roofline and reader arithmetic on
hand-made numbers and events."""
from __future__ import annotations

import types

import numpy as np
import pytest

from portbench import devtrace, harness, readers, roofline, spec

ARCH = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
        "d_head": 2, "d_ff": 16, "vocab": 10, "act": "squared_relu"}


def test_p95_interpolates_between_order_statistics():
    assert harness.percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert harness.percentile([5.0], 95) == 5.0
    assert harness.percentile([], 95) is None


def test_union_counts_overlapping_streams_once():
    ops = [(0.0, 10.0, "a"), (5.0, 15.0, "b"), (20.0, 30.0, "a"),
           (25.0, 26.0, "c"), (40.0, 50.0, "d")]
    assert devtrace.busy_us(ops, 0.0, 45.0) == 15.0 + 10.0 + 5.0
    assert devtrace.idle_gaps(ops, 0.0, 45.0) == [(15.0, 20.0), (30.0, 40.0)]
    assert devtrace.idle_gaps(ops, -5.0, 60.0)[0] == (-5.0, 0.0)
    assert devtrace.by_name(ops) == {"a": 20e-6, "b": 10e-6, "c": 1e-6,
                                     "d": 10e-6}


def test_trace_events_read_by_category():
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 5},
          {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 1, "dur": 2},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 9},
          {"ph": "X", "cat": "user_annotation", "name": "pb.step.x", "ts": 0,
           "dur": 30},
          {"ph": "X", "cat": "user_annotation", "name": "pb.replay", "ts": 2,
           "dur": 3},
          {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 2,
           "dur": 3}]
    assert devtrace.device_ops(ev) == [(1.0, 3.0, "m"), (10.0, 15.0, "k1")]
    spans = devtrace.host_spans(ev)
    assert [s[2] for s in spans] == ["pb.step.x", "pb.replay"]
    assert devtrace.label_at(spans, 3.0).startswith("decode graph replay")
    assert devtrace.label_at(spans, 20.0).endswith("[x]")
    assert devtrace.label_at(spans, 99.0) == "harness, between steps"


def test_bound_takes_the_larger_of_operations_and_bytes():
    ms, by = roofline.bound(989e12, 0.0)
    assert (ms, by) == (pytest.approx(1000.0), "operations")
    ms, by = roofline.bound(0.0, 3.35e12)
    assert (ms, by) == (pytest.approx(1000.0), "bytes")


def test_flops_and_bytes_counted_from_shapes():
    # a layer: q 8x8, k and v 8x4, o 8x8, MLP 2 x 8x16
    assert roofline.layer_matmul_params(ARCH) == 64 + 64 + 64 + 256
    # S=3 causal: keys 1 + 2 + 3 = 6; 4 * 4 heads * 2 dims * 6 * 2 layers
    assert roofline.attention_flops(ARCH, 3, 1) == 4 * 4 * 2 * 6 * 2
    pre = roofline.prefill_flops(ARCH, 3)
    assert pre == 2 * 448 * 2 * 3 + 4 * 4 * 2 * 6 * 2 + 2 * 8 * 10
    dec = roofline.decode_flops(ARCH, [0, 5])
    assert dec == 2 * (2 * 448 * 2 + 2 * 8 * 10) + 4 * 4 * 2 * 2 * (1 + 6)
    # one layer's flash bound at S=3: bytes (2*3*4*2 + 2*3*2*2) * 2
    ops, nbytes = 4 * 4 * 2 * 6, (48 + 24) * 2
    assert roofline.flash_bound_ms(ARCH, 3) == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12) * 1e3)
    # decode: slots at lengths 0 and 5 read 1 + 6 rows of k and v
    nbytes = (2 * 7 * 2 * 2 + 2 * 2 * 4 * 2) * 2
    assert roofline.decode_attention_bound_ms(ARCH, [0, 5]) == pytest.approx(
        nbytes / 3.35e12 * 1e3)


def _track(prompt_len, stamps):
    return types.SimpleNamespace(prompt=np.zeros(prompt_len), stamps=stamps)


def _record(**kw):
    rec = {"measured_end": 10.0, "gateway": False,
           "tenants": {"m": {"arch": ARCH}},
           "steps": [("m", 0.0, 0.1, 20.0, 0), ("m", 0.1, 0.3, 30.0, 1000),
                     ("m", 0.3, 0.35, 0.0, 500), ("m", 9.9, 10.5, 10.0, 0)],
           "gateway_steps": [(0.0, 0.3), (0.3, 0.4), (9.0, 11.0)],
           "tracks": {"m": [_track(3, [1.0, 2.0, 3.0, 11.0]),
                            _track(4, [12.0])]},
           "profile": None}
    rec.update(kw)
    return rec


def test_readers_on_a_hand_made_record():
    rec = _record()
    # decode ms over the steps that decoded (the last ends after the part)
    assert readers.decode_step_ms(rec) == pytest.approx((20 + 30) / 2)
    # admission: (200 - 30) + (50 - 0) ms over 1500 prompt tokens
    assert readers.prefill_ms_per_ktok(rec) == pytest.approx(220 / 1.5)
    assert readers.gateway_step_ms(rec) == pytest.approx(200.0)
    gw = _record(gateway=True)
    assert readers.decode_step_ms(gw) == pytest.approx(50 / 2)
    flops = roofline.prefill_flops(ARCH, 3) + roofline.decode_flops(ARCH, [3, 4])
    assert readers.model_flops(rec) == pytest.approx(flops)
    assert readers.mfu(rec) == pytest.approx(100 * flops / (10 * 989e12))
    assert readers.idle_share(rec) is None
    assert readers.flash_roofline(rec) is None


def test_profile_readers_on_hand_made_events():
    ops = [(0.0, 400.0, "void flash_sm90<128>(Params)"),
           (300.0, 500.0, "void flash_sm90<128>(Params)"),
           (600.0, 700.0, "void (anonymous namespace)::split_mma<bf16, 8>(Args)"),
           (700.0, 800.0, "void combine<__nv_bfloat16>(float const*)"),
           (800.0, 900.0, "nvjet_tst_192x32")]
    prof = {"lo_us": 0.0, "hi_us": 1000.0, "ops": ops,
            "busy_us": devtrace.busy_us(ops, 0.0, 1000.0),
            "prefills": {"m": [3, 5]}, "decodes": {"m": [np.array([0, 5])]}}
    rec = _record(profile=prof)
    assert readers.idle_share(rec) == pytest.approx(100 * (1 - 800 / 1000))
    bound = 2 * (roofline.flash_bound_ms(ARCH, 3)
                 + roofline.flash_bound_ms(ARCH, 5))
    assert readers.flash_roofline(rec) == pytest.approx(100 * bound / 0.5)
    bound = 2 * roofline.decode_attention_bound_ms(ARCH, [0, 5])
    assert readers.decode_attention_roofline(rec) == pytest.approx(
        100 * bound / 0.2)


def test_each_metric_file_reads_its_readers_function():
    rec = _record()
    for p in sorted((spec.HERE / "metrics").glob("*.py")):
        value = spec.metric(p.name[:-3]).read(rec)
        assert value is None or np.isfinite(value)
