"""The yardstick's arithmetic against hand reckonings."""

import math

import pytest

from loadbench import catalog
from loadbench.record import Request, Run
from loadbench.yardstick import roofline, stats, trace
from loadbench.yardstick.flops import ModelShape
from loadbench.yardstick.peaks import BF16_FLOP_PER_S, MEM_BYTES_PER_S


def _req(due, done, n, phase="window", tokens=True):
    return Request(phase=phase, prompt=[5], budget=n, due=due, due_wall=due, done=done,
                   tokens=[7] * n if tokens else None)


def test_percentiles_count_every_request_and_missing_ones_last():
    vals = [float(i) for i in range(1, 101)]
    assert stats.percentile(vals, 50) == 50.0
    assert stats.percentile(vals, 95) == 95.0
    assert stats.percentile(vals[:90] + [math.inf] * 10, 95) == math.inf
    assert stats.percentile(vals[:95] + [math.inf] * 5, 95) == 95.0
    assert stats.percentile([], 50) is None


def test_rate_is_all_tokens_over_the_window():
    run = Run(cell="x", seconds=10.0, window=(100.0, 110.0))
    run.requests = [_req(101.0, 103.0, 50),  # inside: all 50
                    _req(98.0, 102.0, 40),  # half inside: 20
                    _req(109.0, 113.0, 80),  # a quarter inside: 20
                    _req(90.0, 95.0, 99),  # before: 0
                    _req(101.0, 104.0, 30, tokens=False)]  # failed: 0
    assert run.tokens_in_window() == pytest.approx(90.0)
    mod = catalog.load_module("metrics", "output_tok_s")
    assert mod.read(run) == pytest.approx(9.0)
    assert stats.rate(90, 10) == 9.0
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_latency_percentiles_over_the_window_requests():
    run = Run(cell="x", seconds=10.0, window=(0.0, 10.0))
    run.requests = [_req(float(i) / 10, float(i) / 10 + (i + 1) / 1000, 1)
                    for i in range(100)] + [_req(-1.0, 5.0, 1, phase="ramp")]
    p50 = catalog.load_module("metrics", "latency_p50_ms").read(run)
    p95 = catalog.load_module("metrics", "latency_p95_ms").read(run)
    assert p50 == pytest.approx(50.0) and p95 == pytest.approx(95.0)


def test_spread_uses_statistics_quartiles():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_idle_share_on_synthetic_intervals():
    spans = [(0, 10), (5, 15), (20, 30), (40, 45)]
    assert trace.union_seconds(spans) == 30
    assert trace.idle_gaps(spans, 0, 50) == [(15, 20), (30, 40), (45, 50)]
    s = trace.DeviceSummary(busy_s=30.0, window_s=50.0, kernels=4, kernel_s_by_name={},
                            kernel_count_by_name={}, range_device_s={})
    assert s.idle_share == pytest.approx(0.4)


def test_flops_of_one_mistral_and_one_mixtral_layer():
    mistral = ModelShape.from_hf(catalog.cell("mistral-7b.chat").config)
    # q, o 4096x4096; k, v 4096x1024; gate, up, down 4096x14336
    assert mistral.layer_weights() == 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    one = dict(catalog.cell("mistral-7b.chat").config, num_hidden_layers=1)
    s1 = ModelShape.from_hf(one)
    # a token at position 9 sees 10 keys; no head
    assert s1.tokens_flops(9, 10, 0) == 2.0 * 218103808 + 4 * 32 * 128 * 10
    # past the 4096 window a token sees 4096 keys
    assert s1.tokens_flops(5000, 5001, 1) == (2.0 * 218103808 + 4 * 32 * 128 * 4096
                                             + 2.0 * 4096 * 32000)
    # Mixtral-8x7B's layer: Mistral's widths with 8 experts, top 2, no window
    mixtral = dict(one, num_local_experts=8, num_experts_per_tok=2, sliding_window=None)
    m1 = ModelShape.from_hf(mixtral)
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024
    assert m1.layer_weights() == attn + 2 * 3 * 4096 * 14336 + 4096 * 8
    assert m1.tokens_flops(0, 1, 0) == 2.0 * m1.layer_weights() + 4 * 32 * 128
    # a prompt of 3 and two more tokens: positions 0-4, one head for each output
    assert s1.prompt_flops(3) + s1.output_flops(3, 1, 3) == pytest.approx(
        s1.tokens_flops(0, 5, 3))


def test_flash_bound_by_hand():
    # B 1, T 512 at past 0, S 512, Hq 32, Hkv 8, Dh 128, no window, bf16:
    # pairs = 512 * 513 / 2 per head; bytes = q + o + K + V of 512 keys
    sec, by = roofline.flash_bound(1, 512, 512, 0, 32, 8, 128, 0, 2)
    flops = 4.0 * 32 * 128 * (512 * 513 / 2)
    nbytes = 2 * (2 * 512 * 32 * 128 + 2 * 8 * 512 * 128)
    assert sec == pytest.approx(max(flops / BF16_FLOP_PER_S, nbytes / MEM_BYTES_PER_S))
    # a window of 64 cuts the keys each query sees
    sec_w, _ = roofline.flash_bound(1, 512, 512, 0, 32, 8, 128, 64, 2)
    pairs = sum(min(p + 1, 64) for p in range(512))
    assert sec_w == pytest.approx(max(4.0 * 32 * 128 * pairs / BF16_FLOP_PER_S,
                                      nbytes / MEM_BYTES_PER_S))


def test_paged_bound_by_hand():
    import numpy as np

    # two rows, a verify window of 3 queries at positions 100-102 and 9-11
    pos = np.array([[100, 101, 102], [9, 10, 11]])
    sec, by = roofline.paged_bound(pos, 32, 8, 128, 1408, 0, 2)
    keys = 103 + 12
    pairs = (101 + 102 + 103) + (10 + 11 + 12)
    nbytes = 2 * (2 * 2 * 3 * 32 * 128 + 2 * 8 * keys * 128)
    assert by == "bytes"
    assert sec == pytest.approx(max(nbytes / MEM_BYTES_PER_S,
                                    4.0 * 32 * 128 * pairs / BF16_FLOP_PER_S))


def test_a_named_range_on_the_device_is_no_kernel():
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    class E:
        def __init__(self, name, dev, s, e, device_time_total=0.0):
            self.name, self.device_type = name, dev
            self.time_range = type("T", (), {"start": s, "end": e})()
            self.device_time_total = device_time_total

    events = [E("moe", cpu, 0, 100, device_time_total=30.0), E("moe", cuda, 10, 90),
              E("gemm", cuda, 10, 30), E("silu", cuda, 70, 80), E("aten::mm", cpu, 5, 9)]
    s = trace.summarize(events, ranges=("moe",))
    assert s.kernels == 2 and s.busy_s == pytest.approx(30e-6)
    assert s.window_s == pytest.approx(100e-6)
    assert s.range_device_s == {"moe": pytest.approx(30e-6)}
    assert "moe" not in s.kernel_s_by_name
