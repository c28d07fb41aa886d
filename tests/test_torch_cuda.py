"""The port's CUDA kernels on the card: against their plain versions,
through the engine, and the wrappers' refusals; the tensor-core (bf16)
routes of K1 and K4-K7, and K2/K3, also for bit-for-bit determinism and
invariance to the batch, the other rows and the keys no query sees. Every
test here needs a CUDA device and nvcc and skips without them.

This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

(``--noconftest`` because tests/conftest.py sets up JAX for the other
files.) Tolerances: fp32 outputs differ from the plain version only by
summation order (5e-3, the TPU kernel gate's); a bf16 output is one
rounding of an fp32 value below 2 in size, within 2e-2. The quantized
products (K4-K7) differ from their plain versions only in the order of the
fp32 sums: 1e-5 of the largest output in fp32, and one bf16 ulp (2^-7) of
the largest output in bf16, where the single final rounding may fall on
either side.
"""

import dataclasses

import numpy as np
import pytest
import torch

from layerskip_tpu_torch.ops.cuda import flash_prefill as tflash
from layerskip_tpu_torch.ops.cuda import quant_matmul as tqmm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the port's kernels)")
    return torch.Generator(device="cuda").manual_seed(0)


# (B, T, S, past, Hkv, G, Dh, window, scale, softcap, dtype, tol)
_CASES = {
    "ragged_window_softcap_f32": (2, 200, 700, 37, 2, 2, 128, 64, 0.0, 50.0,
                                  torch.float32, 5e-3),
    "dh64_f32": (1, 130, 300, 0, 2, 4, 64, 0, 0.0, 0.0, torch.float32, 5e-3),
    "dh256_bf16": (1, 96, 200, 60, 1, 2, 256, 0, 0.0, 0.0, torch.bfloat16, 2e-2),
    "gqa_bf16": (2, 257, 600, 11, 2, 4, 128, 0, 32.0 ** -0.5, 0.0,
                 torch.bfloat16, 2e-2),
    "masked_rows_f32": (1, 64, 40, 30, 1, 1, 128, 8, 0.0, 0.0, torch.float32, 5e-3),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_kernel_matches_plain(cuda, name):
    b, t, s, past, hkv, g, dh, window, scale, cap, dtype, tol = _CASES[name]
    q = torch.randn(b, t, hkv * g, dh, generator=cuda, device="cuda").to(dtype)
    # k/v are one layer of a stacked cache, read through its strides
    k = torch.randn(3, b, s, hkv, dh, generator=cuda, device="cuda").to(dtype)[1]
    v = torch.randn(3, b, s, hkv, dh, generator=cuda, device="cuda").to(dtype)[1]
    kw = dict(q_heads_per_kv=g, sliding_window=window, score_scale=scale,
              logit_softcap=cap)
    before = tflash.flash_prefill_attention.launches
    got = tflash.flash_prefill_attention(q, k, v, past, **kw)
    torch.cuda.synchronize()
    assert tflash.flash_prefill_attention.launches == before + 1
    want = tflash.flash_prefill_attention_plain(q, k, v, past, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 32, 2, 128, device="cuda")
    kv = torch.randn(1, 64, 1, 128, device="cuda")
    # bf16 rows that start 2 bytes past a 16-byte boundary
    q_off = torch.randn(q.numel() + 1, device="cuda").bfloat16()[1:].view(q.shape)
    kv_off = torch.randn(kv.numel() + 1, device="cuda").bfloat16()[1:].view(kv.shape)
    for bad_q, bad_kv in ((q.half(), kv.half()),  # dtype
                          (q[..., ::2], kv[..., ::2]),  # strided head_dim
                          (q, kv.cpu()),  # devices differ
                          (q[..., :96].contiguous(), kv[..., :96].contiguous()),  # Dh 96
                          (q_off, kv_off)):  # misaligned bf16 rows
        with pytest.raises(ValueError):
            tflash.flash_prefill_attention(bad_q, bad_kv, bad_kv, 0, q_heads_per_kv=2)


# The bf16 tensor-core route at tile edges (64-query blocks; 64-key tiles,
# 32 at Dh 256): (B, T, S, past, Hkv, G, Dh, window, scale, softcap)
_TC_CASES = {
    "ragged_t_and_s_dh128": (2, 100, 301, 37, 2, 1, 128, 0, 0.0, 0.0),
    "window_across_tiles_g4_dh64": (1, 150, 333, 20, 2, 4, 64, 50, 0.0, 0.0),
    "softcap_dh256": (1, 80, 150, 40, 1, 2, 256, 0, 32.0 ** -0.5, 50.0),
    "masked_rows_dh128": (1, 64, 40, 30, 1, 1, 128, 8, 0.0, 0.0),
    "g4_window_softcap_dh128": (2, 200, 260, 50, 2, 4, 128, 96, 0.0, 30.0),
    "t17_dh64": (1, 17, 17, 0, 1, 1, 64, 0, 0.0, 0.0),
    "window_dh256_g4": (1, 130, 200, 60, 1, 4, 256, 40, 0.0, 0.0),
    # long walks over the K/V ring (many tiles per block, several waves)
    "long_window_softcap_dh128": (2, 900, 1100, 100, 4, 4, 128, 300, 0.0, 30.0),
    "long_dh64": (1, 2100, 2200, 50, 8, 4, 64, 0, 0.0, 0.0),
    "long_dh256": (1, 1500, 1600, 0, 8, 4, 256, 0, 0.0, 0.0),
    # Gemma-2-2B's heads and score math past its 4096 window, moe-3b's heads
    "g2b_window_softcap_dh256": (1, 4500, 4600, 0, 4, 2, 256, 4096, 256.0 ** -0.5, 50.0),
    "moe3b_dh128_g2": (1, 2048, 2048, 0, 8, 2, 128, 0, 0.0, 0.0),
}


def _tc_inputs(case, gen, s_extra=0):
    """q, and k/v as one layer of a stacked cache, for a _TC_CASES entry;
    ``s_extra`` appends that many more keys past S."""
    b, t, s, past, hkv, g, dh, window, scale, cap = _TC_CASES[case]
    bf16 = torch.bfloat16
    q = torch.randn(b, t, hkv * g, dh, generator=gen, device="cuda").to(bf16)
    k = torch.randn(2, b, s + s_extra, hkv, dh, generator=gen, device="cuda").to(bf16)[1]
    v = torch.randn(2, b, s + s_extra, hkv, dh, generator=gen, device="cuda").to(bf16)[1]
    kw = dict(q_heads_per_kv=g, sliding_window=window, score_scale=scale, logit_softcap=cap)
    return q, k, v, past, kw


@pytest.mark.parametrize("case", sorted(_TC_CASES))
def test_tensor_core_route_matches_plain(cuda, case):
    q, k, v, past, kw = _tc_inputs(case, cuda)
    fn = tflash.flash_prefill_attention
    before, before_tc = fn.launches, fn.tensor_core_launches
    got = fn(q, k, v, past, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tensor_core_launches) == (before + 1, before_tc + 1)
    want = tflash.flash_prefill_attention_plain(q, k, v, past, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    if case == "masked_rows_dh128":  # rows past S + window - 1 see no key
        assert (got[:, 17:] == 0).all() and (got[:, :10] != 0).any()


def test_tensor_core_route_is_deterministic(cuda):
    q, k, v, past, kw = _tc_inputs("g4_window_softcap_dh128", cuda)
    first = tflash.flash_prefill_attention(q, k, v, past, **kw)
    for _ in range(3):
        assert torch.equal(tflash.flash_prefill_attention(q, k, v, past, **kw), first)


@pytest.mark.parametrize("case", ["ragged_t_and_s_dh128", "window_across_tiles_g4_dh64",
                                  "softcap_dh256", "long_window_softcap_dh128"])
def test_tensor_core_route_is_row_invariant(cuda, case):
    """A batch row run alone equals the same row inside B = 3 beside other
    rows, bit for bit."""
    q, k, v, past, kw = _tc_inputs(case, cuda)
    alone = tflash.flash_prefill_attention(q[:1], k[:1], v[:1], past, **kw)
    q3, k3, v3, _, _ = _tc_inputs(case, cuda)
    q3 = torch.cat([q3[:1], q[:1], q3[:1] * 2])
    k3 = torch.cat([k3[:1], k[:1], k3[:1].flip(1)])
    v3 = torch.cat([v3[:1], v[:1], -v3[:1]])
    assert torch.equal(tflash.flash_prefill_attention(q3, k3, v3, past, **kw)[1], alone[0])


@pytest.mark.parametrize("case", ["ragged_t_and_s_dh128", "masked_rows_dh128",
                                  "window_dh256_g4", "t17_dh64", "long_dh64"])
def test_tensor_core_route_ignores_keys_it_cannot_see(cuda, case):
    """The same prompt over its S and over a longer S whose extra keys no
    query sees (a paged insert's gathered view against the contiguous
    cache), bit for bit, and unchanged when those keys change."""
    q, k, v, past, kw = _tc_inputs(case, cuda, s_extra=300)
    s = _TC_CASES[case][2]
    short = tflash.flash_prefill_attention(q, k[:, :s], v[:, :s], past, **kw)
    if past + q.shape[1] <= s:  # every extra key lies past the causal frontier
        assert torch.equal(tflash.flash_prefill_attention(q, k, v, past, **kw), short)
        k2, v2 = k.clone(), v.clone()
        k2[:, s:], v2[:, s:] = 1e4, -3e4
        assert torch.equal(tflash.flash_prefill_attention(q, k2, v2, past, **kw), short)
    # the visible keys copied into a fresh contiguous buffer
    kc, vc = k[:, :s].contiguous(), v[:, :s].contiguous()
    assert torch.equal(tflash.flash_prefill_attention(q, kc, vc, past, **kw), short)


def test_greedy_spec_equals_ar_through_the_kernel(cuda):
    """fp32 greedy self-spec equals greedy AR on the card, and each prefill
    launches the kernel once per layer."""
    from layerskip_tpu_torch.config import GenerationConfig, tiny_config
    from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
    from layerskip_tpu_torch.models.params import init_params

    cfg = tiny_config(hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
                      intermediate_size=256, vocab_size=256, max_position_embeddings=512)
    params = init_params(cfg, seed=3, device="cuda")
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        getattr(params.layers, name).mul_(7.5)
    params.embed.mul_(15.0)
    params.lm_head.mul_(7.5)
    eng = Engine(params, cfg, device="cuda")
    prompt = np.random.default_rng(0).integers(3, cfg.vocab_size, size=90).tolist()
    eos = (cfg.vocab_size + 7,)

    def run(**kw):
        before = tflash.flash_prefill_attention.launches
        out = eng.generate(prompt, GenerationConfig(max_steps=32, sample=False, **kw),
                           eos_ids=eos)
        assert tflash.flash_prefill_attention.launches - before == cfg.num_hidden_layers
        return postprocess_output(out, eos, 32)

    ar = run(generation_strategy="autoregressive")
    assert len(ar) == 32
    for e, w in ((1, 3), (3, 5)):
        assert run(generation_strategy="self_speculative", exit_layer=e,
                   num_speculations=w) == ar


# (kernel, M, K, N, group, dtype): vector and ragged paths (N % 4, K % 16,
# a group that is not a multiple of 32), and every M tile height
_QCASES = {
    "K5_bf16": ("quant_matmul", 7, 4096, 1000, 0, torch.bfloat16),
    "K5_f32_ragged": ("quant_matmul", 13, 300, 131, 0, torch.float32),
    "K4_bf16": ("quant_matmul_t", 1, 4096, 777, 0, torch.bfloat16),
    "K4_f32_ragged": ("quant_matmul_t", 40, 1000, 67, 0, torch.float32),
    "K6_bf16": ("int4_matmul", 3, 2048, 1030, 128, torch.bfloat16),
    "K6_f32_g6": ("int4_matmul", 9, 600, 45, 6, torch.float32),
    "K7_bf16": ("int4_matmul_t", 2, 4096, 300, 128, torch.bfloat16),
    "K7_f32_g6": ("int4_matmul_t", 5, 1020, 37, 6, torch.float32),
    # bf16 [K, N] on the tensor cores: tiles by TMA (N % 16 == 0, G % 64 ==
    # 0) with a ragged K tail, a 7B w_down at a verify-sized M, and a group
    # of 6 (the blocks load their tiles themselves, as at N 1000 and 1030)
    "K5_bf16_tma_raggedk": ("quant_matmul", 300, 1000, 512, 0, torch.bfloat16),
    "K5_bf16_7b_wdown": ("quant_matmul", 28, 11008, 4096, 0, torch.bfloat16),
    "K6_bf16_tma": ("int4_matmul", 37, 2048, 1024, 128, torch.bfloat16),
    "K6_bf16_g6": ("int4_matmul", 9, 600, 45, 6, torch.bfloat16),
    # bf16 [N, K] on the tensor cores: tiles by TMA (K % 16 == 0, K % 32 for
    # int4; any N) with a ragged K tail (int4: G 32, scales per element), the
    # 7B wq at a verify-sized M, the Llama-3.2-1B wk, a group of 6 with the
    # weight by TMA and with every tile loaded by the blocks (K % 32 != 0),
    # and int8 loaded by the blocks (K % 16 != 0)
    "K4_bf16_tma_raggedk": ("quant_matmul_t", 300, 1040, 512, 0, torch.bfloat16),
    "K7_bf16_tma_raggedk_g32": ("int4_matmul_t", 37, 1056, 384, 32, torch.bfloat16),
    "K4_bf16_7b_wq": ("quant_matmul_t", 28, 4096, 4096, 0, torch.bfloat16),
    "K7_bf16_7b_wq": ("int4_matmul_t", 28, 4096, 4096, 128, torch.bfloat16),
    "K4_bf16_1b_wk": ("quant_matmul_t", 1, 2048, 512, 0, torch.bfloat16),
    "K7_bf16_1b_wk": ("int4_matmul_t", 1, 2048, 512, 128, torch.bfloat16),
    "K7_bf16_g6_tma": ("int4_matmul_t", 9, 960, 100, 6, torch.bfloat16),
    "K7_bf16_g6": ("int4_matmul_t", 9, 600, 45, 6, torch.bfloat16),
    "K4_bf16_self": ("quant_matmul_t", 40, 1000, 67, 0, torch.bfloat16),
    # Gemma-2-2B's products: K 2304 (36 tiles of 64, 18 int4 groups of 128)
    # and its w_down's 9216
    "K4_bf16_g2b_wq": ("quant_matmul_t", 7, 2304, 2048, 0, torch.bfloat16),
    "K7_bf16_g2b_wk": ("int4_matmul_t", 1, 2304, 1024, 128, torch.bfloat16),
    "K5_bf16_g2b_wdown": ("quant_matmul", 7, 9216, 2304, 0, torch.bfloat16),
    "K6_bf16_g2b_wgate": ("int4_matmul", 1, 2304, 9216, 128, torch.bfloat16),
}


def _quant_case(name, gen):
    from layerskip_tpu_torch.quant import quantize_tensor

    fn, m, k, n, group, dtype = _QCASES[name]
    k_last = fn.endswith("_t")
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = torch.randn((n, k) if k_last else (k, n), generator=gen, device="cuda") * 0.02
    qt = quantize_tensor(w, k_last=k_last, bits=4 if group else 8, group=group)
    return fn, x, qt


def _call(fn, x, qt, plain=False):
    f = getattr(tqmm, fn + ("_plain" if plain else ""))
    return f(x, qt.q, qt.scale, group=qt.group) if qt.group else f(x, qt.q, qt.scale)


@pytest.mark.parametrize("name", sorted(_QCASES))
def test_quant_kernel_matches_plain(cuda, name):
    fn, x, qt = _quant_case(name, cuda)
    before = getattr(tqmm, fn).launches
    got = _call(fn, x, qt)
    torch.cuda.synchronize()
    assert getattr(tqmm, fn).launches == before + 1
    want = _call(fn, x, qt, plain=True)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    top = want.float().abs().max().item()
    tol = (1e-5 if x.dtype == torch.float32 else 2.0 ** -7) * top
    assert (got.float() - want.float()).abs().max().item() <= tol


# (M, first row) of the row-invariance test's calls in bf16: every token
# tile of the tensor-core route (8, 32 and 128 rows), ragged ones too
_TC_SPANS = ((1, 0), (4, 5), (7, 3), (28, 100), (37, 263), (256, 44), (300, 0), (1, 299))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_kernels_are_row_invariant(cuda, dtype):
    """A row's output does not depend on M or on its place in the batch:
    bit-identical at M = 1, 7 and 37 in fp32 (greedy AR == spec needs it);
    in bf16, whose tensor-core tile follows M, at M = 1, 4, 7, 28, 37, 256
    and 300, with tiles by TMA and loaded by the blocks, both layouts."""
    for name in ("K5_bf16", "K4_bf16", "K6_bf16", "K7_bf16", "K5_bf16_tma_raggedk",
                 "K6_bf16_tma", "K4_bf16_tma_raggedk", "K7_bf16_tma_raggedk_g32",
                 "K7_bf16_g6", "K4_bf16_self"):
        fn, x, qt = _quant_case(name, cuda)
        tc = dtype == torch.bfloat16
        spans = _TC_SPANS if tc else ((1, 0), (7, 3), (1, 36))
        x = torch.randn(300 if tc else 37, x.shape[1], generator=cuda, device="cuda").to(dtype)
        full = _call(fn, x, qt)
        for m, start in spans:
            part = _call(fn, x[start:start + m], qt)
            assert torch.equal(part, full[start:start + m]), (name, start, m)


@pytest.mark.parametrize("name", ["K5_bf16", "K5_bf16_7b_wdown", "K6_bf16", "K6_bf16_tma",
                                  "K4_bf16", "K4_bf16_7b_wq", "K7_bf16", "K7_bf16_7b_wq",
                                  "K7_bf16_g6"])
def test_quant_tensor_core_route_is_deterministic(cuda, name):
    """The K slices merge in a fixed order: repeated calls give the same
    bits, at a decode and a prefill M."""
    fn, x, qt = _quant_case(name, cuda)
    for m in (1, 256):
        xm = torch.randn(m, x.shape[1], generator=cuda, device="cuda").bfloat16()
        first = _call(fn, xm, qt)
        for _ in range(3):
            assert torch.equal(_call(fn, xm, qt), first), m


def test_quant_split_geometry_matches_the_library(cuda):
    """The tile and slice counts the CPU tests' model of the K split uses
    are the compiled kernel's own."""
    for k in (2, 64, 300, 600, 1000, 1792, 2048, 4096, 11008, 14336):
        assert tqmm.library_tc_geometry(k) == (tqmm.TC_TILE, tqmm.tc_slices(k)), k


def test_quant_tensor_core_launches_count_bf16_calls_only(cuda):
    """K4-K7 count every bf16 launch as a tensor-core launch, no fp32 one."""
    for name in ("K5_bf16", "K6_bf16", "K4_bf16", "K7_bf16"):
        fn, x, qt = _quant_case(name, cuda)
        kernel = getattr(tqmm, fn)
        for dtype, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
            before = (kernel.launches, kernel.tensor_core_launches)
            _call(fn, x.to(dtype), qt)
            assert (kernel.launches, kernel.tensor_core_launches) == (before[0] + 1,
                                                                      before[1] + tc)


@pytest.mark.parametrize("n", [1024, 1000])
def test_quant_kernels_take_stacked_layer_views(cuda, n):
    """Layer i > 0 of a stacked [L, K, N] or [L, N, K] weight
    (``QuantTensor[i]``, a view at an offset) gives the bits of its
    contiguous copy and the plain version's values."""
    from layerskip_tpu_torch.quant import quantize_tensor

    w = torch.randn(3, 2048, n, generator=cuda, device="cuda") * 0.02
    for fn, bits in (("quant_matmul", 8), ("int4_matmul", 4), ("quant_matmul_t", 8),
                     ("int4_matmul_t", 4)):
        k_last = fn.endswith("_t")
        stacked = quantize_tensor(w.transpose(1, 2).contiguous() if k_last else w,
                                  k_last=k_last, bits=bits, group=128 if bits == 4 else 0)
        for m in (1, 37):
            x = torch.randn(m, 2048, generator=cuda, device="cuda").bfloat16()
            layer = stacked[2]
            assert layer.q.data_ptr() != stacked.q.data_ptr()
            got = _call(fn, x, layer)
            copy = dataclasses.replace(layer, q=layer.q.clone(), scale=layer.scale.clone())
            assert torch.equal(got, _call(fn, x, copy)), (fn, m)
            want = _call(fn, x, layer, plain=True).float()
            assert (got.float() - want).abs().max().item() <= 2.0 ** -7 * want.abs().max().item()


def test_quant_nk_kernels_take_misaligned_layer_views(cuda):
    """K4/K7 in bf16 on layer 1 of a stacked [2, 999, 2056] weight, whose
    view starts 8 (int8) or 12 (int4) bytes past a 16-byte boundary, and on
    x rows that start 2 bytes past one: the bits of contiguous, aligned
    copies and the plain version's values, at a decode and a verify M."""
    from layerskip_tpu_torch.quant import quantize_tensor

    w = torch.randn(2, 999, 2056, generator=cuda, device="cuda") * 0.02
    for fn, bits in (("quant_matmul_t", 8), ("int4_matmul_t", 4)):
        layer = quantize_tensor(w, k_last=True, bits=bits, group=8 if bits == 4 else 0)[1]
        assert layer.q.data_ptr() % 16 != 0
        copy = dataclasses.replace(layer, q=layer.q.clone(), scale=layer.scale.clone())
        for m in (1, 7):
            buf = torch.randn(m * 2056 + 1, generator=cuda, device="cuda").bfloat16()
            x = buf[1:].view(m, 2056)
            got = _call(fn, x, layer)
            assert torch.equal(got, _call(fn, x.clone(), copy)), (fn, m)
            want = _call(fn, x, layer, plain=True).float()
            assert (got.float() - want).abs().max().item() <= 2.0 ** -7 * want.abs().max().item()


def test_quant_kernels_refuse_what_they_do_not_take(cuda):
    from layerskip_tpu_torch.quant import quantize_tensor

    x = torch.randn(3, 256, device="cuda")
    q8 = quantize_tensor(torch.randn(256, 64, device="cuda"))
    q4 = quantize_tensor(torch.randn(64, 256, device="cuda"), k_last=True, bits=4, group=64)
    bad = [
        lambda: tqmm.quant_matmul(x.half(), q8.q, q8.scale),  # dtype
        lambda: tqmm.quant_matmul(x, q8.q.float(), q8.scale),  # weight dtype
        lambda: tqmm.quant_matmul(x, q8.q, q8.scale.cpu()),  # devices differ
        lambda: tqmm.quant_matmul(x[:, ::2], q8.q[:128], q8.scale),  # strided K
        lambda: tqmm.quant_matmul_t(x, q8.q, q8.scale),  # wrong orientation
        lambda: tqmm.int4_matmul_t(x, q4.q, q4.scale, group=63),  # odd group
        lambda: tqmm.int4_matmul_t(x[:, :200], q4.q[:, :100].contiguous(),
                                   q4.scale[:, :3].contiguous(), group=64),  # K % G
        lambda: tqmm.int4_matmul_t(x, q4.q.t().contiguous().t(), q4.scale, group=64),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_greedy_spec_equals_ar_through_the_kernels(cuda, bits):
    """fp32 greedy self-spec equals greedy AR on a quantized base, and every
    product goes through the kernels of its width."""
    from layerskip_tpu_torch.config import GenerationConfig, tiny_config
    from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
    from layerskip_tpu_torch.models.params import init_params
    from layerskip_tpu_torch.quant import quantize_llama_params

    cfg = tiny_config(hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
                      intermediate_size=256, vocab_size=256, max_position_embeddings=512)
    params = init_params(cfg, seed=3, device="cuda")
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        getattr(params.layers, name).mul_(7.5)
    params.embed.mul_(15.0)
    params.lm_head.mul_(7.5)
    eng = Engine(quantize_llama_params(params, bits=bits), cfg, device="cuda")
    kernels = ((tqmm.quant_matmul_t, tqmm.quant_matmul) if bits == 8
               else (tqmm.int4_matmul_t, tqmm.int4_matmul))
    prompt = np.random.default_rng(0).integers(3, cfg.vocab_size, size=90).tolist()
    eos = (cfg.vocab_size + 7,)

    def run(**kw):
        before = [k.launches for k in kernels]
        out = eng.generate(prompt, GenerationConfig(max_steps=32, sample=False, **kw),
                           eos_ids=eos)
        assert all(k.launches > b for k, b in zip(kernels, before))
        return postprocess_output(out, eos, 32)

    ar = run(generation_strategy="autoregressive")
    assert len(ar) == 32
    assert run(generation_strategy="self_speculative", exit_layer=1,
               num_speculations=4) == ar


# ------------------------------------------------------- K2 / K3 (paged)

# (B, T, G, Hkv, Dh, page, dtype, int8 pool, window, scale, softcap, tree)
# the TPU kernel gate's paged cases (pages of 128, 200 written keys, rows at
# positions 150 and 90; scripts/kernel_gate.py) and other page sizes, head
# dims and row tilings. Tolerances as for K1; the int8 pool is held to K3's
# own function (fp32 dequantization), so to the same fp32 tolerance.
_PCASES = {
    "t1_f32": (2, 1, 2, 2, 128, 128, torch.float32, False, 0, 0.0, 0.0, False),
    "t7_bf16": (2, 7, 2, 2, 128, 128, torch.bfloat16, False, 0, 0.0, 0.0, False),
    "sliding_f32": (2, 4, 1, 2, 128, 128, torch.float32, False, 9, 0.0, 0.0, False),
    "gemma_f32": (2, 4, 2, 2, 128, 128, torch.float32, False, 48, 32.0 ** -0.5, 50.0,
                  False),
    "q8_t1_f32": (2, 1, 2, 2, 128, 128, torch.float32, True, 0, 0.0, 0.0, False),
    "q8_t7_bf16": (2, 7, 2, 2, 128, 128, torch.bfloat16, True, 0, 0.0, 0.0, False),
    "tree_f32": (2, 10, 2, 2, 128, 128, torch.float32, False, 0, 0.0, 0.0, True),
    "tree_gemma_q8_f32": (2, 10, 2, 2, 128, 128, torch.float32, True, 64, 32.0 ** -0.5,
                          50.0, True),
    "page16_dh64_bf16": (3, 7, 1, 4, 64, 16, torch.bfloat16, False, 0, 0.0, 0.0, False),
    "page256_dh256_f32": (2, 3, 4, 1, 256, 256, torch.float32, True, 0, 0.0, 0.0, False),
    "row_tiles_bf16": (1, 16, 8, 2, 128, 128, torch.bfloat16, False, 0, 0.0, 0.0, False),
    # long rows (many chunks on every block of the split) at the row
    # positions given last, and rows whose window leaves one chunk visible
    "long_t1_bf16": (2, 1, 1, 4, 128, 128, torch.bfloat16, False, 0, 0.0, 0.0, False,
                     (2100, 1500)),
    "long_q8_t7_page16_bf16": (2, 7, 1, 4, 128, 16, torch.bfloat16, True, 0, 0.0, 0.0, False,
                               (2090, 2047)),
    "long_g4_softcap_page256_dh64_f32": (1, 4, 4, 2, 64, 256, torch.float32, False, 0, 0.0,
                                         50.0, False, (3000,)),
    "long_tree_q8_f32": (2, 10, 2, 2, 128, 128, torch.float32, True, 0, 0.0, 0.0, True,
                         (2050, 1111)),
    "one_chunk_window_bf16": (2, 1, 1, 4, 128, 128, torch.bfloat16, False, 16, 0.0, 0.0, False,
                              (2015, 991)),
    "one_chunk_window_q8_bf16": (2, 1, 1, 4, 128, 128, torch.bfloat16, True, 16, 0.0, 0.0,
                                    False, (2015, 991)),
    # pages of 12 and 20 slots: K3's scale runs are then not 16-byte copies
    "q8_page12_t1_bf16": (2, 1, 1, 4, 128, 12, torch.bfloat16, True, 0, 0.0, 0.0, False),
    "q8_page12_tree_f32": (2, 10, 2, 2, 128, 12, torch.float32, True, 0, 0.0, 0.0, True),
    "q8_page20_t7_bf16": (2, 7, 2, 2, 128, 20, torch.bfloat16, True, 0, 0.0, 0.0, False),
    "long_q8_page12_t7_bf16": (2, 7, 1, 4, 128, 12, torch.bfloat16, True, 0, 0.0, 0.0, False,
                               (2090, 2047)),
    # three batch rows of other lengths, for row invariance
    "rows3_t7_g2_bf16": (3, 7, 2, 2, 128, 128, torch.bfloat16, False, 0, 0.0, 0.0, False,
                         (1000, 150, 33)),
    "rows3_q8_t1_bf16": (3, 1, 1, 2, 128, 16, torch.bfloat16, True, 0, 0.0, 0.0, False,
                         (2100, 300, 40)),
    "rows3_tree_f32": (3, 10, 2, 2, 128, 128, torch.float32, False, 0, 0.0, 0.0, True,
                       (700, 90, 33)),
    # the 7B heads: alone, a row's blocks form clusters of 8; beside three
    # others, of fewer (the launch fits the card in one wave)
    "rows4_7b_heads_bf16": (4, 1, 1, 32, 128, 128, torch.bfloat16, False, 0, 0.0, 0.0, False,
                            (391, 350, 300, 377)),
    "rows4_7b_heads_q8_t7_bf16": (4, 7, 1, 32, 128, 128, torch.bfloat16, True, 0, 0.0, 0.0,
                                  False, (1900, 350, 300, 377)),
}


def _paged_case(name, gen):
    """(q, kv pair, positions, kernel kwargs) for a ``_PCASES`` entry: rows
    mapped to scrambled disjoint page runs of a capacity of 256 slots (more
    for long rows), the first 200 slots (or up to the last row's frontier)
    written, and with a tree three depths of three chains past each row's
    frontier. Rows sit at 150, 90 and 33 unless the entry gives them."""
    from layerskip_tpu_torch.ops.paged_kv import init_paged_group
    from layerskip_tpu_torch.config import tiny_config

    b, t, g, hkv, dh, page, dtype, quant, window, scale, cap, tree = _PCASES[name][:12]
    rows = _PCASES[name][12] if len(_PCASES[name]) > 12 else (150, 90, 33)[:b]
    written = max(200, max(rows) + (10 if tree else t))
    slots = -(-written // 256) * 256
    cfg = tiny_config(num_key_value_heads=hkv, num_attention_heads=hkv * g,
                      hidden_size=hkv * g * dh, dtype=dtype)
    pool_pages, cap_pages = b * (slots // page + 1) + 3, -(-slots // page)
    group = init_paged_group(cfg, 2, b, pool_pages=pool_pages, page_size=page, capacity=slots,
                             prompt_bucket=16, quant=quant, device="cuda")
    perm = torch.randperm(pool_pages, generator=torch.Generator().manual_seed(5))
    for r in range(b):
        group.k.table[r, :cap_pages] = perm[r * cap_pages:(r + 1) * cap_pages].to(torch.int32)
    k, v = group.k[1], group.v[1]  # one layer of a stacked pool
    ctx = torch.tensor(rows, device="cuda")
    k.write(torch.randn(b, written, hkv, dh, generator=gen, device="cuda").to(dtype), 0)
    v.write(torch.randn(b, written, hkv, dh, generator=gen, device="cuda").to(dtype), 0)
    kw = dict(q_heads_per_kv=g, sliding_window=window, score_scale=scale, logit_softcap=cap)
    if tree:  # t = 1 + 3 * 3: the root, then 3 depths of 3 chains
        scratch = ctx + 1
        for d in range(3):
            k.write(torch.randn(b, 3, hkv, dh, generator=gen, device="cuda").to(dtype),
                    scratch + 3 * d)
            v.write(torch.randn(b, 3, hkv, dh, generator=gen, device="cuda").to(dtype),
                    scratch + 3 * d)
        offs = torch.tensor([0] + [1 + d for d in range(3) for _ in range(3)], device="cuda")
        pos = ctx[:, None] + offs
        chain = torch.tensor([-1] + [c for _ in range(3) for c in range(3)], device="cuda")
        kw.update(tree_chain=chain.expand(b, t), tree_scratch=scratch, tree_fanout=3)
    else:
        pos = ctx[:, None] + torch.arange(t, device="cuda")
    q = torch.randn(b, t, hkv * g, dh, generator=gen, device="cuda").to(dtype)
    return q, k, v, pos, kw


def _paged_call(k, v, plain=False):
    from layerskip_tpu_torch.ops.cuda import paged_decode as tpd

    suffix = "_plain" if plain else ""
    if hasattr(k, "scale"):
        fn = getattr(tpd, "paged_decode_attention_q8" + suffix)
        return lambda q, pos, **kw: fn(q, k.pool, k.scale, v.pool, v.scale, k.table, pos,
                                       **kw)
    fn = getattr(tpd, "paged_decode_attention" + suffix)
    return lambda q, pos, **kw: fn(q, k.pool, v.pool, k.table, pos, **kw)


@pytest.mark.parametrize("name", sorted(_PCASES))
def test_paged_kernel_matches_plain(cuda, name):
    from layerskip_tpu_torch.ops.cuda import paged_decode as tpd

    q, k, v, pos, kw = _paged_case(name, cuda)
    fn = tpd.paged_decode_attention_q8 if hasattr(k, "scale") else tpd.paged_decode_attention
    before = fn.launches
    got = _paged_call(k, v)(q, pos, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = _paged_call(k, v, plain=True)(q, pos, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    tol = 5e-3 if q.dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("name", ["t7_bf16", "q8_t7_bf16", "tree_gemma_q8_f32",
                                  "long_t1_bf16", "long_q8_t7_page16_bf16",
                                  "long_q8_page12_t7_bf16"])
def test_paged_kernels_are_deterministic(cuda, name):
    """The partials merge in a fixed order: repeated calls give the same bits."""
    q, k, v, pos, kw = _paged_case(name, cuda)
    call = _paged_call(k, v)
    first = call(q, pos, **kw)
    for _ in range(3):
        assert torch.equal(call(q, pos, **kw), first)


def _row_kw(kw, r):
    """The kernel kwargs of batch row r alone."""
    out = dict(kw)
    if "tree_chain" in kw:
        out.update(tree_chain=kw["tree_chain"][r:r + 1], tree_scratch=kw["tree_scratch"][r:r + 1])
    return out


@pytest.mark.parametrize("name", ["rows3_t7_g2_bf16", "rows3_q8_t1_bf16", "rows3_tree_f32",
                                  "page16_dh64_bf16", "rows4_7b_heads_bf16",
                                  "rows4_7b_heads_q8_t7_bf16"])
def test_paged_kernels_are_row_invariant(cuda, name):
    """Each batch row run alone equals the same row inside B = 3 or 4 beside
    rows of other lengths, bit for bit, also where the two launches split
    the rows over clusters of different sizes."""
    q, k, v, pos, kw = _paged_case(name, cuda)
    full = _paged_call(k, v)(q, pos, **kw)
    for r in range(q.shape[0]):
        kr, vr = (dataclasses.replace(x, table=x.table[r:r + 1]) for x in (k, v))
        alone = _paged_call(kr, vr)(q[r:r + 1], pos[r:r + 1], **_row_kw(kw, r))
        assert torch.equal(full[r], alone[0]), r


@pytest.mark.parametrize("name", ["t7_bf16", "q8_t7_bf16", "long_t1_bf16", "sliding_f32"])
def test_paged_query_rows_are_independent(cuda, name):
    """Query row t of a T-row call (a verify window) equals a one-row call
    (a draft step) at its position, bit for bit: a row's sums never depend
    on the other rows of its block."""
    q, k, v, pos, kw = _paged_case(name, cuda)
    call = _paged_call(k, v)
    full = call(q, pos, **kw)
    for t in range(q.shape[1]):
        assert torch.equal(call(q[:, t:t + 1], pos[:, t:t + 1], **kw)[:, 0], full[:, t]), t


def _poison_invisible(q, k, v, pos, kw):
    """Overwrite every pool slot that no query row of any batch row can see
    (slots past each row's frontier or before its window, unmapped and
    trash pages) with 1e4 in K and -3e4 in V (int8 pools: 127 / -128 with
    scales 1e4 / -3e4)."""
    from layerskip_tpu_torch.ops.cuda import paged_decode as tpd

    n_pages, _, page, _ = k.pool.shape
    table = k.table.long()
    qpos, chain, scratch, fanout, window = tpd._rows(
        q, pos, kw.get("tree_chain"), kw.get("tree_scratch"), kw.get("tree_fanout", 0),
        kw.get("sliding_window", 0))
    vis = tpd._visible(qpos.long(), table.shape[1] * page, window, chain, scratch,
                       fanout).any(1)  # [B, S]
    slot = torch.arange(table.shape[1] * page, device=q.device)
    flat = table[:, slot // page] * page + slot % page  # pool slot of each [B, S]
    seen = torch.zeros(n_pages * page, dtype=torch.bool, device=q.device)
    seen[flat[vis]] = True
    hidden = ~seen.view(n_pages, page)
    assert hidden.any()
    for x, val, code in ((k, 1e4, 127), (v, -3e4, -128)):
        if hasattr(x, "scale"):
            x.pool.transpose(1, 2)[hidden] = code
            x.scale.transpose(1, 2)[hidden] = val
        else:
            x.pool.transpose(1, 2)[hidden] = val


@pytest.mark.parametrize("name", ["t7_bf16", "sliding_f32", "q8_t7_bf16", "tree_f32",
                                  "page16_dh64_bf16", "one_chunk_window_bf16",
                                  "one_chunk_window_q8_bf16", "long_q8_t7_page16_bf16",
                                  "q8_page20_t7_bf16"])
def test_paged_kernels_ignore_keys_no_query_sees(cuda, name):
    """The output is unchanged, bit for bit, when every key no query row can
    see (past the frontier, before the window, in trash pages) is
    overwritten with large values."""
    q, k, v, pos, kw = _paged_case(name, cuda)
    call = _paged_call(k, v)
    before = call(q, pos, **kw)
    _poison_invisible(q, k, v, pos, kw)
    assert torch.equal(call(q, pos, **kw), before)


def test_paged_split_geometry_matches_the_library(cuda):
    """The chunk size and split count the CPU tests' model of the kernels'
    split-and-merge uses are the compiled kernels' own."""
    import ctypes

    from layerskip_tpu_torch.ops.cuda import paged_decode as tpd
    from layerskip_tpu_torch.ops.cuda.build import load_library

    lib = load_library("paged_decode")
    lib.paged_decode_chunk_keys.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.paged_decode_chunk_keys.restype = ctypes.c_int
    assert lib.paged_decode_splits() == tpd.SPLITS
    for code, dtype in ((0, torch.float32), (1, torch.bfloat16), (2, torch.int8)):
        for dh in tpd.HEAD_DIMS:
            assert lib.paged_decode_chunk_keys(code, dh) == tpd.chunk_keys(dh, dtype), (dtype, dh)


def test_paged_kernels_refuse_what_they_do_not_take(cuda):
    from layerskip_tpu_torch.ops.cuda import paged_decode as tpd

    q, k, v, pos, kw = _paged_case("t1_f32", cuda)
    q8, k8, v8, _, _ = _paged_case("q8_t1_f32", cuda)
    kw = dict(q_heads_per_kv=2)
    q17 = torch.randn(2, 17, 4, 128, device="cuda")
    bad = [
        lambda: tpd.paged_decode_attention(q.bfloat16(), k.pool, v.pool, k.table, pos, **kw),
        lambda: tpd.paged_decode_attention(q17, k.pool, v.pool, k.table,
                                           torch.arange(17, device="cuda"), **kw),
        lambda: tpd.paged_decode_attention(q[..., :96].contiguous(), k.pool[..., :96].contiguous(),
                                           v.pool[..., :96].contiguous(), k.table, pos, **kw),
        lambda: tpd.paged_decode_attention(q, k.pool, v.pool, k.table.long(), pos, **kw),
        lambda: tpd.paged_decode_attention(q, k.pool, v.pool, k.table, pos, q_heads_per_kv=3),
        lambda: tpd.paged_decode_attention(q, k.pool, v.pool, k.table.cpu(), pos, **kw),
        lambda: tpd.paged_decode_attention(q8, k8.pool, v8.pool, k8.table, pos, **kw),
        lambda: tpd.paged_decode_attention_q8(q8, k8.pool, k8.scale.float(), v8.pool, v8.scale,
                                              k8.table, pos, **kw),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


def _session_engine():
    """A small fp32 Llama (Dh 128, G 2) whose weights are scaled up so its
    greedy stream varies (at std 0.02 it repeats one token)."""
    from layerskip_tpu_torch.config import tiny_config
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models.params import init_params

    cfg = tiny_config(hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
                      intermediate_size=256, vocab_size=256, max_position_embeddings=512)
    params = init_params(cfg, seed=3, device="cuda")
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        getattr(params.layers, name).mul_(7.5)
    params.embed.mul_(15.0)
    params.lm_head.mul_(7.5)
    return Engine(params, cfg, device="cuda")


def _serve_paged(eng, kv_quant, prompts, budgets, eos, page_size=16):
    """Every request through a paged session (4 slots, pages of 16 unless
    given, 1024 pool slots, bucket 64), inserted as slots free; ->
    ({request: tokens}, {request: (matches, drafts)}, session)."""
    from layerskip_tpu_torch.config import GenerationConfig

    gen = GenerationConfig(max_steps=24, sample=False, generation_strategy="self_speculative",
                           exit_layer=2, num_speculations=3, kv_quant=kv_quant)
    session = eng.continuous_session(gen, batch=4, prompt_bucket=64, eos_ids=eos,
                                     paged_pool_pages=1024 // page_size, page_size=page_size)
    got, counts, owner, queue = {}, {}, {}, list(range(len(prompts)))
    while queue or session.has_active():
        slots = session.free_slots()[:len(queue)]
        if slots:
            take = [queue.pop(0) for _ in slots]
            session.insert(slots, [prompts[i] for i in take],
                           max_tokens=[budgets[i] for i in take])
            owner.update(zip(slots, take))
        for row, toks, _ in session.step(max_rounds=2):
            got[owner[row]] = toks
            counts[owner[row]] = (int(session.state.matches[row]),
                                  int(session.state.drafts[row]))
    return got, counts, session


def _assert_equals_solo(eng, kv_quant, prompts, budgets, page_size=16):
    """Each request's paged-session stream == its solo AR stream; on a
    mismatch, the message gives the first differing token and the solo
    stream's teacher-forced top-2 logit gap there (a gap near fp32 rounding
    would be a tie, not a fault)."""
    from layerskip_tpu_torch.config import GenerationConfig
    from layerskip_tpu_torch.generation.engine import postprocess_output
    from layerskip_tpu_torch.models import llama
    from layerskip_tpu_torch.ops.kv_cache import init_kv_cache, init_quant_kv_cache

    eos = (eng.cfg.vocab_size + 7,)
    got, _, _ = _serve_paged(eng, kv_quant, prompts, budgets, eos, page_size)
    for i, p in enumerate(prompts):
        ar = GenerationConfig(max_steps=budgets[i], sample=False, kv_quant=kv_quant)
        want = postprocess_output(eng.generate(p, ar, eos_ids=eos), eos, budgets[i])
        if got[i] == want:
            continue
        j = next((n for n, (a, b) in enumerate(zip(got[i], want)) if a != b),
                 min(len(got[i]), len(want)))
        ids = torch.tensor([p + want], device="cuda")
        init = init_quant_kv_cache if kv_quant else init_kv_cache
        with torch.inference_mode():
            logits = llama.forward(eng.params, eng.cfg, ids,
                                   init(eng.cfg, 1, ids.shape[1], device="cuda"), 0).logits
        top2 = logits[0, len(p) - 1 + j].topk(2).values
        raise AssertionError(f"request {i}: first differs at token {j} of {len(want)}; solo "
                             f"top-2 gap there {float(top2[0] - top2[1]):.3g}")


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_session_equals_solo_through_the_kernels(cuda, kv_quant):
    """fp32 greedy: a paged continuous session (4 slots, requests joining
    and leaving) emits exactly each request's solo AR stream (with the int8
    cache for the int8 pool), and every draft and verify attention call over
    the pool launches K2 (K3 with the int8 pool)."""
    from layerskip_tpu_torch.ops.cuda import paged_decode as tpd

    eng = _session_engine()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, 256, size=n).tolist() for n in (40, 7, 60, 23, 51, 12)]
    kernel = tpd.paged_decode_attention_q8 if kv_quant else tpd.paged_decode_attention
    before = kernel.launches
    _assert_equals_solo(eng, kv_quant, prompts, [24, 9, 17, 24, 5, 20])
    assert kernel.launches > before


@pytest.mark.parametrize("page", [12, 20])
def test_paged_session_odd_pages_equals_solo_through_the_kernels(cuda, page):
    """The same with the int8 cache at pages of 12 and 20 slots, which K3
    takes like any other page size (the JAX package serves them)."""
    from layerskip_tpu_torch.ops.cuda import paged_decode as tpd

    eng = _session_engine()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, 256, size=n).tolist() for n in (40, 7, 60, 23, 51, 12)]
    before = tpd.paged_decode_attention_q8.launches
    _assert_equals_solo(eng, True, prompts, [24, 9, 17, 24, 5, 20], page_size=page)
    assert tpd.paged_decode_attention_q8.launches > before


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("seed", [2, 3, 4])
def test_paged_session_equals_solo_more_prompts(cuda, seed, kv_quant):
    """The same on other prompt sets: six requests of 5-60 tokens with
    budgets of 5-24."""
    eng = _session_engine()
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(3, 256, size=int(n)).tolist() for n in rng.integers(5, 61, size=6)]
    _assert_equals_solo(eng, kv_quant, prompts, [int(m) for m in rng.integers(5, 25, size=6)])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_session_is_deterministic(cuda, kv_quant):
    """The same requests through two fresh paged sessions give the same
    streams and counters, and the same bytes in every allocatable page of
    every layer's pool (the trash pages take colliding writes of idle rows
    and are never read)."""
    eng = _session_engine()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, 256, size=n).tolist() for n in (40, 7, 60, 23, 51, 12)]
    budgets, eos = [24, 9, 17, 24, 5, 20], (eng.cfg.vocab_size + 7,)
    runs = []
    for _ in range(2):
        got, counts, s = _serve_paged(eng, kv_quant, prompts, budgets, eos)
        pools = [t[:, :s.allocator.pool_pages].clone()
                 for g in (s.state.early, s.state.full) for kv in (g.k, g.v)
                 for t in ((kv.pool, kv.scale) if kv_quant else (kv.pool,))]
        runs.append((got, counts, pools))
    (g0, c0, p0), (g1, c1, p1) = runs
    assert g0 == g1 and c0 == c1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
