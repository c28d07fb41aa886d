"""The port's CUDA kernels on the card: against their plain versions,
through the engine, and the wrappers' refusals. Every test here needs a
CUDA device and nvcc and skips without them.

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
    for bad_q, bad_kv in ((q.half(), kv.half()),  # dtype
                          (q[..., ::2], kv[..., ::2]),  # strided head_dim
                          (q, kv.cpu()),  # devices differ
                          (q[..., :96].contiguous(), kv[..., :96].contiguous())):  # Dh 96
        with pytest.raises(ValueError):
            tflash.flash_prefill_attention(bad_q, bad_kv, bad_kv, 0, q_heads_per_kv=2)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_kernels_are_row_invariant(cuda, dtype):
    """A row's output does not depend on M or on its place in the batch:
    bit-identical at M = 1, 7 and 37 (greedy AR == spec needs it)."""
    for name in ("K5_bf16", "K4_bf16", "K6_bf16", "K7_bf16"):
        fn, x, qt = _quant_case(name, cuda)
        x = torch.randn(37, x.shape[1], generator=cuda, device="cuda").to(dtype)
        full = _call(fn, x, qt)
        for rows in (x[:1], x[3:10], x[36:]):
            start = int((rows.data_ptr() - x.data_ptr()) // (x.element_size() * x.shape[1]))
            part = _call(fn, rows, qt)
            assert torch.equal(part, full[start:start + rows.shape[0]]), (name, start)


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
