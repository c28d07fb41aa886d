"""The port's CUDA kernel on the card: against its plain version, through
the engine, and the wrapper's refusals. Every test here needs a CUDA device
and nvcc and skips without them.

This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

(``--noconftest`` because tests/conftest.py sets up JAX for the other
files.) Tolerances: fp32 outputs differ from the plain version only by
summation order (5e-3, the TPU kernel gate's); a bf16 output is one
rounding of an fp32 value below 2 in size, within 2e-2.
"""

import numpy as np
import pytest
import torch

from layerskip_tpu_torch.ops.cuda import flash_prefill as tflash

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
