"""The PyTorch port's ops against the JAX package, op by op, on the CPU.

The same numpy inputs (``np.random.default_rng``) go through the JAX
function and its port in fp32. Tolerances: 1e-5 where both sides compute the
same fp32 expression (only summation order differs); 3e-5 for the flash
kernel's plain version, whose online-softmax reference (the Pallas kernel
in interpret mode) divides by the denominator after the PV product.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from layerskip_tpu.config import RopeScaling as JRopeScaling
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.ops import attention as jattn
from layerskip_tpu.ops import kv_cache as jkv
from layerskip_tpu.ops import rmsnorm as jrms
from layerskip_tpu.ops import rope as jrope
from layerskip_tpu.ops.pallas.flash_prefill import (
    flash_prefill_attention as jax_flash_prefill,
)
from layerskip_tpu_torch.config import RopeScaling, tiny_config
from layerskip_tpu_torch.ops import attention as tattn
from layerskip_tpu_torch.ops import kv_cache as tkv
from layerskip_tpu_torch.ops import rmsnorm as trms
from layerskip_tpu_torch.ops import rope as trope
from layerskip_tpu_torch.ops.cuda import flash_prefill as tflash

ATOL = 1e-5
REPO = pathlib.Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------- rmsnorm


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches_jax(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    r = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    _close(trms.rms_norm(_t(x), _t(w), 1e-5, offset),
           jrms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset))
    got, got_h = trms.rms_norm_residual(_t(x), _t(r), _t(w), 1e-5, offset)
    want, want_h = jrms.rms_norm_residual(
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(w), 1e-5, offset)
    _close(got, want)
    _close(got_h, want_h)


# ------------------------------------------------------------------- rope

_SCALINGS = {
    "default": {},
    "llama3": dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                   high_freq_factor=4.0, original_max_position_embeddings=8192),
    "linear": dict(rope_type="linear", factor=4.0),
}


@pytest.mark.parametrize("scaling", sorted(_SCALINGS))
def test_rope_matches_jax(scaling):
    kw = dict(hidden_size=128, num_attention_heads=2, rope_theta=500000.0)
    jcfg = jax_tiny_config(rope_scaling=JRopeScaling(**_SCALINGS[scaling]), **kw)
    tcfg = tiny_config(rope_scaling=RopeScaling(**_SCALINGS[scaling]), **kw)
    inv_t, inv_j = trope.rope_inv_freq(tcfg), jrope.rope_inv_freq(jcfg)
    np.testing.assert_allclose(np.asarray(inv_t), np.asarray(inv_j), rtol=1e-6)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 64, size=(2, 7))
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    cos_t, sin_t = trope.rope_cos_sin(_t(pos), inv_t)
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(pos, jnp.int32), inv_j)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    _close(trope.apply_rope(_t(x), cos_t, sin_t),
           jrope.apply_rope(jnp.asarray(x), cos_j, sin_j))


# --------------------------------------------------------------- write_kv


@pytest.mark.parametrize("pos", [3, 13, "rows", "rows_clamped"])
def test_write_kv_matches_jax(pos):
    """Scalar and per-row frontiers; the clamped cases start past S - T,
    where dynamic_update_slice moves the block back inside the buffer."""
    rng = np.random.default_rng(2)
    buf = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    new = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    wp = {"rows": np.array([0, 9]), "rows_clamped": np.array([5, 14])}.get(pos, pos)
    want_k, want_v = jkv.write_kv(jnp.asarray(buf), jnp.asarray(buf), jnp.asarray(new),
                                  jnp.asarray(new) * 2, jnp.asarray(wp, jnp.int32))
    k, v = _t(buf.copy()), _t(buf.copy())
    got_pos = wp if isinstance(wp, int) else _t(wp)
    tkv.write_kv(k, v, _t(new), _t(new) * 2, got_pos)
    np.testing.assert_array_equal(k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))


def test_write_kv_updates_stacked_cache_in_place():
    cfg = tiny_config()
    cache = tkv.init_kv_cache(cfg, batch=2, max_len=8, device="cpu")
    new = torch.ones((2, 3, cfg.num_key_value_heads, cfg.head_dim))
    tkv.write_kv(cache.k[1], cache.v[1], new, new, 2)
    assert cache.k[1, :, 2:5].eq(1).all() and cache.k.sum() == new.sum()


# ----------------------------------------------------------- gqa_attention

# (name, T, S, past, per_row, window, runtime_window, scale, softcap)
_ATTN_CASES = [
    ("causal", 24, 24, 0, False, 0, False, None, 0.0),
    ("past_offset", 20, 48, 17, False, 0, False, None, 0.0),
    ("static_window", 24, 48, 10, False, 7, False, None, 0.0),
    ("runtime_window", 24, 48, 10, False, 7, True, None, 0.0),
    ("softcap_scale", 24, 48, 10, False, 0, False, 32.0 ** -0.5, 5.0),
    ("per_row", 5, 40, None, True, 0, False, None, 0.0),
    ("per_row_window", 5, 40, None, True, 6, True, None, 0.0),
]


# each shared-past case also runs with past_scalar set, which routes T > 16
# through the flash kernel's plain version
_ATTN_RUNS = [(c, False) for c in _ATTN_CASES] + [
    (c, True) for c in _ATTN_CASES if not c[4]]


@pytest.mark.parametrize("case,scalar_past", _ATTN_RUNS,
                         ids=[c[0] + ("-scalar_past" if sp else "") for c, sp in _ATTN_RUNS])
def test_gqa_attention_matches_jax(case, scalar_past):
    """Both dispatch routes of the port (masked path; with a scalar past and
    T > 16, the flash kernel's plain version) against JAX's masked path."""
    _, t, s, past, per_row, window, runtime, scale, cap = case
    b, hkv, g, dh = 2, 2, 2, 64
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, t, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    pos = (np.stack([np.arange(30, 30 + t), np.arange(11, 11 + t)]) if per_row
           else np.arange(past, past + t))
    jwin = jnp.int32(window) if runtime else window
    want = jattn.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos, jnp.int32),
        q_heads_per_kv=g, sliding_window=jwin, score_scale=scale, logit_softcap=cap)
    twin = torch.tensor(window) if runtime else window
    got = tattn.gqa_attention(
        _t(q), _t(k), _t(v), _t(pos), q_heads_per_kv=g,
        past_scalar=past if scalar_past else None, sliding_window=twin,
        score_scale=scale, logit_softcap=cap)
    _close(got, want)


def test_gqa_attention_tree_raises():
    q = torch.zeros((1, 2, 2, 64))
    kv = torch.zeros((1, 4, 1, 64))
    with pytest.raises(NotImplementedError):
        tattn.gqa_attention(q, kv, kv, torch.arange(2), q_heads_per_kv=2,
                            tree_meta=(torch.zeros(1, 2), 0, 2))


# ------------------------------------------ flash prefill (plain version)

# the kernel gate's cases (scripts/kernel_gate.py) at a smaller width
_FLASH_CASES = {
    "flash_prefill": dict(window=0, gemma=False),
    "flash_prefill_sliding": dict(window=64, gemma=False),
    "flash_prefill_gemma": dict(window=64, gemma=True),
}


@pytest.mark.parametrize("name", sorted(_FLASH_CASES))
def test_flash_prefill_plain_matches_jax_kernel(name):
    window, gemma = _FLASH_CASES[name]["window"], _FLASH_CASES[name]["gemma"]
    b, t, s, past, hkv, g, dh = 1, 128, 256, 100, 2, 2, 64
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, t, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    kw = dict(score_scale=32.0 ** -0.5, logit_softcap=50.0) if gemma else {}
    jwin = jnp.int32(window) if gemma else window
    want_kernel = jax_flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(past),
        q_heads_per_kv=g, sliding_window=jwin, block_q=64, block_k=64,
        interpret=True, **kw)
    want_xla = jattn.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(np.arange(past, past + t), jnp.int32),
        q_heads_per_kv=g, sliding_window=jwin, **kw)
    got = tflash.flash_prefill_attention_plain(
        _t(q), _t(k), _t(v), past, q_heads_per_kv=g, sliding_window=window, **kw)
    _close(got, want_kernel, atol=3e-5)
    _close(got, want_xla, atol=3e-5)


def test_flash_prefill_plain_fully_masked_row_is_zero():
    """A query whose position lies past every key returns 0, not a mean."""
    q = torch.randn(1, 2, 2, 64)
    kv = torch.randn(1, 4, 1, 64)
    out = tflash.flash_prefill_attention_plain(q, kv, kv, 10, q_heads_per_kv=2,
                                               sliding_window=3)
    assert torch.count_nonzero(out) == 0


def test_flash_prefill_wrapper_takes_plain_version_on_cpu():
    q, kv = torch.randn(1, 20, 2, 64), torch.randn(1, 32, 1, 64)
    before = tflash.flash_prefill_attention.launches
    got = tflash.flash_prefill_attention(q, kv, kv, 5, q_heads_per_kv=2)
    want = tflash.flash_prefill_attention_plain(q, kv, kv, 5, q_heads_per_kv=2)
    assert torch.equal(got, want)
    assert tflash.flash_prefill_attention.launches == before  # no kernel launch


# ------------------------------------------------------------ boundaries


@pytest.mark.parametrize("entry", ["Engine", "init_params", "make_random_params"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, monkeypatch):
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models import params as tparams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "Engine":
            Engine(tparams.init_params(cfg, device="cpu"), cfg)
        elif entry == "init_params":
            tparams.init_params(cfg)
        else:
            tparams.make_random_params(cfg, exit_layer=2)


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "layerskip_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch_spec.py"]
    assert len(files) > 10
    names = {p.relative_to(REPO).as_posix() for p in files}
    assert {"layerskip_tpu_torch/quant.py", "layerskip_tpu_torch/ops/linear.py",
            "layerskip_tpu_torch/ops/cuda/quant_matmul.py"} <= names
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "layerskip_tpu"), (path, mod)


def test_unported_configs_raise():
    from layerskip_tpu_torch.models.llama import check_supported

    for field, value in [("attention_bias", True), ("qk_norm", True),
                         ("num_local_experts", 4), ("post_norms", True),
                         ("rms_norm_offset", True), ("scale_embeddings", True),
                         ("final_logit_softcap", 30.0), ("hidden_act", "gelu")]:
        with pytest.raises(NotImplementedError):
            check_supported(dataclasses.replace(tiny_config(), **{field: value}))
