"""The PyTorch port's quantization against the JAX package's, on the CPU.

The same numpy inputs go through both packages. What is held:

  * quantized weights and int8 KV entries are bit-identical (``q`` equal,
    scales equal);
  * the plain versions of K4-K7 match the JAX Pallas kernels in interpret
    mode in fp32 (within 1e-5 of the largest output: the same fp32 sums in
    another order, whose rounding grows with the outputs' size, ~89 at K =
    1792 in the int4 gate case, where a fixed 1e-4 failed on some machines
    and thread counts; one wrong nibble is off by a whole scale step, far
    above it; interpret mode computes the int4 kernels in fp32 even for
    bf16 inputs, so the int4 comparison is fp32 only) and the JAX ``_qdot``
    in bf16 (within 1.5 bf16 ulps of the largest output: both round the
    same fp32 sums once, but ``_qdot`` rounds each int4 half-sum and their
    sum in bf16);
  * quantized forward logits match in fp32 (atol 3e-4, rtol 1e-3, the
    tolerance the JAX suite holds against HF torch);
  * greedy streams, ``num_tokens`` and ``matches``/``drafts`` are EQUAL to
    the JAX engine's for int8 and int4 bases, quantized drafters and the
    int8 KV cache.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from layerskip_tpu import quant as jquant
from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.generation.engine import Engine as JEngine
from layerskip_tpu.models import llama as jllama
from layerskip_tpu.models.llama import LayerParams as JLayerParams
from layerskip_tpu.models.llama import LlamaParams as JLlamaParams
from layerskip_tpu.ops import kv_cache as jkv
from layerskip_tpu.ops import linear as jlinear
from layerskip_tpu.ops.pallas import quant_matmul as jqmm
from layerskip_tpu_torch import quant as tquant
from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation.engine import Engine
from layerskip_tpu_torch.models import llama as tllama
from layerskip_tpu_torch.models.params import params_from_numpy
from layerskip_tpu_torch.ops import kv_cache as tkv
from layerskip_tpu_torch.ops import linear as tlinear
from layerskip_tpu_torch.ops.cuda import quant_matmul as tqmm

L, D, F, V, HQ, HKV, DH = 4, 128, 128, 256, 2, 1, 64
SIZES = dict(hidden_size=D, num_attention_heads=HQ, num_key_value_heads=HKV)
PROMPT = [int(x) for x in np.random.default_rng(0).integers(3, V, size=40)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(seed=0, std=0.15, tail_eps=0.3):
    """Random dense-Llama weights (JAX field names), fp32, head_dim 64.
    ``tail_eps`` shrinks the output projections of layers >= 2 so that the
    early exit agrees with the full model often enough to accept drafts."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    tail = np.ones((L, 1, 1), np.float32)
    tail[2:] = tail_eps
    layers = dict(
        attn_norm=np.ones((L, D), np.float32), wq=n(L, HQ * DH, D),
        wk=n(L, HKV * DH, D), wv=n(L, HKV * DH, D), wo=n(L, HQ * DH, D) * tail,
        mlp_norm=np.ones((L, D), np.float32), w_gate=n(L, D, F), w_up=n(L, D, F),
        w_down=n(L, F, D) * tail,
    )
    return dict(embed=n(V, D) * 2, layers=layers,
                final_norm=np.ones(D, np.float32), lm_head=n(D, V))


def _jax_params(tree):
    return JLlamaParams(
        embed=jnp.asarray(tree["embed"]),
        layers=JLayerParams(**{k: jnp.asarray(v) for k, v in tree["layers"].items()}),
        final_norm=jnp.asarray(tree["final_norm"]), lm_head=jnp.asarray(tree["lm_head"]),
    )


def _assert_quant_equal(tq, jq):
    assert isinstance(tq, tlinear.QuantTensor)
    assert (tq.k_last, tq.group) == (jq.k_last, jq.group)
    assert tq.shape == tuple(jq.shape)
    assert np.array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert tq.q.dtype == {np.int8: torch.int8, np.uint8: torch.uint8}[np.asarray(jq.q).dtype.type]
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))


# ------------------------------------------------------ layout and quantizer


@pytest.mark.parametrize("k_last", [False, True])
def test_pack_unpack_int4_match_jax(k_last):
    rng = np.random.default_rng(1)
    q = rng.integers(-8, 8, size=(3, 32, 20) if not k_last else (3, 20, 32)).astype(np.int8)
    packed = tlinear.pack_int4(_t(q), k_last=k_last)
    want = jlinear.pack_int4(jnp.asarray(q), k_last=k_last)
    assert packed.dtype == torch.uint8
    assert np.array_equal(packed.numpy(), np.asarray(want))
    assert np.array_equal(tlinear.unpack_int4(packed, k_last).numpy(), q)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k_last", [False, True])
@pytest.mark.parametrize("stacked", [False, True])
def test_quantize_tensor_is_bit_identical(bits, k_last, stacked):
    rng = np.random.default_rng(2)
    shape = (256, 96) if not k_last else (96, 256)
    w = rng.standard_normal(((3,) if stacked else ()) + shape).astype(np.float32)
    w[..., :5] = 0.0  # all-zero channels or groups take the 1e-8 scale
    got = tquant.quantize_tensor(_t(w), k_last=k_last, bits=bits)
    _assert_quant_equal(got, jquant.quantize_tensor(jnp.asarray(w), k_last=k_last, bits=bits))
    np.testing.assert_allclose(got.dequantize(torch.float32).numpy(),
                               np.asarray(jquant.quantize_tensor(
                                   jnp.asarray(w), k_last=k_last, bits=bits
                               ).dequantize(jnp.float32)), rtol=0, atol=0)
    if stacked:  # a layer of the stack indexes as it does in the JAX package
        one = got[1]
        assert one.q.shape == got.q.shape[1:] and one.scale.shape == got.scale.shape[1:]
        # the per-layer quantizer gives the same stack
        per_layer = tquant._quantize_stacked(_t(w), 3, k_last, bits, 0)
        assert torch.equal(per_layer.q, got.q) and torch.equal(per_layer.scale, got.scale)


def test_quantize_weights_matches_jax():
    w = np.random.default_rng(3).standard_normal((64, 48)).astype(np.float32)
    q, s = tqmm.quantize_weights(_t(w))
    jq, js = jqmm.quantize_weights(jnp.asarray(w))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ------------------------------------------------------ plain kernel versions

# the TPU kernel gate's cases (scripts/kernel_gate.py): (M, K, N, bits, k_last)
_GATE = {
    "quant_matmul": (64, 256, 384, 8, False),
    "quant_matmul_t": (16, 256, 192, 8, True),
    "int4_matmul": (1, 1792, 768, 4, False),
    "int4_matmul_t": (7, 1024, 512, 4, True),
}


def _gate_inputs(name, dtype):
    m, k, n, bits, k_last = _GATE[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k) if k_last else (k, n)).astype(np.float32)
    jq = jquant.quantize_tensor(jnp.asarray(w), k_last=k_last, bits=bits,
                                group=128 if bits == 4 else 0)
    tq = tquant.quantize_tensor(_t(w), k_last=k_last, bits=bits,
                                group=128 if bits == 4 else 0)
    jx = jnp.asarray(x, dtype)
    tx = _t(x).to({jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype])
    return jx, jq, tx, tq


def _jax_kernel(name, x, qt):
    if name == "quant_matmul":
        return jqmm.quant_matmul(x, qt.q, qt.scale, block_m=32, block_n=128,
                                 block_k=128, interpret=True)
    if name == "quant_matmul_t":
        return jqmm.quant_matmul_t(x, qt.q, qt.scale, block_m=8, block_n=128,
                                   block_k=128, interpret=True)
    if name == "int4_matmul":  # ragged K tail: kp 896 in blocks of 512
        return jqmm.int4_matmul(x, qt.q, qt.scale, group=qt.group, block_n=256,
                                block_kp=512, interpret=True)
    return jqmm.int4_matmul_t(x, qt.q, qt.scale, group=qt.group, block_n=256,
                              block_kp=448, interpret=True)


def _plain(name, x, qt):
    fn = getattr(tqmm, f"{name}_plain")
    return fn(x, qt.q, qt.scale, group=qt.group) if qt.group else fn(x, qt.q, qt.scale)


@pytest.mark.parametrize("name", sorted(_GATE))
def test_plain_kernel_matches_pallas_interpret_fp32(name):
    jx, jq, tx, tq = _gate_inputs(name, jnp.float32)
    got = _plain(name, tx, tq)
    want = np.asarray(_jax_kernel(name, jx, jq))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("name", sorted(_GATE))
def test_plain_kernel_matches_jax_qdot_bf16(name):
    jx, jq, tx, tq = _gate_inputs(name, jnp.bfloat16)
    got = _plain(name, tx, tq)
    want = np.asarray(jlinear._qdot(jx, jq).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * np.abs(want).max()  # one bf16 ulp of the largest output
    np.testing.assert_allclose(got.float().numpy(), want, atol=1.5 * ulp, rtol=0)


def test_wrappers_take_the_plain_version_on_cpu():
    for name in sorted(_GATE):
        _, _, tx, tq = _gate_inputs(name, jnp.float32)
        fn = getattr(tqmm, name)
        before = fn.launches
        got = fn(tx, tq.q, tq.scale, group=tq.group) if tq.group else fn(tx, tq.q, tq.scale)
        assert torch.equal(got, _plain(name, tx, tq))
        assert fn.launches == before  # no kernel launch on the CPU
    # apply_weight/apply_weight_t route by orientation and width
    x = torch.randn(3, 5, 256)
    for bits in (8, 4):
        for k_last, apply in ((False, tlinear.apply_weight), (True, tlinear.apply_weight_t)):
            w = torch.randn((96, 256) if k_last else (256, 96))
            qt = tquant.quantize_tensor(w, k_last=k_last, bits=bits)
            dense = x @ (qt.dequantize(torch.float32).T if k_last else qt.dequantize(torch.float32))
            torch.testing.assert_close(apply(x, qt), dense, atol=1e-4, rtol=0)


# ------------------------------------- K4-K7 on the tensor cores: the K split

# the gate's cases and one of the 7B K of w_down (11008, eight slices of
# 21-22 tiles), for both weight layouts: (M, K, N, bits, k_last)
_SPLIT = {
    "quant_matmul": _GATE["quant_matmul"],
    "int4_matmul": _GATE["int4_matmul"],
    "quant_matmul_t": _GATE["quant_matmul_t"],
    "int4_matmul_t": _GATE["int4_matmul_t"],
    "quant_matmul_k11008": (3, 11008, 128, 8, False),
    "int4_matmul_k11008": (3, 11008, 128, 4, False),
    "quant_matmul_t_k11008": (3, 11008, 128, 8, True),
    "int4_matmul_t_k11008": (3, 11008, 128, 4, True),
}


def _split_inputs(name, dtype):
    if name in _GATE:
        return _gate_inputs(name, dtype)
    m, k, n, bits, k_last = _SPLIT[name]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k) if k_last else (k, n)).astype(np.float32)
    group = 128 if bits == 4 else 0
    jq = jquant.quantize_tensor(jnp.asarray(w), k_last=k_last, bits=bits, group=group)
    tq = tquant.quantize_tensor(_t(w), k_last=k_last, bits=bits, group=group)
    tx = _t(x).to({jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype])
    return jnp.asarray(x, dtype), jq, tx, tq


def _step_k(k_last):
    """The K offsets inside a TC_TILE-element tile that each of its four
    MMA steps (k16) takes, in slot order. [K, N] (K5/K6): step s takes
    16s .. 16s + 15. [N, K] (K4/K7): lane c of a quad reads K 16c .. 16c +
    15 of a weight row at once, and step s gives slots 2c, 2c + 1 the K
    16c + 4s + {0, 1} and slots 2c + 8, 2c + 9 the K 16c + 4s + {2, 3}."""
    if not k_last:
        return [list(range(16 * s, 16 * s + 16)) for s in range(4)]
    return [[16 * ((slot % 8) // 2) + 4 * s + 2 * (slot // 8) + slot % 2 for slot in range(16)]
            for s in range(4)]


def _kn_split(x, qt):
    """The tensor-core route of K4-K7 (csrc/quant_matmul.cu) modelled in
    torch: the weight as the kernel dequantizes it (int8 exactly; int4
    rounded to x's dtype), K in tiles of ``TC_TILE``, each tile in four
    MMA steps of 16 K (``_step_k``: [N, K] weights permute K inside the
    tile), each step's products added to the fp32 sum of its slice; slice
    s of ``tc_slices(K)`` sums tiles [s * T // S, (s + 1) * T // S), the
    slices' sums are added in slice order, int8's scale goes on the total,
    one rounding."""
    k = x.shape[1]
    w = (tqmm._int4_weight(qt.q, qt.scale.float(), qt.group, qt.k_last, x.dtype)
         if qt.group else qt.q.float())
    if qt.k_last:
        w = w.T
    xf = x.float()
    tiles, n_slices = -(-k // tqmm.TC_TILE), tqmm.tc_slices(k)
    steps = [torch.tensor(ks) for ks in _step_k(qt.k_last)]
    total = None
    for s in range(n_slices):
        part = torch.zeros(x.shape[0], w.shape[1])
        for t in range(s * tiles // n_slices, (s + 1) * tiles // n_slices):
            for ks in steps:
                ks = ks + t * tqmm.TC_TILE
                ks = ks[ks < k]  # x is zero past K
                part = part + xf[:, ks] @ w[ks]
        total = part if total is None else total + part
    if not qt.group:
        total = total * qt.scale.float()
    return total.to(x.dtype)


def test_kn_split_geometry_mirrors_the_source():
    """The Python constants are the source's, the slices tile K exactly with
    at least TC_MIN_TILES tiles each once K splits, the 7B products split
    into eight, and each MMA step of the [N, K] route takes 16 distinct K
    of its tile, a lane's 4 consecutive ones in a step."""
    src = (Path(tqmm.__file__).resolve().parents[2] / "csrc" / "quant_matmul.cu").read_text()
    for name, value in (("kTcKT", tqmm.TC_TILE), ("kTcMaxSlices", tqmm.TC_MAX_SLICES),
                        ("kTcMinTiles", tqmm.TC_MIN_TILES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    for k in (1, 63, 64, 256, 300, 1024, 1536, 1792, 4096, 11008, 14336):
        tiles, n = -(-k // tqmm.TC_TILE), tqmm.tc_slices(k)
        bounds = [s * tiles // n for s in range(n + 1)]
        assert bounds[0] == 0 and bounds[-1] == tiles and 1 <= n <= tqmm.TC_MAX_SLICES
        assert n == 1 or min(np.diff(bounds)) >= tqmm.TC_MIN_TILES, k
    assert tqmm.tc_slices(4096) == tqmm.tc_slices(11008) == 8
    for k_last in (False, True):
        steps = _step_k(k_last)
        assert sorted(sum(steps, [])) == list(range(tqmm.TC_TILE))
    assert _step_k(False) == [list(range(16 * s, 16 * s + 16)) for s in range(4)]
    for s, ks in enumerate(_step_k(True)):  # slots 2c, 2c + 1, 2c + 8, 2c + 9 of lane c
        for c in range(4):
            run = [ks[2 * c], ks[2 * c + 1], ks[2 * c + 8], ks[2 * c + 9]]
            assert run == list(range(16 * c + 4 * s, 16 * c + 4 * s + 4)), (s, c, ks)


@pytest.mark.parametrize("name", sorted(_SPLIT))
def test_kn_split_model_equals_plain_and_pallas_fp32(name):
    jx, jq, tx, tq = _split_inputs(name, jnp.float32)
    got = _kn_split(tx, tq).numpy()
    want = _plain(name.split("_k")[0], tx, tq).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    pallas = np.asarray(_jax_kernel(name.split("_k")[0], jx, jq))
    np.testing.assert_allclose(got, pallas, atol=1e-5 * np.abs(pallas).max(), rtol=0)


@pytest.mark.parametrize("name", sorted(_SPLIT))
def test_kn_split_model_equals_plain_bf16(name):
    """In bf16 the model and the plain version round the same fp32 sum,
    taken in another order, once: within one bf16 ulp of the largest
    output."""
    _, _, tx, tq = _split_inputs(name, jnp.bfloat16)
    got = _kn_split(tx, tq).float().numpy()
    want = _plain(name.split("_k")[0], tx, tq).float().numpy()
    np.testing.assert_allclose(got, want, atol=2.0 ** -7 * np.abs(want).max(), rtol=0)


# ------------------------------------------------------ int8 KV cache


@pytest.mark.parametrize("per_row", [False, True])
def test_quant_kv_write_is_bit_identical(per_row):
    rng = np.random.default_rng(4)
    b, s, h, dh, t = 3, 20, 2, 16, 5
    new = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    new[0, 0, 0] = 0.0  # an all-zero head takes the 1e-8 scale
    pos = np.array([0, 7, 17]) if per_row else 4  # 17 clamps to S - T
    jbuf = jkv.QuantKV(q=jnp.zeros((b, s, h, dh), jnp.int8),
                       scale=jnp.zeros((b, s, h), jnp.bfloat16))
    jbuf = jbuf.write(jnp.asarray(new), jnp.asarray(pos, jnp.int32))
    tbuf = tkv.QuantKV.zeros((b, s, h, dh), "cpu")
    tkv.write_kv(tbuf, tbuf, _t(new), _t(new), _t(pos) if per_row else pos)
    assert np.array_equal(tbuf.q.numpy(), np.asarray(jbuf.q))
    np.testing.assert_array_equal(tbuf.scale.float().numpy(),
                                  np.asarray(jbuf.scale.astype(jnp.float32)))
    np.testing.assert_array_equal(tbuf.dequantize(torch.float32).numpy(),
                                  np.asarray(jbuf.dequantize(jnp.float32)))
    cache = tkv.init_quant_kv_cache(tiny_config(**SIZES), 2, 8, device="cpu")
    assert cache.k.shape == (L, 2, 8, HKV, DH) and cache.k[1].scale.shape == (2, 8, HKV)


# ------------------------------------------------------ model and engines


@pytest.fixture(scope="module")
def tree():
    return _tree()


@pytest.mark.parametrize("bits,head", [(8, False), (4, False), (8, True), (4, True)])
def test_quantized_forward_logits_match_jax(tree, bits, head):
    jp = jquant.quantize_llama_params(_jax_params(tree), quantize_lm_head=head, bits=bits)
    # the JAX package's quantized params cross over as they are, and the
    # port's own quantizer gives the same ones
    converted = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    own = tquant.quantize_llama_params(params_from_numpy(tree, device="cpu"),
                                       quantize_lm_head=head, bits=bits)
    for f in tquant._QUANT_FIELDS:
        _assert_quant_equal(getattr(own.layers, f), getattr(jp.layers, f))
        _assert_quant_equal(getattr(converted.layers, f), getattr(jp.layers, f))
    if head:
        _assert_quant_equal(own.lm_head, jp.lm_head)
        _assert_quant_equal(converted.lm_head, jp.lm_head)
    assert tquant.quantized_bytes(own) == jquant.quantized_bytes(jp)
    ids = np.random.default_rng(5).integers(3, V, size=(2, 24))
    jcfg, tcfg = jax_tiny_config(**SIZES), tiny_config(**SIZES)
    want = jllama.forward(jp, jcfg, jnp.asarray(ids), jkv.init_kv_cache(jcfg, 2, 32),
                          jnp.int32(0)).logits
    got = tllama.forward(own, tcfg, _t(ids), tkv.init_kv_cache(tcfg, 2, 32, device="cpu"),
                         0).logits
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def engines(tree):
    jp = _jax_params(tree)
    tp = params_from_numpy(tree, device="cpu")
    jcfg, tcfg = jax_tiny_config(**SIZES), tiny_config(**SIZES)
    return {
        "bf16": (JEngine(jp, jcfg), Engine(tp, tcfg, device="cpu")),
        "int8": (JEngine(jquant.quantize_llama_params(jp, bits=8), jcfg),
                 Engine(tquant.quantize_llama_params(tp, bits=8), tcfg, device="cpu")),
        "int4": (JEngine(jquant.quantize_llama_params(jp, bits=4), jcfg),
                 Engine(tquant.quantize_llama_params(tp, bits=4), tcfg, device="cpu")),
    }


_RUNS = {  # name: (engine, strategy knobs)
    "int8_ar": ("int8", {}),
    "int8_spec": ("int8", dict(exit_layer=2, num_speculations=4)),
    "int4_ar": ("int4", {}),
    "int4_spec": ("int4", dict(exit_layer=1, num_speculations=3)),
    "dq8": ("bf16", dict(exit_layer=2, num_speculations=4, draft_quant=8)),
    "dq4": ("bf16", dict(exit_layer=2, num_speculations=4, draft_quant=4)),
    "dq4_head": ("bf16", dict(exit_layer=2, num_speculations=4, draft_quant=4,
                              draft_quant_head=True)),
    "dq4_mlp_only": ("bf16", dict(exit_layer=2, num_speculations=4, draft_quant=4,
                                  draft_quant_mlp_only=True)),
    "kv_quant_ar": ("bf16", dict(kv_quant=True)),
    "kv_quant_spec": ("bf16", dict(exit_layer=3, num_speculations=6, kv_quant=True)),
}


def _gen_cfg(cls, max_steps=28, **kw):
    strategy = "self_speculative" if "exit_layer" in kw else "autoregressive"
    return cls(max_steps=max_steps, sample=False, generation_strategy=strategy, **kw)


@pytest.mark.parametrize("name", sorted(_RUNS))
def test_greedy_quantized_generate_equals_jax(engines, name):
    which, kw = _RUNS[name]
    je, te = engines[which]
    jout = je.generate([PROMPT[:23], PROMPT], _gen_cfg(JGenerationConfig, **kw),
                       jax.random.PRNGKey(0))
    tout = te.generate([PROMPT[:23], PROMPT], _gen_cfg(GenerationConfig, **kw))
    n = np.asarray(jout.num_tokens)
    np.testing.assert_array_equal(tout.num_tokens.numpy(), n)
    for r in range(n.shape[0]):
        np.testing.assert_array_equal(tout.tokens[r, :n[r]].numpy(),
                                      np.asarray(jout.tokens)[r, :n[r]])
    assert (int(tout.matches), int(tout.drafts)) == (int(jout.matches), int(jout.drafts))
    if "exit_layer" in kw:
        assert 0 < int(tout.matches) <= int(tout.drafts)
    if which == "bf16" and kw.get("draft_quant"):
        # the verify judges every token with the base model: greedy == base AR
        ar = te.generate([PROMPT[:23], PROMPT], _gen_cfg(GenerationConfig))
        for r in range(n.shape[0]):
            assert torch.equal(tout.tokens[r, :n[r]], ar.tokens[r, :n[r]])


def test_draft_cache_reuse_and_invalidation(engines, tree):
    _, te = engines["bf16"]
    eng = Engine(te.params, te.cfg, device="cpu")
    cfg = _gen_cfg(GenerationConfig, max_steps=6, exit_layer=2, num_speculations=3,
                   draft_quant=8)
    eng.generate(PROMPT[:5], cfg)
    first = eng._draft_cache[(2, 8, False, False)]
    # embeddings and norms are shared with the base, the draft group is E layers
    assert first.embed is eng.params.embed and first.layers.wq.q.shape[0] == 2
    assert first.layers.attn_norm.data_ptr() == eng.params.layers.attn_norm.data_ptr()
    eng.generate(PROMPT[:7], cfg)
    assert eng._draft_cache[(2, 8, False, False)] is first  # reused across calls
    eng.params = params_from_numpy(_tree(seed=9), device="cpu")
    assert eng._draft_cache == {}  # new weights drop the stale drafter


def test_draft_quant_noop_on_quantized_base_and_on_ar(engines):
    _, qeng = engines["int8"]
    out = qeng.generate(PROMPT[:5], _gen_cfg(GenerationConfig, max_steps=6, exit_layer=2,
                                             num_speculations=3, draft_quant=8))
    assert qeng._draft_cache == {} and int(out.num_tokens[0]) == 6
    _, te = engines["bf16"]
    eng = Engine(te.params, te.cfg, device="cpu")
    out = eng.generate(PROMPT[:5], _gen_cfg(GenerationConfig, max_steps=6, draft_quant=4,
                                            draft_quant_head=True))
    assert eng._draft_cache == {} and int(out.num_tokens[0]) == 6
    plan = eng.round_plan(_gen_cfg(GenerationConfig, exit_layer=2, num_speculations=3,
                                   spec_tree_width=2, draft_quant=4, draft_quant_head=True))
    assert plan.source == "tree" and plan.draft_params is None and eng._draft_cache == {}
