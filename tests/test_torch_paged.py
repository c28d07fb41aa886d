"""The port's paged KV cache, its K2/K3 plain versions and its paged
continuous sessions against the JAX package's, on the CPU in fp32.

Inputs come from numpy seeds and go through both packages. Tolerances:
the plain K2/K3 and the Pallas kernels (interpret mode) or the JAX gathered
fallback compute one function in fp32, summed in another order: atol 2e-5
as tests/test_paged_kv.py holds the Pallas kernels to the fallback, and
atol 3e-5 with rtol 1e-4 where the Gemma score math (query scale 32^-0.5,
softcap 50) widens the scores' range. Paged writes, int8 values and bf16
scales are compared bit for bit; greedy streams and counters must be equal.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu.config import tiny_config as jax_tiny_config
from layerskip_tpu.generation.engine import Engine as JEngine
from layerskip_tpu.models.llama import LayerParams as JLayerParams
from layerskip_tpu.models.llama import LlamaParams as JLlamaParams
from layerskip_tpu.ops import attention as jattn
from layerskip_tpu.ops import paged_kv as jpkv
from layerskip_tpu.ops.pallas import paged_decode as jpd
from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
from layerskip_tpu_torch.models.params import params_from_numpy
from layerskip_tpu_torch.ops import paged_kv as tpkv
from layerskip_tpu_torch.ops.cuda import paged_decode as tpd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run thousands of tiny torch ops: one intra-op thread
    keeps them fast, also when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ------------------------------------------------------------ the cache


def _tables(b, pool_pages, pg, cap, seed):
    """[B, maxp] table: rows mapped to scrambled disjoint page runs, the
    rest at the first trash page (tests/test_paged_kv.py's construction)."""
    cap_pages, trash_pages, maxp = jpkv.paged_geometry(cap, pg, prompt_bucket=16)
    table = np.full((b, maxp), pool_pages, np.int32)
    perm = np.random.RandomState(seed).permutation(pool_pages)
    for r in range(b):
        table[r, :cap_pages] = perm[r * cap_pages:(r + 1) * cap_pages]
    return table, pool_pages + trash_pages, cap_pages * pg


def _pair(b=2, pool_pages=8, pg=16, cap=48, hkv=2, dh=128, seed=0, quant=False):
    """The same empty paged buffer in both packages."""
    table, total, cap = _tables(b, pool_pages, pg, cap, seed)
    shape = (total, hkv, pg, dh)
    if quant:
        j = jpkv.PagedQuantKV(pool=jnp.zeros(shape, jnp.int8),
                              scale=jnp.zeros(shape[:-1], jnp.bfloat16),
                              table=jnp.asarray(table), capacity=cap, trash_start=cap)
        t = tpkv.PagedQuantKV(pool=torch.zeros(shape, dtype=torch.int8),
                              scale=torch.zeros(shape[:-1], dtype=torch.bfloat16),
                              table=torch.from_numpy(table), capacity=cap, trash_start=cap)
        return j, t
    j = jpkv.PagedKV(pool=jnp.zeros(shape, jnp.float32), table=jnp.asarray(table),
                     capacity=cap, trash_start=cap)
    t = tpkv.PagedKV(pool=torch.zeros(shape), table=torch.from_numpy(table),
                     capacity=cap, trash_start=cap)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_write_and_gather_equal_jax(quant):
    """Per-row, shared-frontier, page-boundary and past-capacity writes land
    on the same bytes in both packages (int8 values and bf16 scales too);
    the past-capacity write leaves every mapped slot untouched."""
    rng = np.random.default_rng(0)
    jkv, tkv = _pair(quant=quant)
    writes = [((2, 7), [0, 3]), ((2, 1), [15, 16]), ((2, 3), 30), ((2, 4), [47, 44])]
    for shape, pos in writes:
        blk = rng.standard_normal((*shape, 2, 128)).astype(np.float32) * 3
        jkv = jkv.write(jnp.asarray(blk), jnp.asarray(pos, jnp.int32))
        tkv.write(torch.from_numpy(blk), torch.tensor(pos) if isinstance(pos, list) else pos)
    np.testing.assert_array_equal(_np(tkv.pool), _np(jkv.pool))
    if quant:
        np.testing.assert_array_equal(_np(tkv.scale), _np(jkv.scale))
    np.testing.assert_array_equal(_np(tkv.gather_view(torch.float32)),
                                  _np(jkv.gather_view(jnp.float32)))
    view = tkv.gather_view(torch.float32).clone()
    tkv.write(torch.full((2, 4, 2, 128), 99.0), torch.full((2,), tkv.trash_start))
    assert torch.equal(tkv.gather_view(torch.float32)[:, :tkv.capacity],
                       view[:, :tkv.capacity])
    assert (tkv.gather_view(torch.float32)[:, tkv.trash_start:tkv.trash_start + 4] != 0).all()


def test_init_paged_group_shares_one_table():
    cfg = tiny_config(num_key_value_heads=2, num_attention_heads=4, hidden_size=256)
    jg = jpkv.init_paged_group(jax_tiny_config(num_key_value_heads=2, num_attention_heads=4,
                                               hidden_size=256),
                               3, 2, pool_pages=10, page_size=16, capacity=40,
                               prompt_bucket=20)
    tg = tpkv.init_paged_group(cfg, 3, 2, pool_pages=10, page_size=16, capacity=40,
                               prompt_bucket=20, device="cpu")
    assert tuple(tg.k.pool.shape) == tuple(jg.k.pool.shape) and tg.k.shape[0] == 3
    np.testing.assert_array_equal(tg.k.table.numpy(), np.asarray(jg.k.table)[0])
    assert tg.k.table is tg.v.table and tg.k[1].table is tg.k.table
    assert (tg.k.capacity, tg.k.trash_start) == (jg.k.capacity, jg.k.trash_start)
    other = tpkv.init_paged_group(cfg, 1, 2, 10, 16, 40, 20, table=tg.k.table, quant=True,
                                  device="cpu")
    assert other.k.table is tg.k.table and other.k.pool.dtype == torch.int8


# ------------------------------------------------------------ K2 / K3 plain


def _gate_case(t=1, g=2, window=0, gemma=False, quant=False, tree=False, pg=128,
               cap=256, ctx=(150, 90), written=200):
    """A gate case (scripts/kernel_gate.py: pools of 6 pages, capacity 256,
    200 written keys, rows at 150 and 90) built in both packages; a longer
    ``cap`` gets pools of its own size. Returns (jax kwargs, port kwargs, q
    as numpy, positions)."""
    b, hkv, dh = 2, 2, 128
    rng = np.random.default_rng(11 if tree else 4)
    slots = 6 * 128 if cap == 256 else b * cap + 256
    jk, tk = _pair(b, slots // pg, pg, cap, hkv, dh, seed=5, quant=quant)
    jv, tv = _pair(b, slots // pg, pg, cap, hkv, dh, seed=5, quant=quant)

    def write(blk, pos):
        nonlocal jk, jv
        kb, vb = (rng.standard_normal((b, blk, hkv, dh)).astype(np.float32) for _ in range(2))
        jk, jv = jk.write(jnp.asarray(kb), jnp.asarray(pos)), jv.write(jnp.asarray(vb),
                                                                        jnp.asarray(pos))
        tk.write(torch.from_numpy(kb), torch.from_numpy(pos))
        tv.write(torch.from_numpy(vb), torch.from_numpy(pos))

    ctx = np.asarray(ctx, np.int32)
    jkw = dict(q_heads_per_kv=g)
    if gemma:
        jkw.update(score_scale=32.0 ** -0.5, logit_softcap=50.0)
    if tree:
        write(151, np.zeros(2, np.int32))
        scratch = ctx + 1
        for d in range(3):
            write(3, scratch + 3 * d)
        t = 10
        offs = np.asarray([0] + [1 + d for d in range(3) for _ in range(3)], np.int32)
        chain = np.broadcast_to(np.asarray([-1] + [c for _ in range(3) for c in range(3)],
                                           np.int32), (b, t))
        window = 64 if gemma else 0
        tree_kw = dict(tree_chain=chain, tree_scratch=scratch, tree_fanout=3)
        qpos = ctx[:, None] + offs[None]
    else:
        write(written, np.zeros(2, np.int32))
        tree_kw = {}
        qpos = ctx[:, None] + np.arange(t, dtype=np.int32)[None]
    q = rng.standard_normal((b, t, hkv * g, dh)).astype(np.float32)
    jkw.update(sliding_window=jnp.int32(window) if gemma else window)
    j = dict(q=jnp.asarray(q), k=jk, v=jv, qpos=jnp.asarray(qpos),
             kw=dict(jkw, **{k: jnp.asarray(v) for k, v in tree_kw.items()
                             if k != "tree_fanout"},
                     **({"tree_fanout": 3} if tree else {})))
    tkw = dict(q_heads_per_kv=g, sliding_window=window,
               score_scale=jkw.get("score_scale", 0.0),
               logit_softcap=jkw.get("logit_softcap", 0.0),
               **{k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                      else v) for k, v in tree_kw.items()})
    t_ = dict(q=torch.from_numpy(q), k=tk, v=tv, qpos=torch.from_numpy(qpos), kw=tkw)
    return j, t_


def _jax_kernel(j, quant):
    k, v = j["k"], j["v"]
    if quant:
        return jpd.paged_decode_attention_q8(j["q"], k.pool, k.scale, v.pool, v.scale, k.table,
                                             j["qpos"], interpret=True, **j["kw"])
    return jpd.paged_decode_attention(j["q"], k.pool, v.pool, k.table, j["qpos"],
                                      interpret=True, **j["kw"])


def _jax_fallback(j):
    kw = dict(j["kw"])
    fanout = kw.pop("tree_fanout", 0)
    if fanout:
        kw["tree_meta"] = (kw.pop("tree_chain"), kw.pop("tree_scratch"), fanout)
    return jattn.gqa_attention(j["q"], j["k"].gather_view(jnp.float32),
                               j["v"].gather_view(jnp.float32), j["qpos"], **kw)


def _port_plain(t, quant):
    k, v = t["k"], t["v"]
    if quant:
        return tpd.paged_decode_attention_q8_plain(t["q"], k.pool, k.scale, v.pool, v.scale,
                                                   k.table, t["qpos"], **t["kw"])
    return tpd.paged_decode_attention_plain(t["q"], k.pool, v.pool, k.table, t["qpos"],
                                            **t["kw"])


# the gate's paged case names (scripts/kernel_gate.py:311-339)
_GATE = {
    "paged_decode_t1": dict(t=1), "paged_decode_t7": dict(t=7),
    "paged_decode_sliding": dict(t=4, g=1, window=9),
    "paged_decode_gemma": dict(t=4, g=2, window=48, gemma=True),
    "paged_decode_q8_t1": dict(t=1, quant=True), "paged_decode_q8_t7": dict(t=7, quant=True),
    "paged_decode_tree": dict(tree=True), "paged_decode_tree_q8": dict(tree=True, quant=True),
    "paged_decode_tree_gemma": dict(tree=True, gemma=True),
    "paged_decode_tree_gemma_q8": dict(tree=True, gemma=True, quant=True),
}


@pytest.mark.parametrize("name", sorted(_GATE))
def test_plain_kernels_equal_pallas_and_fallback(name):
    case = _GATE[name]
    quant, gemma = case.get("quant", False), case.get("gemma", False)
    j, t = _gate_case(**case)
    got = _port_plain(t, quant).numpy()
    tol = dict(atol=3e-5, rtol=1e-4) if gemma else dict(atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(_jax_kernel(j, quant)), **tol)
    np.testing.assert_allclose(got, np.asarray(_jax_fallback(j)), **tol)


@pytest.mark.parametrize("pg", [16, 256])
def test_plain_kernels_other_page_sizes_equal_fallback(pg):
    for quant in (False, True):
        j, t = _gate_case(t=7, quant=quant, pg=pg)
        np.testing.assert_allclose(_port_plain(t, quant).numpy(),
                                   np.asarray(_jax_fallback(j)), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["q8_t1", "q8_t7", "q8_tree", "t7"])
def test_plain_kernels_page12_equal_pallas_and_fallback(case):
    """Pages of 12 slots (not a multiple of 8: K3's scale runs are then not
    16-byte copies on the card): the plain versions equal the Pallas kernels
    and the gathered fallback, as at the gate's 128."""
    kw = {"q8_t1": dict(t=1, quant=True), "q8_t7": dict(t=7, quant=True),
          "q8_tree": dict(tree=True, quant=True), "t7": dict(t=7)}[case]
    quant = kw.get("quant", False)
    j, t = _gate_case(**kw, pg=12)
    got = _port_plain(t, quant).numpy()
    np.testing.assert_allclose(got, np.asarray(_jax_kernel(j, quant)), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(_jax_fallback(j)), atol=2e-5, rtol=1e-5)


def _split_merge(t, quant):
    """The CUDA kernels' split-and-merge (csrc/paged_decode.cu) modelled in
    torch over the plain version's masked scores: chunks of
    ``tpd.chunk_keys`` keys, virtual rank r of ``tpd.SPLITS`` takes chunks
    r, r + SPLITS, ... with an online softmax in chunk order (a chunk no
    query sees merges to nothing), and the ranks' (m, l, acc) merge in rank
    order. fp32 pools, so p is not rounded."""
    k, v, q = t["k"], t["v"], t["q"]
    kg, vg = (x.gather_view(torch.float32) for x in (k, v))
    kw = {name: t["kw"].get(name, d) for name, d in (
        ("q_heads_per_kv", 1), ("sliding_window", 0), ("tree_chain", None),
        ("tree_scratch", None), ("tree_fanout", 0), ("score_scale", 0.0),
        ("logit_softcap", 0.0))}
    scores = tpd._masked_scores(q, kg, t["qpos"], **kw)  # [B, Hkv, G, T, S]
    b, tq, hq, dh = q.shape
    chunk = tpd.chunk_keys(dh, torch.int8 if quant else torch.float32)
    n_chunks = -(-scores.shape[-1] // chunk)
    parts = []
    for rank in range(tpd.SPLITS):
        m = torch.full(scores.shape[:-1], tpd.NEG_INF)
        l = torch.zeros(scores.shape[:-1])
        acc = torch.zeros(*scores.shape[:-1], dh)
        for c in range(rank, n_chunks, tpd.SPLITS):
            sc = scores[..., c * chunk:(c + 1) * chunk]
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.where(sc > tpd.NEG_INF * 0.5, torch.exp(sc - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgtk,bkhd->bhgtd", p, vg[:, c * chunk:(c + 1) * chunk])
            m = m_new
        parts.append((m, l, acc))
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    big_l, out = torch.zeros_like(big_m), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - big_m)
        big_l = big_l + l * w
        out = out + acc * w[..., None]
    out = out / big_l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, dh)


@pytest.mark.parametrize("name", sorted(_GATE))
def test_split_merge_model_equals_plain_and_pallas(name):
    """The kernels' split-and-merge over the gate's cases equals the plain
    version (one softmax over all keys) and the Pallas kernel; rows at 90
    and 150 leave whole chunks and whole ranks masked."""
    case = _GATE[name]
    quant = case.get("quant", False)
    j, t = _gate_case(**case)
    got = _split_merge(t, quant).numpy()
    np.testing.assert_allclose(got, _port_plain(t, quant).numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(_jax_kernel(j, quant)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["causal_t1", "window_t4", "q8_t7"])
def test_split_merge_model_long_row(case):
    """The same on rows of 2047 and 1990 keys (128 chunks of 16 fp32 keys,
    32 of 64 int8 keys: many per rank); with a window of 100 every chunk
    but the last few is masked."""
    kw = {"causal_t1": dict(t=1), "window_t4": dict(t=4, g=1, window=100),
          "q8_t7": dict(t=7, quant=True)}[case]
    t_ = kw.get("t", 1)
    j, t = _gate_case(**kw, cap=2048, ctx=(2047 - t_, 1990), written=2047)
    quant = kw.get("quant", False)
    got = _split_merge(t, quant).numpy()
    np.testing.assert_allclose(got, _port_plain(t, quant).numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(_jax_kernel(j, quant)), atol=1e-5, rtol=0)


def test_paged_attention_dispatch():
    """On CPU tensors gqa_attention sends T <= 16 over a paged cache to the
    plain K2/K3 and longer blocks through the gathered view; both equal the
    contiguous path on the gathered cache."""
    from layerskip_tpu_torch.ops import attention as tattn

    for quant in (False, True):
        _, t = _gate_case(t=7, quant=quant)
        k, v, q, qpos = t["k"], t["v"], t["q"], t["qpos"]
        dense = lambda qq, pos: tattn.gqa_attention(  # noqa: E731
            qq, k.gather_view(torch.float32), v.gather_view(torch.float32), pos,
            q_heads_per_kv=2)
        np.testing.assert_allclose(
            tattn.gqa_attention(q, k, v, qpos, q_heads_per_kv=2).numpy(),
            dense(q, qpos).numpy(), atol=2e-5, rtol=1e-5)
        q20 = torch.cat([q, q, q], 1)[:, :20]
        pos20 = qpos[:, :1] - 10 + torch.arange(20)
        np.testing.assert_allclose(
            tattn.gqa_attention(q20, k, v, pos20, q_heads_per_kv=2).numpy(),
            dense(q20, pos20).numpy(), atol=2e-5, rtol=1e-5)


# ------------------------------------------------------------ host allocators


def test_allocator_equals_jax():
    """The same call sequence gives the same pages, free counts and
    refcounted sharing in both packages."""
    out = []
    for mod in (jpkv, tpkv):
        al = mod.PageAllocator(pool_pages=6, page_size=16)
        log = [al.allocate(0, 40), al.free_pages(), al.allocate(1, 33), al.free_pages()]
        with pytest.raises(mod.PagePoolExhausted):
            al.allocate(2, 1)
        al.release(0)
        log += [al.free_pages(), al.allocate(2, 16 * 3), al.allocate(1, 16), al.free_pages()]
        al.release(1)
        al.release(2)
        a = al.allocate(0, 3 * 16)
        log += [a, al.allocate(1, 3 * 16, shared=a[:2]), al.free_pages()]
        al.release(0)
        log.append(al.free_pages())
        snap = al.snapshot()
        al.allocate(3, 16)
        al.restore(snap)
        log.append(al.free_pages())
        out.append(log)
    assert out[0] == out[1]


def test_prefix_cache_equals_jax():
    out = []
    for mod in (jpkv, tpkv):
        al = mod.PageAllocator(pool_pages=8, page_size=4)
        pc = mod.PrefixCache(al)
        prompt = list(range(10))
        pages = al.allocate(0, len(prompt) + 8)
        pc.put(prompt, pages)
        log = [pc.match(prompt), pc.match(prompt[:8]), pc.match(prompt[:4] + [99, 98, 97, 96]),
               pc.match([42, 43, 44, 45, 46]), (pc.hits, pc.hit_tokens)]
        al.release(0)
        log += [al.free_pages(), pc.evict(pages_wanted=100), al.free_pages()]
        pc.put(prompt, al.allocate(1, 12))
        pc.clear()
        log.append(al.free_pages())
        out.append(log)
    assert out[0] == out[1]


# ------------------------------------------------------------ sessions

L, D, F, V, HQ, HKV, DH = 4, 128, 128, 256, 2, 1, 64
SIZES = dict(hidden_size=D, num_attention_heads=HQ, num_key_value_heads=HKV)
EOS = (V + 7,)  # unreachable: every request runs to its budget


@pytest.fixture(scope="module")
def engines():
    """One random dense Llama (std 0.15 weights, so greedy streams vary) in
    both packages; head_dim 64, so paged decode takes the K2/K3 route."""
    rng = np.random.default_rng(0)
    n = lambda *s: (rng.standard_normal(s) * 0.15).astype(np.float32)  # noqa: E731
    layers = dict(attn_norm=np.ones((L, D), np.float32), wq=n(L, HQ * DH, D),
                  wk=n(L, HKV * DH, D), wv=n(L, HKV * DH, D), wo=n(L, HQ * DH, D),
                  mlp_norm=np.ones((L, D), np.float32), w_gate=n(L, D, F), w_up=n(L, D, F),
                  w_down=n(L, F, D))
    tree = dict(embed=n(V, D) * 2, layers=layers, final_norm=np.ones(D, np.float32),
                lm_head=n(D, V))
    jp = JLlamaParams(embed=jnp.asarray(tree["embed"]),
                      layers=JLayerParams(**{k: jnp.asarray(v) for k, v in layers.items()}),
                      final_norm=jnp.asarray(tree["final_norm"]),
                      lm_head=jnp.asarray(tree["lm_head"]))
    return (JEngine(jp, jax_tiny_config(**SIZES)),
            Engine(params_from_numpy(tree, device="cpu"), tiny_config(**SIZES), device="cpu"))


_PROMPTS = [[int(x) for x in np.random.default_rng(i).integers(3, V, size=n)]
            for i, n in enumerate((11, 3, 16, 7))]
_BUDGETS = [16, 9, 12, 16]


def _gen(cls, **kw):
    return cls(**{**dict(max_steps=16, sample=False, generation_strategy="self_speculative",
                         exit_layer=2, num_speculations=3), **kw})


def _drive(session):
    """Two requests to completion, then two more into the same slots; the
    results and each finished row's (matches, drafts)."""
    results, counters = {}, {}
    for wave in (0, 2):
        session.insert([0, 1], _PROMPTS[wave:wave + 2], seeds=[0, 0],
                       max_tokens=_BUDGETS[wave:wave + 2])
        while session.has_active():
            for r, toks, _ in session.step(max_rounds=3):
                results[wave + r] = toks
                counters[wave + r] = (int(session.state.matches[r]),
                                      int(session.state.drafts[r]))
    return results, counters


def _solo(te, i, **kw):
    cfg = dataclasses.replace(_gen(GenerationConfig, **kw), max_steps=_BUDGETS[i])
    return postprocess_output(te.generate(_PROMPTS[i], cfg, eos_ids=EOS), EOS, _BUDGETS[i])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_session_equals_jax_contiguous_and_solo(engines, kv_quant):
    """Paged (pages of 16) == contiguous == solo ``generate``, and streams
    and per-row counters equal the JAX package's paged session."""
    je, te = engines
    kw = dict(kv_quant=kv_quant)
    paged = dict(paged_pool_pages=8, page_size=16)
    got, counts = _drive(te.continuous_session(_gen(GenerationConfig, **kw), 2, 16, EOS,
                                               **paged))
    want, jcounts = _drive(je.continuous_session(_gen(JGenerationConfig, **kw), 2, 16, EOS,
                                                 **paged))
    assert got == want and counts == jcounts
    assert _drive(te.continuous_session(_gen(GenerationConfig, **kw), 2, 16, EOS))[0] == got
    assert all(got[i] == _solo(te, i, **kw) and len(got[i]) == _BUDGETS[i] for i in range(4))
    assert any(d > 0 for _, d in counts.values())


@pytest.mark.parametrize("page", [12, 20])
def test_paged_session_odd_pages_equals_jax_and_solo(engines, page):
    """A paged session with the int8 cache at pages of 12 and 20 slots (the
    JAX package serves any page size) == solo ``generate``, and streams and
    counters equal the JAX package's session of the same geometry."""
    je, te = engines
    paged = dict(paged_pool_pages=160 // page, page_size=page)
    got, counts = _drive(te.continuous_session(_gen(GenerationConfig, kv_quant=True), 2, 16,
                                               EOS, **paged))
    want, jcounts = _drive(je.continuous_session(_gen(JGenerationConfig, kv_quant=True), 2, 16,
                                                 EOS, **paged))
    assert got == want and counts == jcounts
    assert all(got[i] == _solo(te, i, kv_quant=True) for i in range(4))


def test_paged_insert_runs_through_the_plain_kernel(engines, monkeypatch):
    """With a prompt bucket of 16 the insert prefill goes through K2's
    plain version too; above 16 it takes the gathered path. Every round
    calls K2 W*E + L times (W drafts over E layers, the verify over L)."""
    _, te = engines
    calls = []
    real = tpd.paged_decode_attention_plain

    def counting(q, *a, **kw):
        calls.append(q.shape[1])
        return real(q, *a, **kw)

    monkeypatch.setattr(tpd, "paged_decode_attention_plain", counting)
    for bucket in (16, 32):
        calls.clear()
        s = te.continuous_session(_gen(GenerationConfig), 2, bucket, EOS,
                                  paged_pool_pages=12, page_size=16)
        s.insert([0], [_PROMPTS[0]])
        inserted = len(calls)
        s.step()
        assert inserted == (L if bucket == 16 else 0)
        assert len(calls) - inserted == 3 * 2 + L


def test_paged_insert_runs_only_the_inserted_rows(engines, monkeypatch):
    """A paged insert prefills only its rows (one row here, beside a live
    one), through K1's plain version when it has no prefix, and leaves the
    live row's pages untouched; the live row's stream equals its solo
    one."""
    from layerskip_tpu_torch.models import llama as tllama
    from layerskip_tpu_torch.ops import attention as tattn

    _, te = engines
    batches, flash = [], []
    real_split, real_flash = tllama.forward_split, tattn.flash_prefill_attention
    monkeypatch.setattr(tllama, "forward_split",
                        lambda p, c, ids, *a, **kw: batches.append(ids.shape[0])
                        or real_split(p, c, ids, *a, **kw))
    monkeypatch.setattr(tattn, "flash_prefill_attention",
                        lambda q, *a, **kw: flash.append(q.shape[:2])
                        or real_flash(q, *a, **kw))
    s = te.continuous_session(_gen(GenerationConfig), 3, 32, EOS, paged_pool_pages=12,
                              page_size=16)
    s.insert([0], [_PROMPTS[0]], max_tokens=[_BUDGETS[0]])
    s.step()
    live = s.allocator.owned(0)
    pools = [kv.pool[:, live].clone() for g in (s.state.early, s.state.full)
             for kv in (g.k, g.v)]
    del batches[:], flash[:]
    s.insert([2], [_PROMPTS[1]], max_tokens=[_BUDGETS[1]])
    assert batches == [1] and flash == [(1, 32)] * L
    assert all(torch.equal(kv.pool[:, live], before) for kv, before in zip(
        (kv for g in (s.state.early, s.state.full) for kv in (g.k, g.v)), pools))
    results = {}
    while s.has_active():
        for r, toks, _ in s.step(max_rounds=3):
            results[r] = toks
    assert results == {0: _solo(te, 0), 2: _solo(te, 1)}


def test_prefix_cache_session(engines):
    """Prefix hits are counted, warm streams equal the solo ones, and the
    shared prompt pages' bytes never change while the hit requests run."""
    _, te = engines
    system = [int(x) for x in np.random.default_rng(9).integers(3, V, size=8)]
    prompts = [system + tail for tail in ([3, 17], [5], [9, 11, 2])]
    s = te.continuous_session(_gen(GenerationConfig, max_steps=12), 2, 16, EOS,
                              paged_pool_pages=24, page_size=4, prefix_cache=True)
    results = {}
    s.insert([0], [prompts[0]], max_tokens=[12])
    while s.has_active():
        for r, toks, _ in s.step(max_rounds=2):
            results[0] = toks
    shared = s.allocator.owned(0)[:2]  # the system prompt's two full pages
    pools = [kv.pool[:, shared].clone() for g in (s.state.early, s.state.full)
             for kv in (g.k, g.v)]
    assert s.prefix_cache.hits == 0
    s.insert([0, 1], prompts[1:], max_tokens=[12, 12])
    assert s.allocator.owned(0)[:2] == shared and s.allocator.owned(1)[:2] == shared
    while s.has_active():
        for r, toks, _ in s.step(max_rounds=2):
            results[1 + r] = toks
    assert (s.prefix_cache.hits, s.prefix_cache.hit_tokens) == (2, 16)
    after = [kv.pool[:, shared] for g in (s.state.early, s.state.full) for kv in (g.k, g.v)]
    assert all(torch.equal(a, b) for a, b in zip(pools, after))
    for i, p in enumerate(prompts):
        want = postprocess_output(te.generate(p, _gen(GenerationConfig, max_steps=12),
                                              eos_ids=EOS), EOS, 12)
        assert results[i] == want, i


def test_pool_exhausted_leaves_state_untouched(engines):
    """A failed paged insert raises ``PagePoolExhausted`` with the allocator
    restored and no device tensor changed."""
    _, te = engines
    s = te.continuous_session(_gen(GenerationConfig), 2, 16, EOS, paged_pool_pages=3,
                              page_size=16)
    s.insert([0], [_PROMPTS[0]], max_tokens=[16])  # 11 + 16 + 5 -> 2 of 3 pages
    snap = s.allocator.snapshot()
    state = {f.name: getattr(s.state, f.name) for f in dataclasses.fields(s.state)}
    before = {k: v.clone() for k, v in state.items() if isinstance(v, torch.Tensor)}
    before["table"] = s.state.early.k.table.clone()
    before["pool"] = s.state.early.k.pool.clone()
    with pytest.raises(tpkv.PagePoolExhausted):
        s.insert([1], [_PROMPTS[1]])
    assert s.allocator.snapshot() == snap and not s.active[1]
    for k, v in before.items():
        now = {"table": s.state.early.k.table, "pool": s.state.early.k.pool}.get(
            k, getattr(s.state, k, None))
        assert torch.equal(now, v), k


def test_chunked_insert_equals_plain_insert(engines):
    """A chunked insert (contiguous KV), interleaved with a row in flight,
    commits exactly the plain insert's and the solo run's tokens."""
    _, te = engines
    gen = _gen(GenerationConfig)
    want = {0: _solo(te, 0), 1: _solo(te, 2)}
    for chunk in (4, 5, 64):
        s = te.continuous_session(gen, 2, 16, EOS)
        s.insert([0], [_PROMPTS[0]], max_tokens=[_BUDGETS[0]])
        s.step()
        s.begin_chunked_insert([1], [_PROMPTS[2]], max_tokens=[_BUDGETS[2]],
                               chunk_tokens=chunk)
        assert s.free_slots() == [] and s.has_pending_prefill()
        results = {}
        for _ in range(80):
            for r, toks, _ in s.step():
                results[r] = toks
            if len(results) == 2:
                break
        assert results == want, chunk
    with pytest.raises(ValueError):
        te.continuous_session(gen, 2, 16, EOS, paged_pool_pages=8,
                              page_size=16).begin_chunked_insert([0], [[1, 2]])


def test_sampled_stream_depends_only_on_the_request(engines):
    """A sampled request gives the same tokens alone and in another slot
    while other requests decode beside it; another seed gives another
    stream."""
    _, te = engines
    gen = GenerationConfig(max_steps=12, sample=True, temperature=1.2, top_k=0, top_p=1.0,
                           generation_strategy="self_speculative", exit_layer=2,
                           num_speculations=3)

    def run(slot, seed, neighbours):
        s = te.continuous_session(gen, 3, 16, EOS, paged_pool_pages=12, page_size=16)
        if neighbours:
            s.insert([0, 1], _PROMPTS[1:3], seeds=[5, 6])
            s.step()
        s.insert([slot], [_PROMPTS[0]], seeds=[seed])
        for _ in range(40):
            for r, toks, _ in s.step():
                if r == slot:
                    return toks
        raise AssertionError("did not finish")

    alone = run(0, 7, False)
    assert run(2, 7, True) == alone and len(alone) == 12
    assert run(0, 8, False) != alone


def test_paged_session_refuses_what_the_contract_refuses(engines):
    """A paged session refuses tree or hybrid with adaptive drafting, and a
    session refuses a prefix cache without paging, with ValueErrors
    (tests/test_torch_drafting.py and tests/test_torch_tree.py hold paged
    sessions of every draft source to the JAX package's)."""
    _, te = engines
    paged = dict(paged_pool_pages=12, page_size=16)
    for kw in (dict(spec_tree_width=2, draft_exit_prob=0.5),
               dict(generation_strategy="hybrid", draft_exit_prob=0.5)):
        with pytest.raises(ValueError):
            te.continuous_session(_gen(GenerationConfig, **kw), 2, 16, **paged)
    with pytest.raises(ValueError):
        te.continuous_session(_gen(GenerationConfig), 2, 16, prefix_cache=True)
