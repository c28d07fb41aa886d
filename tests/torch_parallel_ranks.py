"""Rank bodies of the port's sharded CPU tests (tests/test_torch_parallel*.py).

    python tests/torch_parallel_ranks.py <suite> <workdir>

runs under the port's launcher (``layerskip_tpu_torch.parallel.launch``,
gloo, a ``file://`` rendezvous): it reads ``<workdir>/inputs.pt`` (model
configs as ``tiny_config`` keywords, numpy weight trees, prompts), runs the
suite's sharded cases and writes ``<workdir>/rank<r>.pt``. It imports torch
and the port only, never JAX: the test process compares the results with the
JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation.engine import Engine, postprocess_batch, postprocess_output
from layerskip_tpu_torch.models import llama
from layerskip_tpu_torch.models.params import params_from_numpy
from layerskip_tpu_torch.ops.kv_cache import init_kv_cache
from layerskip_tpu_torch.ops.linear import QuantTensor
from layerskip_tpu_torch.parallel.collectives import all_gather, sharded
from layerskip_tpu_torch.parallel.distributed import setup, teardown
from layerskip_tpu_torch.parallel.mesh import make_mesh, make_sp_mesh
from layerskip_tpu_torch.parallel.sharding import shard_params
from layerskip_tpu_torch.quant import quantize_draft_params

EOS = (99,)
# the JAX package's sharding tests' config: every count divides by tp 4
MAIN = dict(num_hidden_layers=4, hidden_size=64, num_attention_heads=8,
            num_key_value_heads=4, intermediate_size=128, vocab_size=256)
CONFIGS = {
    "main": dict(sizes=MAIN),
    # K slices of wo and w_down that hold whole int4 groups of 128 at tp 2
    "quant": dict(sizes=dict(MAIN, intermediate_size=256), extra=dict(head_dim=32)),
    "moe": dict(sizes=dict(MAIN, num_local_experts=4, num_experts_per_tok=2)),
}


def numpy_tree(name, seed, std=0.15, tail_eps=0.05):
    """Random weights (the JAX package's field names) of config ``name``;
    the output projections of layers >= 2 (past the exit) are scaled by
    ``tail_eps``, so drafts are often accepted."""
    c = CONFIGS[name]
    sz = c["sizes"]
    L, D, F, V = (sz["num_hidden_layers"], sz["hidden_size"], sz["intermediate_size"],
                  sz["vocab_size"])
    dh = c.get("extra", {}).get("head_dim", D // sz["num_attention_heads"])
    hq, hkv = sz["num_attention_heads"] * dh, sz["num_key_value_heads"] * dh
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    layers = dict(attn_norm=np.ones((L, D), np.float32), wq=n(L, hq, D), wk=n(L, hkv, D),
                  wv=n(L, hkv, D), wo=n(L, hq, D), mlp_norm=np.ones((L, D), np.float32))
    e = sz.get("num_local_experts", 0)
    if e:
        layers.update(w_router=n(L, D, e) * 3, w_gate=n(L, e, D, F), w_up=n(L, e, D, F),
                      w_down=n(L, e, F, D))
    else:
        layers.update(w_gate=n(L, D, F), w_up=n(L, D, F), w_down=n(L, F, D))
    for f in ("wo", "w_down"):
        layers[f][2:] *= tail_eps
    return dict(embed=n(V, D) * 2, layers=layers, final_norm=np.ones(D, np.float32),
                lm_head=n(D, V))


def build_inputs():
    """Everything the suites read: configs, weight trees, prompts."""
    rng = np.random.default_rng(0)
    base = rng.integers(3, 98, size=8).tolist()  # a page-aligned shared prefix (page 8)
    prompts = [base + [5, 17, 40], base + [61, 2, 33, 71, 12], base + [5, 17, 40, 8],
               rng.integers(3, 98, size=7).tolist()]
    return dict(cfg=CONFIGS, trees={name: numpy_tree(name, i)
                                    for i, name in enumerate(CONFIGS)},
                prompt=rng.integers(3, 98, size=20).tolist(),
                ids=torch.from_numpy(rng.integers(0, 256, size=(2, 16))),
                session_prompts=prompts, budgets=[12, 9, 12, 10])


def run_suite(suite: str, nproc: int, work: str):
    """Launch ``suite`` over ``nproc`` gloo ranks; every rank's results."""
    from layerskip_tpu_torch.parallel.launch import launch

    torch.save(build_inputs(), os.path.join(work, "inputs.pt"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=path)
    rc = launch([os.path.abspath(__file__), suite, work], nproc, "gloo",
                init_method="file://" + os.path.join(work, "rendezvous"), env=env,
                timeout=600)
    assert rc == 0, f"suite {suite} failed with exit code {rc}"
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(nproc)]


def gen_cfg(**kw) -> GenerationConfig:
    return GenerationConfig(**{**dict(max_steps=12, sample=False), **kw})


SPEC = dict(generation_strategy="self_speculative", exit_layer=2, num_speculations=3)
STREAMS = {  # name -> GenerationConfig fields
    "ar": {}, "spec": SPEC, "tree3": dict(SPEC, spec_tree_width=3),
    "draft8": dict(SPEC, draft_quant=8), "draft4": dict(SPEC, draft_quant=4),
}


def model(inputs, name):
    cfg = dataclasses.replace(tiny_config(**inputs["cfg"][name]["sizes"]),
                              **inputs["cfg"][name].get("extra", {}))
    return cfg, params_from_numpy(inputs["trees"][name], device="cpu")


def stream(eng, prompt, **kw):
    out = eng.generate(prompt, gen_cfg(**kw), eos_ids=EOS)
    return (postprocess_output(out, EOS, 12), int(out.matches), int(out.drafts))


def forward_logits(params, cfg, ids, mesh):
    """Logits of a full forward of ``ids`` [B, T] (this dp group's rows,
    gathered over dp) on ``mesh``."""
    local, ctx = shard_params(params, mesh, cfg)
    with torch.inference_mode(), sharded(ctx):
        b = ids.shape[0]
        dp = ctx.dp
        rows = ids if dp is None else ids[dp.rank * b // dp.size:(dp.rank + 1) * b // dp.size]
        cache = init_kv_cache(cfg, rows.shape[0], 32, device="cpu")
        logits = llama.forward(local, cfg, rows, cache, 0).logits
        return all_gather(logits, dp, 0)


def quant_parts(w):
    return {"q": w.q.clone(), "scale": w.scale.clone(), "group": w.group}


def drafters(params, cfg, mesh, bits):
    """This rank's tp drafter (quantized under the context) and the drafter
    quantized from the same shards with per-rank absmaxes (no context)."""
    local, ctx = shard_params(params, mesh, cfg)
    group = 0 if bits == 8 else 128
    with sharded(ctx):
        good = quantize_draft_params(local, 2, bits=bits, group=group, quantize_head=True)
    fields = ("wq", "wo", "w_gate", "w_down")
    out = {f: quant_parts(getattr(good.layers, f)) for f in fields}
    if bits == 8:
        naive = quantize_draft_params(local, 2, bits=8, group=0, quantize_head=True)
        out["naive"] = {f: quant_parts(getattr(naive.layers, f)) for f in ("wo", "w_down")}
    if isinstance(good.lm_head, QuantTensor):
        out["lm_head"] = quant_parts(good.lm_head)
    return out


def serve(session, prompts, budgets, chunked=False):
    """Requests 0 and 1 (1 by chunked insert when asked), then 2 and 3 into
    the same slots: each request's stream and (matches, drafts)."""
    results, counters = {}, {}
    for wave in (0, 2):
        if chunked:
            session.insert([0], [prompts[wave]], seeds=[0], max_tokens=[budgets[wave]])
            session.begin_chunked_insert([1], [prompts[wave + 1]], seeds=[0],
                                         max_tokens=[budgets[wave + 1]], chunk_tokens=4)
        else:
            session.insert([0, 1], prompts[wave:wave + 2], seeds=[0, 0],
                           max_tokens=budgets[wave:wave + 2])
        while session.has_active() or session.has_pending_prefill():
            for r, toks, _ in session.step(max_rounds=2):
                results[wave + r] = toks
                counters[wave + r] = (int(session.state.matches[r]),
                                      int(session.state.drafts[r]))
    return results, counters


SESSIONS = {  # name -> (GenerationConfig fields, continuous_session keywords, chunked)
    "paged_tree_prefix": (dict(SPEC, max_steps=12, spec_tree_width=2),
                          dict(paged_pool_pages=24, page_size=8, prefix_cache=True), False),
    "paged_tree_prefix_q8": (dict(SPEC, max_steps=12, spec_tree_width=2, kv_quant=True),
                             dict(paged_pool_pages=24, page_size=8, prefix_cache=True), False),
    "chunked": (dict(SPEC, max_steps=12), {}, True),
}


def suite_w2(inputs, rank):
    res = {}
    cfg, params = model(inputs, "main")
    mesh = make_mesh(1, 2, device_type="cpu")
    res["forward_tp2"] = forward_logits(params, cfg, inputs["ids"], mesh)
    local, _ = shard_params(params, mesh, cfg)
    res["shards"] = {f: getattr(local.layers, f) for f in ("wq", "wk", "wo", "w_gate",
                                                          "w_down")}
    res["shards"].update(embed=local.embed, lm_head=local.lm_head)
    res["contiguous"] = all(t.is_contiguous() for t in res["shards"].values())
    eng = Engine(local, cfg, device="cpu", mesh=mesh)
    res["tp2"] = {name: stream(eng, inputs["prompt"], **kw)
                  for name, kw in STREAMS.items() if name != "draft4"}
    try:
        stream(eng, inputs["prompt"], **STREAMS["draft4"])
        res["draft4_refused"] = None
    except ValueError as exc:
        res["draft4_refused"] = str(exc)
    sampled = gen_cfg(**SPEC, sample=True, temperature=1.0, top_p=1.0)
    res["sampled"] = postprocess_output(eng.generate(
        inputs["prompt"], sampled, torch.Generator().manual_seed(3), eos_ids=EOS), EOS, 12)
    res["drafter8"] = drafters(params, cfg, mesh, 8)
    res["sessions"] = {}
    for name, (g, kw, chunked) in SESSIONS.items():
        sess = eng.continuous_session(gen_cfg(**g), 2, 16, EOS, **kw)
        res["sessions"][name] = serve(sess, inputs["session_prompts"], inputs["budgets"],
                                      chunked)
    qcfg, qparams = model(inputs, "quant")
    qlocal, _ = shard_params(qparams, mesh, qcfg)
    qeng = Engine(qlocal, qcfg, device="cpu", mesh=mesh)
    res["quant_tp2"] = {name: stream(qeng, inputs["prompt"], **STREAMS[name])
                        for name in ("draft8", "draft4")}
    res["drafter4"] = drafters(qparams, qcfg, mesh, 4)
    sp = make_sp_mesh(2, device_type="cpu")
    spe = Engine(params, cfg, device="cpu", mesh=sp, kv_shard_axis="sp")
    res["sp2"] = {name: stream(spe, inputs["prompt"], **STREAMS[name]) for name in ("ar", "spec")}
    return res


def suite_w4(inputs, rank):
    res = {}
    cfg, params = model(inputs, "main")
    res["forward_tp4"] = forward_logits(params, cfg, inputs["ids"],
                                        make_mesh(1, 4, device_type="cpu"))
    dptp = make_mesh(2, 2, device_type="cpu")
    res["forward_dp2tp2"] = forward_logits(params, cfg, inputs["ids"], dptp)
    local, _ = shard_params(params, dptp, cfg)
    out = Engine(local, cfg, device="cpu", mesh=dptp).generate(
        inputs["session_prompts"][:2], gen_cfg(**SPEC), eos_ids=EOS)
    res["dp2tp2_batch"] = (postprocess_batch(out, EOS, 12), int(out.matches),
                           int(out.drafts))
    sptp = make_sp_mesh(2, 2, device_type="cpu")
    local, _ = shard_params(params, sptp, cfg, kv_shard_axis="sp")
    eng = Engine(local, cfg, device="cpu", mesh=sptp, kv_shard_axis="sp")
    res["sp2tp2"] = {"ar": stream(eng, inputs["prompt"])}
    mcfg, mparams = model(inputs, "moe")
    eptp = make_mesh(1, 2, ep=2, device_type="cpu")
    mlocal, _ = shard_params(mparams, eptp, mcfg)
    res["moe_shapes"] = (tuple(mlocal.layers.w_gate.shape), tuple(mlocal.layers.w_down.shape))
    meng = Engine(mlocal, mcfg, device="cpu", mesh=eptp)
    res["ep2tp2"] = {name: stream(meng, inputs["prompt"], **STREAMS[name])
                     for name in ("ar", "spec")}
    return res


def main() -> int:
    suite, work = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    setup("gloo")
    rank = torch.distributed.get_rank()
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    res = {"w2": suite_w2, "w4": suite_w4}[suite](inputs, rank)
    torch.save(res, os.path.join(work, f"rank{rank}.pt"))
    teardown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
