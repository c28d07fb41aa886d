"""The port's schedulers and HTTP server (layerskip_tpu_torch/serving.py) on
the CPU: batched and continuous results equal direct ``Engine.generate``
runs (which tests/test_torch_generation.py holds to the JAX engine), paged
backpressure, per-request seeds and budgets, failure handling, and a
localhost HTTP round trip, as tests/test_serving.py checks the JAX module.
Every wait on a future has a timeout.
"""

import dataclasses
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from layerskip_tpu_torch import serving
from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
from layerskip_tpu_torch.models.params import init_params
from layerskip_tpu_torch.ops.paged_kv import PagePoolExhausted

EOS = [135]  # unreachable (vocab 128): every request runs to its budget
GEN = GenerationConfig(max_steps=12, sample=False, generation_strategy="self_speculative",
                       exit_layer=2, num_speculations=3)
SAMPLED = dataclasses.replace(GEN, sample=True, temperature=1.2, top_k=0, top_p=1.0)
WAIT = 120  # seconds for any future


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run thousands of tiny torch ops: one intra-op thread
    keeps them fast, also when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    cfg = tiny_config(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
                      vocab_size=128)
    params = init_params(cfg, seed=7, device="cpu")
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        getattr(params.layers, name).mul_(7.5)  # varied greedy streams
    params.embed.mul_(15.0)
    params.lm_head.mul_(7.5)
    return Engine(params, cfg, device="cpu")


def _solo(engine, prompt, gen=GEN, steps=None):
    gen = dataclasses.replace(gen, max_steps=steps or gen.max_steps)
    return postprocess_output(engine.generate(prompt, gen, eos_ids=EOS), EOS, gen.max_steps)


PROMPTS = [[3, 17, 52], [5, 9], [100, 2, 44, 8, 61], [7, 7, 7, 7]]


def test_batch_scheduler_matches_direct(engine):
    sched = serving.BatchScheduler(engine, batch_size=4, eos_ids=EOS).start()
    try:
        futures = [sched.submit(p, GEN) for p in PROMPTS]
        assert [f.result(timeout=WAIT) for f in futures] == [_solo(engine, p) for p in PROMPTS]
        assert sched.stats["requests"] == 4
        assert sched.generate(PROMPTS[0], GEN, timeout=WAIT) == _solo(engine, PROMPTS[0])
        assert sched.stats["padded_rows"] >= 3
    finally:
        sched.stop()


def test_batch_scheduler_splits_configs_and_seeds_rows(engine):
    """Different configs run as separate batches; each sampled row draws
    from its own seed, whatever it is batched with."""
    sched = serving.BatchScheduler(engine, batch_size=4, eos_ids=EOS,
                                   gather_window_s=0.3).start()
    try:
        ar = dataclasses.replace(GEN, max_steps=8, generation_strategy="autoregressive")
        f1, f2 = sched.submit(PROMPTS[0], GEN), sched.submit(PROMPTS[0], ar)
        assert len(f1.result(timeout=WAIT)) == 12 and len(f2.result(timeout=WAIT)) == 8
        assert sched.stats["batches"] == 2
        futs = [sched.submit(PROMPTS[0], SAMPLED, rng_seed=s) for s in (7, 99, 7)]
        a, b, c = [f.result(timeout=WAIT) for f in futs]
        assert a == c and a != b
        assert sched.generate(PROMPTS[0], SAMPLED, rng_seed=99, timeout=WAIT) == b
    finally:
        sched.stop()


def test_cfg_key_covers_every_field():
    """Requests differing in any GenerationConfig field never batch together."""
    base = GenerationConfig()
    for f in dataclasses.fields(GenerationConfig):
        v = getattr(base, f.name)
        if f.name in ("stop_words", "stop_token_ids"):
            new = ["STOP"] if f.name == "stop_words" else [42]
        elif f.name == "no_repeat_ngram_size":
            new = 5
        elif isinstance(v, bool):
            new = not v
        elif isinstance(v, (int, float)):
            new = v + 7
        else:
            new = str(v) + "_x"
        assert serving._cfg_key(dataclasses.replace(base, **{f.name: new})) \
            != serving._cfg_key(base), f.name


@pytest.mark.parametrize("paged", [False, True])
def test_continuous_scheduler_staggered_and_budgets(engine, paged):
    """Requests joining mid-flight, each with its own budget, get their
    solo streams; the latency recorder sees every request."""
    kw = dict(paged_pool_pages=16, page_size=16) if paged else {}
    sched = serving.ContinuousBatchScheduler(engine, GEN, batch_size=2, prompt_bucket=16,
                                             eos_ids=EOS, **kw).start()
    try:
        budgets = [4, 11, 0, 12]
        futs = []
        for p, m in zip(PROMPTS, budgets):
            futs.append(sched.submit(p, max_tokens=m))
        got = [f.result(timeout=WAIT) for f in futs]
        assert got == [_solo(engine, p, steps=m or None) for p, m in zip(PROMPTS, budgets)]
        assert [len(g) for g in got] == [4, 11, 12, 12]
        summary = sched.latency.summary()
        assert summary["window"] == 4 and summary["serve_ms"]["p50"] >= 0
    finally:
        sched.stop()


def test_paged_scheduler_backpressure(engine):
    """A pool too small for every slot at once: requests wait for pages and
    all complete with their solo streams; one that can never fit fails."""
    # per request: ceil((3 + 12 + 5) / 16) = 2 pages; 4 slots need 8, the pool has 5
    sched = serving.ContinuousBatchScheduler(engine, GEN, batch_size=4, prompt_bucket=16,
                                             eos_ids=EOS, paged_pool_pages=5,
                                             page_size=16).start()
    try:
        futs = [sched.submit([3 + i, 17, 52], max_tokens=12) for i in range(8)]
        outs = [f.result(timeout=WAIT) for f in futs]
        assert outs == [_solo(engine, [3 + i, 17, 52]) for i in range(8)]
    finally:
        sched.stop()
    big = dataclasses.replace(GEN, max_steps=32)
    sched = serving.ContinuousBatchScheduler(engine, big, batch_size=2, prompt_bucket=16,
                                             eos_ids=EOS, paged_pool_pages=2,
                                             page_size=16).start()
    try:
        with pytest.raises(PagePoolExhausted):
            sched.generate([1, 2, 3], timeout=WAIT)
    finally:
        sched.stop()


def test_continuous_scheduler_prefix_cache_and_chunked_prefill(engine):
    system = [int(x) for x in np.random.default_rng(3).integers(3, 120, size=8)]
    prompts = [system + [3, 17], system + [5], system + [9, 11, 2]]
    sched = serving.ContinuousBatchScheduler(engine, GEN, batch_size=2, prompt_bucket=16,
                                             eos_ids=EOS, paged_pool_pages=32, page_size=4,
                                             prefix_cache=True).start()
    try:
        first = sched.generate(prompts[0], timeout=WAIT)
        rest = [f.result(timeout=WAIT) for f in [sched.submit(p) for p in prompts[1:]]]
        assert [first] + rest == [_solo(engine, p) for p in prompts]
        assert sched.session.prefix_cache.hits == 2
    finally:
        sched.stop()
    long_prompts = [list(range(3, 16)), [5, 9, 30, 8, 61, 100, 2]]
    sched = serving.ContinuousBatchScheduler(engine, GEN, batch_size=2, prompt_bucket=16,
                                             eos_ids=EOS, chunk_prefill_tokens=4).start()
    try:
        got = [f.result(timeout=WAIT) for f in [sched.submit(p) for p in long_prompts]]
        assert got == [_solo(engine, p) for p in long_prompts]
    finally:
        sched.stop()


def test_failed_round_resolves_every_future(engine, monkeypatch):
    """A round that raises fails the requests in flight (no hang), and the
    scheduler goes on serving."""
    sched = serving.ContinuousBatchScheduler(engine, GEN, batch_size=2, prompt_bucket=16,
                                             eos_ids=EOS)
    real = sched.session.step
    broken = threading.Event()
    broken.set()

    def step(max_rounds=1):
        if broken.is_set():
            raise RuntimeError("device fault")
        return real(max_rounds)

    monkeypatch.setattr(sched.session, "step", step)
    sched.start()
    try:
        futs = [sched.submit(p) for p in PROMPTS[:2]]
        for f in futs:
            with pytest.raises(RuntimeError, match="device fault"):
                f.result(timeout=WAIT)
        broken.clear()
        assert sched.generate(PROMPTS[2], timeout=WAIT) == _solo(engine, PROMPTS[2])
    finally:
        sched.stop()
    assert not sched._thread.is_alive()


class _Tok:
    eos_token_id = 127

    def encode(self, s):
        return [3, 17, 52]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in ids)


def _serve(sched):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = serving.make_server(sched, _Tok(), GEN, "127.0.0.1", port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{port}"


def _post(url, payload):
    req = urllib.request.Request(f"{url}/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.load(r)


@pytest.mark.parametrize("continuous", [False, True])
def test_http_round_trip(engine, continuous):
    """POST /generate and GET /healthz on localhost; in continuous mode a
    per-request override other than max_steps and seed gets 400."""
    if continuous:
        sched = serving.ContinuousBatchScheduler(engine, GEN, batch_size=2, prompt_bucket=16,
                                                 eos_ids=EOS, paged_pool_pages=8,
                                                 page_size=16)
    else:
        sched = serving.BatchScheduler(engine, batch_size=2, eos_ids=EOS)
    sched.start()
    server, thread, url = _serve(sched)
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=WAIT) as r:
            assert json.load(r)["ok"] is True
        payload = _post(url, {"prompt": "hi", "max_steps": 6, "seed": 3})
        assert payload["tokens"] == _solo(engine, [3, 17, 52], steps=6)
        assert payload["text"] == " ".join(str(t) for t in payload["tokens"])
        if continuous:
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(url, {"prompt": "hi", "temperature": 0.1})
            assert err.value.code == 400 and "temperature" in json.load(err.value)["error"]
            assert len(_post(url, {"prompt": "hi", "max_steps": 4,
                                   "num_speculations": 3})["tokens"]) == 4
        with urllib.request.urlopen(f"{url}/healthz", timeout=WAIT) as r:
            stats = json.load(r)["stats"]
        assert stats["latency"]["window"] >= 1
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=WAIT)
        sched.stop()
    assert not thread.is_alive()


def test_session_device_work_runs_in_inference_mode(engine):
    """The session's tensors are made and written under inference mode from
    any thread, so a scheduler thread can drive a session made elsewhere."""
    session = engine.continuous_session(GEN, 2, 16, EOS, paged_pool_pages=8, page_size=16)
    assert session.state.early.k.pool.is_inference()
    out = {}

    def drive():
        session.insert([1], [PROMPTS[0]])
        while session.has_active():
            for r, toks, _ in session.step(max_rounds=4):
                out[r] = toks

    t = threading.Thread(target=drive)
    t.start()
    t.join(timeout=WAIT)
    assert not t.is_alive() and out == {1: _solo(engine, PROMPTS[0])}
    assert not torch.is_inference_mode_enabled()
