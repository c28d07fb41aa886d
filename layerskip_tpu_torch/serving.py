"""Serving: request batching over the port's engine (port of
``layerskip_tpu/serving.py``).

  * ``BatchScheduler`` groups pending requests into fixed-size batches
    (padding with copies of row 0), runs ``Engine.generate`` and resolves a
    future per request. Requests with different output-affecting
    ``GenerationConfig`` fields go to separate batches.
  * ``ContinuousBatchScheduler`` runs a ``ContinuousSession``: a finished
    row is refilled from the queue while the others keep decoding. With a
    paged pool, a request the pool cannot hold yet waits (backpressure);
    one the pool can never hold fails. Over a mixture of experts each
    future carries the request's route records as ``future.records``.
  * ``serve`` / ``make_server``: a stdlib HTTP server with POST /generate
    ({"prompt": str, ...overrides}) and GET /healthz.
  * ``main``: the command line, ``python -m layerskip_tpu_torch.serving
    --model <dir|random:preset> [--continuous --paged-pool-pages N ...]``
    (``--device cpu`` runs on the CPU); ``build_from_args`` makes its
    running scheduler and bound server from the parsed flags.

Each scheduler runs its device work on its own thread; the session and the
engine enter ``torch.inference_mode()`` themselves, since the mode is per
thread. A failed batch or round resolves every pending future with the
exception and the scheduler keeps running.

Spans (``utils/profiling.py``): each request is a ``request`` span from
``submit`` to its future's resolution (prompt tokens, tokens returned) with
a child ``queue`` span from submit to admission; the continuous scheduler's
``sched.loop`` covers one pass of its loop, ``sched.wait`` the blocking
wait for a request when no row is active. Request ids reach the session's
spans through ``ContinuousSession.request_ids``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import torch

from layerskip_tpu_torch.config import GenerationConfig
from layerskip_tpu_torch.generation.engine import Engine, postprocess_batch
from layerskip_tpu_torch.ops.paged_kv import PagePoolExhausted
from layerskip_tpu_torch.utils import profiling
from layerskip_tpu_torch.utils.profiling import NULL_SPAN, detached, span

_REQUEST_IDS = itertools.count()  # unique in the process, for the spans


@dataclasses.dataclass
class _Request:
    prompt_ids: List[int]
    gen_cfg: GenerationConfig
    future: Future
    rng_seed: int = 0
    max_tokens: int = 0  # 0 => the scheduler's max_steps
    t_start: float = 0.0  # when the request entered a device batch (time.time())
    rid: int = -1
    span: object = NULL_SPAN  # ``request``: submit to resolution
    queue_span: object = NULL_SPAN  # ``queue``: submit (or a wait for pages) to admission

    @classmethod
    def new(cls, prompt_ids, gen_cfg: GenerationConfig, rng_seed: int = 0,
            max_tokens: int = 0) -> "_Request":
        """A request submitted now, its ``request`` and ``queue`` spans open."""
        rid = next(_REQUEST_IDS)
        prompt = list(prompt_ids)
        req_span = detached("request", rids=(rid,), prompt_tokens=len(prompt))
        return cls(prompt, gen_cfg, Future(), rng_seed, max_tokens, rid=rid, span=req_span,
                   queue_span=detached("queue", parent=req_span, rids=(rid,)))

    def admitted(self) -> None:
        self.queue_span.end()

    def requeued(self) -> None:
        """Back in a queue after admission (held for pages): a new wait."""
        self.queue_span = detached("queue", parent=self.span, rids=(self.rid,))

    def resolve(self, tokens=None, exc: Optional[BaseException] = None,
                latency: Optional["_LatencyRecorder"] = None,
                records: Optional[dict] = None) -> bool:
        """Close the spans and resolve the future with ``tokens`` or ``exc``;
        False (nothing done) when it was resolved already. ``records``, what
        the session kept for the request (a mixture of experts' routes),
        goes on the future as ``future.records`` before its result."""
        if self.future.done():
            return False
        self.queue_span.end()
        if exc is not None:
            self.span.end(error=1)
            self.future.set_exception(exc)
            return True
        self.span.end(tokens=len(tokens))
        if latency is not None:
            latency.record(self)
        if records is not None:
            self.future.records = records
        self.future.set_result(tokens)
        return True


class _LatencyRecorder:
    """The last ``window`` served requests' ``request`` and ``queue`` spans
    -> percentile summary: queue wait (submit to the last admission), serve
    time (admission to done) and time per returned token. Empty while spans
    are off (``utils/profiling.ENABLED``)."""

    def __init__(self, window: int = 512):
        self._buf = collections.deque(maxlen=window)
        self._lock = threading.Lock()

    def record(self, req: _Request) -> None:
        if req.span.end_ns is None or req.queue_span.end_ns is None:
            return
        with self._lock:
            self._buf.append((req.span, req.queue_span))

    def summary(self) -> dict:
        with self._lock:
            rows = [((q.end_ns - r.start_ns) * 1e-9, (r.end_ns - q.end_ns) * 1e-9,
                     max(int(r.attrs.get("tokens", 1)), 1)) for r, q in self._buf]
        if not rows:
            return {"window": 0}

        def pct(vals, q):
            vals = sorted(vals)
            i = min(int(q * (len(vals) - 1) + 0.5), len(vals) - 1)
            return round(vals[i] * 1e3, 2)  # ms

        def dist(vals):
            return {q: pct(vals, p) for q, p in (("p50", .5), ("p95", .95), ("p99", .99))}

        return {
            "window": len(rows),
            "queue_ms": dist([r[0] for r in rows]),
            "serve_ms": dist([r[1] for r in rows]),
            "per_token_ms": dist([r[1] / r[2] for r in rows]),
        }


def _cfg_key(cfg: GenerationConfig):
    """Requests batch together iff every output-affecting field is equal."""
    return (
        cfg.generation_strategy, cfg.max_steps, cfg.exit_layer,
        cfg.num_speculations, cfg.sample, cfg.temperature, cfg.top_k,
        cfg.top_p, cfg.no_repeat_ngram_size, cfg.kv_quant,
        cfg.max_prompt_len, cfg.max_seq_len,
        cfg.draft_exit_prob, cfg.pld_ngram, cfg.spec_tree_width,
        cfg.draft_quant, cfg.draft_quant_head, cfg.draft_quant_mlp_only,
        tuple(cfg.stop_words or ()),
        tuple(cfg.stop_token_ids or ()),
    )


class BatchScheduler:
    """Gathers requests into batches of ``batch_size`` rows and runs the
    engine. Short batches are padded with copies of row 0 (their outputs
    are dropped), so a batch always has the same width. Each row samples
    from a generator seeded with its request's seed."""

    def __init__(self, engine: Engine, batch_size: int = 4,
                 gather_window_s: float = 0.005, eos_ids: Sequence[int] = ()):
        self.engine = engine
        self.batch_size = batch_size
        self.gather_window_s = gather_window_s
        self.eos_ids = list(eos_ids) or list(engine.cfg.eos_token_ids)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"batches": 0, "requests": 0, "padded_rows": 0}
        self.latency = _LatencyRecorder()

    def submit(self, prompt_ids: List[int], gen_cfg: GenerationConfig,
               rng_seed: int = 0) -> Future:
        """Returns a Future resolving to the generated token list."""
        req = _Request.new(prompt_ids, gen_cfg, rng_seed)
        self._queue.put(req)
        return req.future

    def generate(self, prompt_ids, gen_cfg, rng_seed: int = 0, timeout=None):
        return self.submit(prompt_ids, gen_cfg, rng_seed).result(timeout)

    def start(self) -> "BatchScheduler":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)

    def _gather(self) -> List[_Request]:
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.gather_window_s
        key = _cfg_key(first.gen_cfg)
        spill: List[_Request] = []
        while len(batch) < self.batch_size and time.monotonic() < deadline:
            try:
                req = self._queue.get(timeout=max(deadline - time.monotonic(), 0))
            except queue.Empty:
                break
            (batch if _cfg_key(req.gen_cfg) == key else spill).append(req)
        for req in spill:  # another config: a later batch
            self._queue.put(req)
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._gather()
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as exc:  # a failed batch fails its requests only
                for req in batch:
                    req.resolve(exc=exc)

    def _run_batch(self, batch: List[_Request]) -> None:
        for req in batch:
            req.t_start = time.time()
            req.admitted()
        gen_cfg = batch[0].gen_cfg
        pad_rows = self.batch_size - len(batch)
        prompts = [r.prompt_ids for r in batch] + [batch[0].prompt_ids] * pad_rows
        eos = self.eos_ids + list(gen_cfg.stop_token_ids or ())
        seeds = [r.rng_seed for r in batch] + [batch[0].rng_seed] * pad_rows
        gens = [torch.Generator(device=self.engine.device).manual_seed(int(s))
                for s in seeds]
        out = self.engine.generate(prompts, gen_cfg, gens, eos)
        rows = postprocess_batch(out, eos, gen_cfg.max_steps)
        for req, row in zip(batch, rows):
            req.resolve(row, latency=self.latency)
        self.stats["batches"] += 1
        self.stats["requests"] += len(batch)
        self.stats["padded_rows"] += pad_rows


class ContinuousBatchScheduler:
    """Continuous batching over a ``ContinuousSession``: requests join and
    leave the running batch at round granularity. All requests share one
    ``GenerationConfig``; only the seed and the token budget vary."""

    def __init__(
        self,
        engine: Engine,
        gen_cfg: GenerationConfig,
        batch_size: int = 4,
        prompt_bucket: int = 256,
        eos_ids: Sequence[int] = (),
        max_wave_rounds: int = 128,
        paged_pool_pages: int = 0,  # > 0: paged KV pool (ops/paged_kv.py)
        page_size: int = 256,
        prefix_cache: bool = False,  # paged only: share prompt-prefix KV
        chunk_prefill_tokens: int = 0,  # > 0 (contiguous KV): new prompts
        # prefill chunk by chunk between decode rounds, one chunked insert
        # in flight at a time
    ):
        self.engine = engine
        self.gen_cfg = gen_cfg
        self.max_wave_rounds = max(int(max_wave_rounds), 1)
        self.chunk_prefill_tokens = int(chunk_prefill_tokens)
        if self.chunk_prefill_tokens and paged_pool_pages:
            raise ValueError("chunked prefill: contiguous KV only")
        self.session = engine.continuous_session(
            gen_cfg, batch_size, prompt_bucket, eos_ids,
            paged_pool_pages=paged_pool_pages, page_size=page_size,
            prefix_cache=prefix_cache)
        self._held: List[_Request] = []  # backpressured: waiting for pages
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._slot_req = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # acceptance_sum / completed is the mean acceptance of finished
        # requests; held_for_pages counts admissions deferred for pages
        self.stats = {"rounds": 0, "requests": 0, "completed": 0, "acceptance_sum": 0.0,
                      "held_for_pages": 0}
        self.latency = _LatencyRecorder()

    def submit(self, prompt_ids: List[int], seed: int = 0, max_tokens: int = 0) -> Future:
        req = _Request.new(prompt_ids, self.gen_cfg, seed, max_tokens)
        self._queue.put(req)
        self.stats["requests"] += 1
        return req.future

    def generate(self, prompt_ids, timeout=None, seed: int = 0, max_tokens: int = 0):
        return self.submit(prompt_ids, seed, max_tokens).result(timeout)

    def start(self) -> "ContinuousBatchScheduler":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)

    def _next_request(self, wait: bool) -> Optional[_Request]:
        """The next queued request, or None; ``wait``: for up to 50 ms (a
        ``sched.wait`` span)."""
        if not wait:
            try:
                return self._queue.get_nowait()
            except queue.Empty:
                return None
        with span("sched.wait"):
            try:
                return self._queue.get(timeout=0.05)
            except queue.Empty:
                return None

    def _fill_slots(self, block: bool) -> None:
        rows, prompts, seeds, budgets, reqs = [], [], [], [], []
        for slot in self.session.free_slots():
            if self._held:
                req = self._held.pop(0)
            else:
                req = self._next_request(block and not rows)
                if req is None:
                    break
            rows.append(slot)
            prompts.append(req.prompt_ids)
            seeds.append(req.rng_seed)
            budgets.append(req.max_tokens)
            reqs.append(req)
            req.t_start = time.time()
            req.admitted()
            self._slot_req[slot] = req
            self.session.request_ids[slot] = req.rid
        if not rows:
            return
        try:
            if self.chunk_prefill_tokens:
                self.session.begin_chunked_insert(
                    rows, prompts, seeds=seeds, max_tokens=budgets,
                    chunk_tokens=self.chunk_prefill_tokens)
            else:
                self.session.insert(rows, prompts, seeds=seeds, max_tokens=budgets)
        except PagePoolExhausted as exc:
            # reclaim finished slots' pages, then admit the longest FIFO
            # prefix that fits: allocation is host-side and rolls back, so
            # probing costs no device work; the rest waits for pages
            self.session.park_free_slots()
            admitted = 0
            for n in range(len(rows), 0, -1):
                try:
                    self.session.insert(rows[:n], prompts[:n], seeds=seeds[:n],
                                        max_tokens=budgets[:n])
                    admitted = n
                    break
                except PagePoolExhausted:
                    continue
            al = self.session.allocator
            for slot, req in list(zip(rows, reqs))[admitted:]:
                self._slot_req.pop(slot, None)
                self.session.request_ids[slot] = -1
                need = (min(len(req.prompt_ids), self.session.prompt_bucket)
                        + (req.max_tokens or self.gen_cfg.max_steps)
                        + self.gen_cfg.num_speculations + 2)
                if al.pages_needed(need) > al.pool_pages:
                    req.resolve(exc=exc)  # can never fit
                else:
                    req.requeued()
                    self._held.append(req)
                    self.stats["held_for_pages"] += 1
        except Exception as exc:  # a failed insert fails its requests only
            for slot in rows:
                self._slot_req.pop(slot).resolve(exc=exc)

    def _loop(self) -> None:
        while not self._stop.is_set():
            with span("sched.loop"):
                self._loop_once()

    def _loop_once(self) -> None:
        if not self.session.has_pending_prefill():
            # one chunked insert in flight at a time
            self._fill_slots(block=not self.session.has_active())
        if not (self.session.has_active() or self.session.has_pending_prefill()):
            return
        # one multi-round step per completion wave when no waiting
        # request could join (all slots busy, or nothing queued): it
        # returns when the earliest row could have used its budget
        # (min_rounds_bound); single rounds while a free slot could be
        # filled. EOS may end a row early; max_wave_rounds caps how long
        # it waits for harvest.
        can_join = bool(self.session.free_slots()) and not self._queue.empty()
        rounds = (1 if can_join or self.session.has_pending_prefill()
                  else min(self.session.min_rounds_bound(), self.max_wave_rounds))
        try:
            finished = self.session.step(max_rounds=rounds)
        except Exception as exc:  # resolve every pending request, go on
            for slot, req in list(self._slot_req.items()):
                req.resolve(exc=exc)
                self._slot_req.pop(slot, None)
            return
        self.stats["rounds"] += 1
        for row, tokens, acceptance in finished:
            req = self._slot_req.pop(row, None)
            records = self.session.records.pop(row, None)
            if req is not None and req.resolve(tokens, latency=self.latency, records=records):
                self.stats["completed"] += 1
                self.stats["acceptance_sum"] += acceptance


def make_server(scheduler, tokenizer, default_cfg: GenerationConfig,
                host: str = "127.0.0.1", port: int = 8000):
    """A ``ThreadingHTTPServer`` over a running scheduler (not yet serving):

    POST /generate  {"prompt": "...", "max_steps": 64, ...} ->
                    {"text": "...", "tokens": [...]}
    GET  /healthz   -> {"ok": true, "stats": {..., "latency": {...}},
                        "spans": {name: {"count", "p50_ms", "p95_ms"}}}

    A continuous scheduler serves one configuration: per-request overrides
    other than ``max_steps`` (the request's budget) and ``seed`` get 400."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                stats = dict(scheduler.stats, latency=scheduler.latency.summary())
                self._json(200, {"ok": True, "stats": stats,
                                 "spans": profiling.RECORDER.summary()})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                prompt = payload.pop("prompt")
                seed = int(payload.pop("seed", 0))
                overrides = {k: v for k, v in payload.items() if hasattr(default_cfg, k)}
                cfg = dataclasses.replace(default_cfg, **overrides)
                if hasattr(tokenizer, "encode"):
                    ids = list(tokenizer.encode(prompt))
                else:
                    enc = tokenizer(prompt)
                    ids = list(enc["input_ids"] if isinstance(enc, dict) else enc.input_ids)
                if isinstance(scheduler, ContinuousBatchScheduler):
                    ignored = {k: v for k, v in overrides.items()
                               if k != "max_steps" and getattr(default_cfg, k) != v}
                    if ignored:
                        self._json(400, {
                            "error": "continuous mode serves one config; unsupported "
                                     f"per-request overrides: {sorted(ignored)}"})
                        return
                    tokens = scheduler.generate(
                        ids, timeout=300, seed=seed,
                        max_tokens=int(overrides.get("max_steps", 0)))
                else:
                    tokens = scheduler.generate(ids, cfg, seed, timeout=300)
                self._json(200, {"tokens": tokens, "text": tokenizer.decode(tokens)})
            except Exception as exc:  # the server keeps serving
                self._json(500, {"error": str(exc)})

    return ThreadingHTTPServer((host, port), Handler)


def serve(scheduler, tokenizer, default_cfg: GenerationConfig,
          host: str = "127.0.0.1", port: int = 8000) -> None:
    """Blocking HTTP server over a running scheduler (see ``make_server``)."""
    run_server(make_server(scheduler, tokenizer, default_cfg, host, port))


def run_server(server) -> None:
    """Serve until interrupted, then close the socket."""
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  (POST /generate)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="HTTP generation server")
    ap.add_argument("--model", required=True)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000, help="0 picks a free port")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--continuous", action="store_true",
                    help="in-flight continuous batching (one shared config)")
    ap.add_argument("--prompt-bucket", type=int, default=256)
    ap.add_argument("--paged-pool-pages", type=int, default=0,
                    help="with --continuous: paged KV, a pool of N shared pages "
                         "instead of per-slot worst-case buffers")
    ap.add_argument("--page-size", type=int, default=256)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV pages across requests "
                         "(requires --paged-pool-pages)")
    ap.add_argument("--quantize", default="none", choices=("none", "int8", "int4"),
                    help="weight-only quantization at load")
    ap.add_argument("--chunk-prefill-tokens", type=int, default=0,
                    help="with --continuous (contiguous KV): prefill new prompts "
                         "in N-token chunks between decode rounds")
    ap.add_argument("--generation_strategy", default="self_speculative")
    ap.add_argument("--exit_layer", type=int, default=8)
    ap.add_argument("--num_speculations", type=int, default=6)
    ap.add_argument("--max_steps", type=int, default=256)
    ap.add_argument("--sample", type=lambda v: v.lower() == "true", default=True)
    return ap.parse_args(argv)


def build_from_args(args):
    """(started scheduler, HTTP server bound to ``args.host:args.port`` and
    not yet serving) for parsed ``main`` flags. The caller serves
    (``run_server``) and stops the scheduler."""
    from layerskip_tpu_torch.cli.loading import load_model_and_tokenizer

    params, cfg, tokenizer = load_model_and_tokenizer(
        args.model, quantize=args.quantize, device=args.device)
    engine = Engine(params, cfg, device=args.device)
    default_cfg = GenerationConfig(
        generation_strategy=args.generation_strategy,
        exit_layer=min(args.exit_layer, cfg.num_hidden_layers - 1),
        num_speculations=args.num_speculations,
        max_steps=args.max_steps,
        sample=args.sample,
    )
    if args.continuous:
        sched = ContinuousBatchScheduler(
            engine, default_cfg, batch_size=args.batch_size,
            prompt_bucket=args.prompt_bucket, paged_pool_pages=args.paged_pool_pages,
            page_size=args.page_size, prefix_cache=args.prefix_cache,
            chunk_prefill_tokens=args.chunk_prefill_tokens)
    else:
        sched = BatchScheduler(engine, batch_size=args.batch_size)
    sched.start()
    try:
        return sched, make_server(sched, tokenizer, default_cfg, args.host, args.port)
    except OSError:  # the address is taken: stop the scheduler's thread
        sched.stop()
        raise


def main(argv=None) -> None:
    """CLI: python -m layerskip_tpu_torch.serving --model <dir|random:preset> ..."""
    sched, server = build_from_args(parse_args(argv))
    try:
        run_server(server)
    finally:
        sched.stop()


if __name__ == "__main__":
    main()
