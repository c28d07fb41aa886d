"""Continuous batching (port of ``layerskip_tpu/generation/continuous.py``
and of what ``Engine._compiled_continuous`` builds there).

Requests join and leave a live speculation state at round granularity, with
any draft source (early exit, adaptive, prompt lookup, hybrid, or tree
rounds, generation/tree.py):
``_spec_insert_rows`` prefills new prompts into chosen rows while the other
rows keep their KV, counters and buffers; ``_chunk_prefill_rows`` does it one
prompt chunk at a time. ``ContinuousSession`` holds the state and drives
it: slots, page allocation, prefix caching, per-request seeds and budgets,
rounds and harvest. Its device steps (blank state, insert, round,
multi-round, park) are the plain methods the JAX engine compiles.

Caches are written in place, as everywhere in the port. Over a paged pool
an insert runs only the inserted rows, through a copy of their table rows.
Over a contiguous cache, rows not being inserted still run through the
batched prefill; their writes go to a trash zone past every reachable
frontier (the last ``prompt_bucket`` slots), which the mask never lets a
live query see. Each row samples from its own ``torch.Generator``,
seeded from the request's seed when it is inserted, so a request's sampled
stream depends only on its prompt, seed and budget, never on its slot or
its neighbours. Greedy decoding draws nothing.

A session over a mixture-of-experts model keeps each slot's route records
on the device (``RouteSink``, models/llama.py): the expert ids every MoE
layer chose for the token at each position, written by the pass that
writes that token's KV, so a rejected draft's record is overwritten with
its KV. A finished row's records come back at harvest (``records``).

The JAX package's ``LAYERSKIP_PREFIX_NARROW`` opt-in (a second, narrower
insert executable on prefix-cache hits) is not ported: eager PyTorch has no
second executable to switch to.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from layerskip_tpu_torch.config import ModelConfig
from layerskip_tpu_torch.generation.core import (
    RoundPlan,
    _SpecState,
    _is_eos,
    _mk_group_cache,
    _row_update,
)
from layerskip_tpu_torch.generation.draft_graph import DraftGraph, VerifyGraph, eager_reason
from layerskip_tpu_torch.generation.processors import apply_ban, no_repeat_ngram_banned
from layerskip_tpu_torch.generation.sampling import draw, token_distribution
from layerskip_tpu_torch.generation.spec import _spec_round
from layerskip_tpu_torch.generation.tree import _tree_round
from layerskip_tpu_torch.models import llama
from layerskip_tpu_torch.models.llama import NO_ROUTE, LlamaParams, RouteSink
from layerskip_tpu_torch.ops.kv_cache import KVCache
from layerskip_tpu_torch.ops.paged_kv import (
    PageAllocator,
    PagedKV,
    PagedQuantKV,
    PagePoolExhausted,
    PrefixCache,
    init_paged_group,
    paged_geometry,
)
from layerskip_tpu_torch.utils.profiling import span


def _row_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _rows_view(group: KVCache, table: torch.Tensor) -> KVCache:
    """A paged layer group seen through ``table`` (some rows' table rows):
    the same pools, so writes through it land in the shared pool."""
    return KVCache(k=dataclasses.replace(group.k, table=table),
                   v=dataclasses.replace(group.v, table=table))


def _spec_insert_rows(
    params: LlamaParams,
    cfg: ModelConfig,
    s: _SpecState,
    row_mask: Sequence[bool],  # [B] host mask: rows to (re)initialize
    ids: torch.Tensor,  # [B, P] right-padded prompts (only masked rows read)
    true_len: torch.Tensor,  # [B]
    seeds: Optional[Sequence[int]] = None,  # [B] per-request sampling seeds
    steps: Optional[torch.Tensor] = None,  # [B] per-request max tokens
    new_table: Optional[torch.Tensor] = None,  # [B, maxp] int32 table rows for
    # the inserted slots (paged KV only)
    prefix_len: Optional[torch.Tensor] = None,  # [B] page-aligned cached
    # prompt-prefix lengths: that KV already lives in shared pages, so the
    # prefill runs on the prompt suffix at past = prefix_len
    suffix_ids: Optional[torch.Tensor] = None,  # [B, SB] suffix tokens
    *,
    plan: RoundPlan,
    max_steps: int,
    routes: Optional[RouteSink] = None,
) -> _SpecState:
    """Prefill new requests into the masked rows of a live speculation
    state. The other rows keep their KV, counters and buffers. Over a paged
    pool only the inserted rows run, through a copy of their table rows,
    and write into the shared pool in place. Over a contiguous cache the
    batched prefill runs every row, the others at the trash position.
    ``routes`` takes the prefill's expert ids where it writes KV."""
    b, p_bucket = ids.shape
    dev = ids.device
    rows = [r for r in range(b) if row_mask[r]]
    with span("sync", site="insert.rows"):
        idx = torch.as_tensor(rows, device=dev)
    with span("sync", site="insert.mask"):
        m = torch.as_tensor(np.asarray(row_mask, bool), device=dev)
    w, ngram, scfg = plan.num_speculations, plan.ngram, plan.scfg
    if prefix_len is None:
        pl = torch.zeros((b,), dtype=torch.long, device=dev)
        window_ids = ids
    else:
        pl = torch.where(m, prefix_len.long(), 0)
        if suffix_ids is None:
            cols = pl[:, None] + torch.arange(p_bucket, device=dev)[None]
            suffix_ids = ids.gather(1, cols.clamp(max=p_bucket - 1))
        window_ids = suffix_ids
    last = (true_len - pl).clamp_min(1) - 1
    if isinstance(s.early.k, (PagedKV, PagedQuantKV)):
        # one table serves k, v and both layer groups: merge the inserted
        # rows' entries, then run those rows alone. Without a prefix every
        # row starts at 0, so the prompt block may take K1
        with span("sync", site="insert.table"):  # a boolean mask's row count
            s.early.k.table[m] = new_table[m]
        sub = s.early.k.table[idx]
        past = 0 if prefix_len is None else pl[idx]
        res = llama.forward_split(params, cfg, window_ids[idx], _rows_view(s.early, sub),
                                  _rows_view(s.full, sub), past, plan.exit_layer,
                                  last_pos=last[idx],
                                  routes=None if routes is None
                                  else dataclasses.replace(routes, rows=idx))
        last_logits = res.logits[:, 0]  # [rows, V]
        early, full = s.early, s.full
    else:
        past = torch.where(m, pl, s.early.k.shape[2] - p_bucket)
        res = llama.forward_split(params, cfg, window_ids, s.early, s.full, past,
                                  plan.exit_layer, last_pos=last, routes=routes)
        last_logits = res.logits[idx, 0]  # [rows, V]
        early, full = res.early_cache, res.full_cache
    out_size = max_steps + w + 1
    hist_new = torch.cat([ids, torch.zeros((b, out_size), dtype=ids.dtype, device=dev)], 1)
    if ngram > 0:
        last_logits = apply_ban(last_logits, no_repeat_ngram_banned(
            hist_new[idx], true_len[idx], ngram, cfg.vocab_size))
    gens = list(s.generator)
    for r in rows:
        gens[r] = _row_generator(dev, seeds[r] if seeds is not None else 0)
    tok0 = torch.zeros((b,), dtype=torch.long, device=dev)
    tok0[idx] = draw(token_distribution(last_logits, scfg), [gens[r] for r in rows], scfg)
    hist_new = _row_update(hist_new, tok0[:, None], true_len)
    out_new = torch.zeros((b, out_size), dtype=torch.long, device=dev)
    out_new[:, 0] = tok0
    row_steps = (steps.long().clamp(1, max_steps) if steps is not None
                 else torch.full((b,), max_steps, dtype=torch.long, device=dev))
    m1 = m[:, None]
    return _SpecState(
        early=early,
        full=full,
        ctx=torch.where(m, true_len, s.ctx),
        prompt_len=torch.where(m, true_len, s.prompt_len),
        next_tok=torch.where(m1, tok0[:, None], s.next_tok),
        out=torch.where(m1, out_new, s.out),
        hist=torch.where(m1, hist_new, s.hist),
        out_len=torch.where(m, 1, s.out_len),
        steps=torch.where(m, row_steps, s.steps),
        done=torch.where(m, _is_eos(tok0, plan.eos_ids) | (row_steps <= 1), s.done),
        matches=torch.where(m, 0, s.matches),
        drafts=torch.where(m, 0, s.drafts),
        generator=gens,
    )


def _chunk_prefill_rows(
    params: LlamaParams,
    cfg: ModelConfig,
    s: _SpecState,
    row_mask: Sequence[bool],  # [B] host mask: rows being chunk-prefilled
    chunk_ids: torch.Tensor,  # [B, C] one C-token slice of the prompt
    off: int,  # chunk start position
    *,
    exit_layer: int,
    prompt_bucket: int,
    routes: Optional[RouteSink] = None,
) -> _SpecState:
    """KV-only prefill of one prompt chunk into the masked rows (contiguous
    KV): writes their KV at [off, off + C); other rows pass through the
    trash zone as in ``_spec_insert_rows``. No sampling and no counters.
    The inserted rows' ``ctx`` is parked at the trash start while the chunks
    run: rounds interleaved between chunks run every row and write W + 1
    slots at its ctx, which must not land in the half-built prompt. The
    finalize (``_spec_insert_rows`` on a 1-token suffix at
    prefix_len = true_len - 1) samples the first token and un-parks."""
    b = chunk_ids.shape[0]
    dev = chunk_ids.device
    with span("sync", site="chunk.mask"):
        m = torch.as_tensor(np.asarray(row_mask, bool), device=dev)
    park = s.early.k.shape[2] - prompt_bucket
    past = torch.where(m, int(off), park)
    res = llama.forward_split(params, cfg, chunk_ids, s.early, s.full, past, exit_layer,
                              last_pos=torch.zeros((b,), dtype=torch.long, device=dev),
                              routes=routes)
    return dataclasses.replace(s, early=res.early_cache, full=res.full_cache,
                               ctx=torch.where(m, park, s.ctx))


class ContinuousSession:
    """Live multi-slot decode state for continuous batching: rows are
    inserted and harvested independently while other rows keep decoding.
    Device work runs under ``torch.inference_mode()`` and the engine's
    sharded context inside each method (``Engine.inference``; both are per
    thread, so a scheduler thread may call them).

    Where the host waits for the device, each a ``sync`` span with its site
    (``utils/profiling.py``): ``step`` reads ``done.all()`` before each round
    (the read that finds every row done ends the loop), then the done flags
    and counters once; a step that finishes a row reads its outputs, matches
    and drafts, three reads more. ``insert`` copies its host arrays to the
    device (a copy from pageable memory synchronises the stream), and over a
    paged pool indexes the table with a boolean mask, whose row count is
    read. Spans ``session.insert`` (rows, prompt tokens), ``session.step``
    (rounds, tokens committed, the finished requests) and ``session.round``
    cover the methods; ``request_ids`` holds the request each slot serves
    (-1 for none), set by the caller before ``insert``, for those spans.

    ``draft_graph`` and ``verify_graph``: for greedy early-exit drafting
    from the base weights (dense, unsharded, on a CUDA device;
    ``draft_graph.eager_reason`` says why not otherwise) the session
    captures the W draft passes of a round in one CUDA graph and the
    verify pass with acceptance and commit in another when it is built,
    over its blank state, and every round replays both (the ``spec.draft``
    and ``spec.verify`` spans' ``graph`` is 1); ``state`` then holds the
    verify graph's static outputs, which the next round copies back in.
    Sampled, adaptive, prompt-lookup, hybrid, tree, quantized-drafter, MoE
    and sharded sessions draft and verify eagerly (both None, ``graph``
    0). Insert and park build the state anew and update the KV pools and
    the page table in place, at the addresses the graphs hold.

    ``routes``: over a mixture-of-experts model (tree rounds excepted,
    whose chains share positions) a ``RouteSink`` over a uint8 buffer [L,
    slots, positions, k], ``NO_ROUTE`` where no pass wrote; an insert
    clears its slots first. A step that finishes rows reads their records
    for every position fed (the prompt and the served tokens but the last)
    in one more read (``sync`` site ``harvest.routes``), and ``records``
    maps each such row to ``{"routes": uint8 [L, positions, k]}`` until
    it finishes again. Dense sessions keep no buffer and make no read.

    The contiguous cache has ``prompt_bucket`` extra trailing slots, the
    trash zone parked rows write into. Under ``paged`` (pool_pages,
    page_size) rows map logical positions through one shared page table
    (ops/paged_kv.py), and positions past a row's mapping go to the trash
    pages."""

    def __init__(self, engine, gen_cfg, plan: RoundPlan, batch: int, prompt_bucket: int,
                 paged=None, prefix_cache: bool = False):
        self.engine = engine
        self.gen_cfg = gen_cfg
        self.plan = plan  # how every round drafts (Engine.round_plan)
        self.batch = batch
        self.prompt_bucket = prompt_bucket
        self.paged = paged  # (pool_pages, page_size) or None
        # KV slots a round may write past a row's frontier: a tree parks k
        # interleaved chains of W
        self._slack = plan.num_speculations * max(plan.tree_width, 1)
        # the longest logical context a row's frontier can reach
        self._capacity = prompt_bucket + gen_cfg.max_steps + self._slack + 2
        self.prefix_cache = None
        self.allocator = None
        if paged:
            pool_pages, page_size = paged
            self._max_pages = paged_geometry(self._capacity, page_size, prompt_bucket)[2]
            self.allocator = PageAllocator(pool_pages, page_size)
            if prefix_cache:
                self.prefix_cache = PrefixCache(self.allocator)
        elif prefix_cache:
            raise ValueError("prefix_cache requires paged KV")
        with self.engine.inference():
            self.state = self._blank_state()
            self.routes = self._route_sink()
            # the draft passes, then the verify, of each round replay from
            # two CUDA graphs, captured here over the blank state, where the
            # session allows
            self.draft_graph = self.verify_graph = None
            if eager_reason(self) is None:
                self.draft_graph = DraftGraph(self)
                self.verify_graph = VerifyGraph(self, self.draft_graph)
        self.active = np.zeros(batch, bool)  # slot holds a live request
        self.request_ids = np.full(batch, -1, np.int64)
        # host mirrors from the last sync, for min_rounds_bound()
        self._out_len = np.zeros(batch, np.int64)
        self._steps = np.full(batch, gen_cfg.max_steps, np.int64)
        self._done = np.ones(batch, bool)
        self._prompt_len = np.ones(batch, np.int64)
        self.records = {}  # row -> what the program kept for its last request
        # chunked prefill staging: queued chunk passes and the finalize args,
        # advanced one chunk per step()
        self._chunk_queue = []
        self._chunk_finalize = None
        self._pending = np.zeros(batch, bool)  # slots mid-chunked-prefill

    # -- device steps --------------------------------------------------------

    def _group(self, nlayers: int, table: Optional[torch.Tensor]):
        cfg, kv_quant = self.engine.cfg, self.plan.kv_quant
        if self.paged:
            pool_pages, page_size = self.paged
            return init_paged_group(cfg, nlayers, self.batch, pool_pages, page_size,
                                    self._capacity, self.prompt_bucket, quant=kv_quant,
                                    table=table, device=self.engine.device)
        return _mk_group_cache(cfg, nlayers, self.batch, self._capacity + self.prompt_bucket,
                               self.engine.device, kv_quant)

    def _blank_state(self) -> _SpecState:
        b, dev, e = self.batch, self.engine.device, self.plan.exit_layer
        table = None
        if self.paged:
            table = torch.full((b, self._max_pages), self.paged[0], dtype=torch.int32,
                               device=dev)
        out_size = self.gen_cfg.max_steps + self.plan.num_speculations + 1
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.long, device=dev)  # noqa: E731
        return _SpecState(
            early=self._group(e, table),
            full=self._group(self.engine.cfg.num_hidden_layers - e, table),
            ctx=zeros(b),
            prompt_len=torch.ones((b,), dtype=torch.long, device=dev),
            next_tok=zeros(b, 1),
            out=zeros(b, out_size),
            hist=zeros(b, self.prompt_bucket + out_size),
            out_len=zeros(b),
            steps=torch.full((b,), self.gen_cfg.max_steps, dtype=torch.long, device=dev),
            done=torch.ones((b,), dtype=torch.bool, device=dev),
            matches=zeros(b),
            drafts=zeros(b),
            generator=[_row_generator(dev, 0) for _ in range(b)],
        )

    def _route_sink(self) -> Optional[RouteSink]:
        cfg = self.engine.cfg
        if not cfg.is_moe or self.plan.source == "tree":
            return None
        # every slot a KV write can reach: the capacity and, over a
        # contiguous cache, the trash zone past it
        shape = (cfg.num_hidden_layers, self.batch, self._capacity + self.prompt_bucket,
                 cfg.num_experts_per_tok)
        return RouteSink(torch.full(shape, NO_ROUTE, dtype=torch.uint8,
                                    device=self.engine.device))

    def _clear_routes(self, rows) -> None:
        if self.routes is not None:
            with self.engine.inference():
                for r in rows:
                    self.routes.buf[:, r].fill_(NO_ROUTE)

    def _insert_rows(self, row_mask, ids, true_len, seeds, steps, new_table=None,
                     prefix_len=None, suffix_ids=None) -> None:
        self.state = _spec_insert_rows(
            self.engine.params, self.engine.cfg, self.state, row_mask, ids, true_len,
            seeds, steps, new_table, prefix_len, suffix_ids, plan=self.plan,
            max_steps=self.gen_cfg.max_steps, routes=self.routes)

    def _multi_round(self, k: int) -> int:
        """Up to ``k`` rounds; stops as soon as every row is done. Returns the
        rounds run."""
        eng, plan = self.engine, self.plan
        ran = 0
        for _ in range(k):
            with span("session.round"):
                with span("sync", site="round.done"):
                    done = bool(self.state.done.all())
                if done:
                    break
                if plan.source == "tree":
                    self.state = _tree_round(eng.params, eng.cfg, self.state, plan)[0]
                else:
                    self.state = _spec_round(eng.params, eng.cfg, self.state, plan,
                                             draft_graph=self.draft_graph,
                                             verify_graph=self.verify_graph,
                                             routes=self.routes)[0]
            ran += 1
        return ran

    # -- host side -----------------------------------------------------------

    def free_slots(self):
        return [i for i in range(self.batch) if not self.active[i] and not self._pending[i]]

    def _host_rows(self, rows, prompts, seeds, max_tokens):
        """(mask, ids, lens, seeds, budgets) host arrays for an insert."""
        if not rows or len(rows) != len(prompts):
            raise ValueError(f"{len(rows)} rows for {len(prompts)} prompts")
        mask = np.zeros(self.batch, bool)
        ids = np.zeros((self.batch, self.prompt_bucket), np.int64)
        lens = np.ones(self.batch, np.int64)
        seed_vec = np.zeros(self.batch, np.int64)
        steps_vec = np.full(self.batch, self.gen_cfg.max_steps, np.int64)
        for k, (r, prompt) in enumerate(zip(rows, prompts)):
            toks = list(prompt)[-self.prompt_bucket:]
            mask[r] = True
            ids[r, :len(toks)] = toks
            lens[r] = max(len(toks), 1)
            if seeds is not None:
                seed_vec[r] = int(seeds[k])
            if max_tokens is not None and max_tokens[k]:
                steps_vec[r] = int(max_tokens[k])
        return mask, ids, lens, seed_vec, steps_vec

    def _dev(self, x) -> torch.Tensor:
        with span("sync", site="h2d"):
            return torch.as_tensor(x, device=self.engine.device)

    def insert(self, rows, prompts, seeds=None, max_tokens=None) -> None:
        """Prefill ``prompts[k]`` into slot ``rows[k]`` (others untouched).
        ``seeds[k]`` gives a request its own sampling stream and
        ``max_tokens[k]`` its own budget (clamped to ``max_steps``). Paged:
        raises ``PagePoolExhausted`` with the allocator restored and the
        device state untouched when the pool cannot hold them."""
        with span("session.insert", rids=[int(self.request_ids[r]) for r in rows],
                  rows=len(rows),
                  prompt_tokens=sum(min(len(p), self.prompt_bucket) for p in prompts)):
            self._insert(rows, prompts, seeds, max_tokens)

    def _insert(self, rows, prompts, seeds, max_tokens) -> None:
        for r in rows:
            # the staged chunk passes would park the new request's ctx and
            # the queued finalize would bring back the old prompt
            if self._pending[r]:
                raise ValueError(f"slot {r} has a chunked prefill in flight")
        mask, ids, lens, seed_vec, steps_vec = self._host_rows(rows, prompts, seeds,
                                                               max_tokens)
        slot_pages, paged_args = {}, ()
        prompts_by_row = {r: list(p)[-self.prompt_bucket:] for r, p in zip(rows, prompts)}
        if self.paged:
            # map exactly what each request's frontier can reach (prompt,
            # clipped budget, speculation overhang); the rest maps to trash.
            # All host-side, before any device change.
            pool_pages = self.paged[0]
            w = self._slack
            clipped = np.clip(steps_vec, 1, self.gen_cfg.max_steps)
            prefix_vec = np.zeros(self.batch, np.int64)
            for attempt in (0, 1):
                table = np.full((self.batch, self._max_pages), pool_pages, np.int32)
                snapshot = self.allocator.snapshot()
                try:
                    for r in rows:
                        shared, pmatch = [], 0
                        if self.prefix_cache is not None:
                            pmatch, shared = self.prefix_cache.match(prompts_by_row[r])
                        need = int(lens[r]) + int(clipped[r]) + w + 2
                        pages = self.allocator.allocate(r, need, shared)
                        table[r, :len(pages)] = pages
                        prefix_vec[r] = pmatch
                        slot_pages[r] = pages
                    break
                except PagePoolExhausted:
                    self.allocator.restore(snapshot)  # all or nothing
                    slot_pages.clear()
                    # shed cold cache entries and retry once before
                    # surfacing backpressure to the scheduler
                    if attempt == 0 and self.prefix_cache is not None \
                            and self.prefix_cache.evict(self._max_pages):
                        continue
                    raise
            # no prefix hit: every inserted row starts at 0 (K1 may run)
            paged_args = (self._dev(table),
                          self._dev(prefix_vec) if prefix_vec.any() else None)
        self._clear_routes(rows)
        with self.engine.inference():
            self._insert_rows(mask, self._dev(ids), self._dev(lens), seed_vec.tolist(),
                              self._dev(steps_vec), *paged_args)
        if self.prefix_cache is not None:
            # the new full prompt pages never change again (decode writes
            # begin at prompt_len): publish them
            for r in rows:
                self.prefix_cache.put(prompts_by_row[r], slot_pages[r])
        self._activate(mask, np.clip(steps_vec, 1, self.gen_cfg.max_steps), lens)

    def _activate(self, mask, clipped, lens) -> None:
        # fresh rows start at out_len 1 (the prefill commits one token)
        self._prompt_len[mask] = lens[mask]
        self.active |= mask
        self._out_len[mask] = 1
        self._steps[mask] = clipped[mask]
        self._done[mask] = False

    def begin_chunked_insert(self, rows, prompts, seeds=None, max_tokens=None,
                             chunk_tokens: int = 256) -> None:
        """Stage a chunked prefill of ``prompts`` into ``rows`` (contiguous
        KV): each later ``step()`` runs one ``chunk_tokens``-wide prefill
        pass before its round, so the rows in flight wait for a chunk, not a
        whole prompt. The rows are reserved and become active on the
        finalize; the output equals a plain ``insert`` with the same seeds."""
        if self.paged:
            raise ValueError("chunked insert: contiguous KV only")
        if self.has_pending_prefill():
            raise ValueError("a chunked insert is already in flight")
        # parked rows keep taking part in rounds and write 1 + W * k slots
        # (W + 1 without a tree) at the park position: they must fit the
        # prompt_bucket-wide trash zone
        if 1 + self._slack > self.prompt_bucket:
            raise ValueError("trash zone too small for a parked row's round writes")
        for r in rows:
            if self.active[r] or self._pending[r]:
                raise ValueError(f"slot {r} is busy")
        c = min(int(chunk_tokens), self.prompt_bucket)
        if c <= 0:
            raise ValueError(f"chunk_tokens {chunk_tokens}")
        mask, ids, lens, seed_vec, steps_vec = self._host_rows(rows, prompts, seeds,
                                                               max_tokens)
        # chunks cover [0, longest prompt); the finalize recomputes the last
        # position from the KV already written
        n_chunks = max(-(-int(lens[mask].max()) // c), 1)
        for i in range(n_chunks):
            win = np.zeros((self.batch, c), np.int64)
            src = ids[:, i * c:(i + 1) * c]
            win[:, :src.shape[1]] = src
            self._chunk_queue.append((mask, self._dev(win), i * c))
        last_tok = np.take_along_axis(ids, np.maximum(lens - 1, 0)[:, None], axis=1)
        self._chunk_finalize = (mask, ids, lens, seed_vec, steps_vec, last_tok)
        self._pending |= mask
        self._clear_routes(rows)

    def _advance_chunked_insert(self) -> None:
        """Run one queued chunk pass; finalize when the queue drains."""
        if self._chunk_queue:
            mask, win, off = self._chunk_queue.pop(0)
            self.state = _chunk_prefill_rows(
                self.engine.params, self.engine.cfg, self.state, mask, win, off,
                exit_layer=self.plan.exit_layer, prompt_bucket=self.prompt_bucket,
                routes=self.routes)
        if self._chunk_queue or self._chunk_finalize is None:
            return
        mask, ids, lens, seed_vec, steps_vec, last_tok = self._chunk_finalize
        self._chunk_finalize = None
        # the chunks wrote every prompt position's KV: recompute only the
        # last one (a 1-token suffix at prefix_len = true_len - 1) for the
        # first token's logits and the bookkeeping
        true_len = self._dev(lens)
        self._insert_rows(mask, self._dev(ids), true_len, seed_vec.tolist(),
                          self._dev(steps_vec), None, (true_len - 1).clamp_min(0),
                          self._dev(last_tok))
        self._pending &= ~mask
        self._activate(mask, np.clip(steps_vec, 1, self.gen_cfg.max_steps), lens)

    def has_pending_prefill(self) -> bool:
        """True while a chunked insert is staged but not yet finalized."""
        return bool(self._chunk_queue) or self._chunk_finalize is not None

    def min_rounds_bound(self) -> int:
        """Rounds within which no live row can finish, by its budget: a round
        commits 1 to W + 1 tokens per active row, so a row with R tokens
        left needs at least ceil(R / (W + 1)). EOS can end a row sooner; that
        delays its harvest, never its output. The scheduler runs that many
        rounds per ``step`` when no waiting request could join anyway."""
        live = self.active & ~self._done
        if not live.any():
            return 1
        remaining = int((self._steps - self._out_len)[live].min())
        return max(-(-remaining // (self.plan.num_speculations + 1)), 1)

    def step(self, max_rounds: int = 1):
        """Run up to ``max_rounds`` draft+verify rounds (fewer when every
        row finishes). Returns [(row, tokens, acceptance), ...] for the rows
        that finished."""
        with span("session.step") as sp, self.engine.inference():
            if self.has_pending_prefill():
                # one staged chunk per step
                self._advance_chunked_insert()
                if not (self.active & ~self._done).any():
                    return []  # nothing decoding yet
            live = self.active & ~self._done
            before = int(np.minimum(self._out_len, self._steps)[live].sum())
            rounds = self._multi_round(int(max_rounds))
            s = self.state
            with span("sync", site="step.flags"):
                sync = torch.stack([s.done.long(), s.out_len, s.steps]).cpu().numpy()
            self._done, self._out_len, self._steps = sync[0].astype(bool), sync[1], sync[2]
            newly = [r for r in range(self.batch) if self.active[r] and self._done[r]]
            sp.set(rids=[int(self.request_ids[r]) for r in newly], rounds=rounds,
                   tokens=int(np.minimum(self._out_len, self._steps)[live].sum()) - before)
            if not newly:
                return []
            with span("sync", site="harvest.out"):
                outs = s.out.cpu().numpy()
            with span("sync", site="harvest.matches"):
                matches = s.matches.cpu().numpy()
            with span("sync", site="harvest.drafts"):
                drafts = s.drafts.cpu().numpy()
            finished = []
            for r in newly:
                toks = outs[r][:min(int(self._out_len[r]), int(self._steps[r]))].tolist()
                for e in self.plan.eos_ids:
                    if e in toks:
                        toks = toks[:toks.index(e)]
                finished.append((r, toks, float(matches[r]) / max(int(drafts[r]), 1)))
                self.active[r] = False
            if self.routes is not None:
                self._harvest_routes(finished)
        return finished

    def _harvest_routes(self, finished) -> None:
        """Read the route records of the positions each finished row fed
        (its prompt and served tokens but the last) in one read."""
        buf = self.routes.buf
        fed = [max(int(self._prompt_len[r]) + len(toks) - 1, 0) for r, toks, _ in finished]
        parts = [buf[:, r, :n].reshape(-1) for (r, _, _), n in zip(finished, fed)]
        with span("sync", site="harvest.routes"):
            flat = torch.cat(parts).cpu().numpy()
        shape = (buf.shape[0], -1, buf.shape[-1])
        for (r, _, _), part in zip(finished, np.split(flat, np.cumsum(
                [p.numel() for p in parts])[:-1])):
            self.records[r] = {"routes": part.reshape(shape)}

    def has_active(self) -> bool:
        return bool(self.active.any())

    def park_free_slots(self) -> int:
        """Reclaim the pages of finished slots not yet refilled (paged only):
        point their tables at the trash page, then free their pages. The
        scheduler calls it on ``PagePoolExhausted``; ordinary slot reuse
        frees pages inside ``PageAllocator.allocate``. Returns the pages
        reclaimed."""
        if not self.paged:
            return 0
        idle = ~self.active
        owned = [r for r in range(self.batch) if idle[r] and self.allocator.owned(r)]
        if not owned:
            return 0
        with self.engine.inference():
            # frozen rows keep writing at their frontier every round: their
            # pages may go to another slot only once their tables point at
            # the trash page
            table = self.state.early.k.table
            table[torch.as_tensor(idle, device=table.device)] = self.paged[0]
        freed = 0
        for r in owned:
            freed += len(self.allocator.owned(r))
            self.allocator.release(r)
        return freed
