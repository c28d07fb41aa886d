"""The draft passes, then the verify with acceptance and commit, of a
greedy continuous round, replayed from two CUDA graphs per session.

A round's draft is W passes of layers [0, E) and the head, with the
argmax, one-hot and history scatter after each; its verify runs the
window through layers [E, L) and the head, then accepts and commits: each
over a thousand small kernels, launched by the host in turn, so the card
waits on Python. ``DraftGraph`` captures ``spec.early_exit_draft`` and
``VerifyGraph`` ``spec.early_exit_verify`` once, when the session is
built, over its blank state (every table entry points at the trash page,
so the warm-ups' KV writes land where no query looks). Each round copies
its inputs into the draft graph's static buffers (next token, context
lengths, history and its length) and the rest of its state into the
verify graph's (prompt and output lengths, outputs, budgets, done flags,
counters), then replays both; the verify graph reads the draft graph's
outputs and buffers as they lie, and its own outputs are the session's
new state until the next round copies them back in.

The graphs hold the addresses they were captured with: the weights, the
KV (contiguous buffers or the paged pools) and the one page table, which
insert and park update in place. A replay refuses a state whose KV is not
the captured one.

``eager_reason`` decides, from the session's round plan and its engine,
whether its rounds replay: greedy early-exit drafting from the base
weights, dense and unsharded, on a CUDA device. Sampled sessions (per-row
generators rebuilt at every insert, which a captured draw would keep
using), adaptive, prompt-lookup, hybrid and tree drafting, a quantized
drafter or base, MoE layers (their grouped path reads sizes on the host),
Gemma's embedding scale (a host copy), an n-gram ban and a sharded engine
draft and verify eagerly, as before. Both graphs refuse a plan that the
rule's plan half (``plan_reason``) keeps eager.

While a profiler records, a replay adds to ``profiling.RECORDS`` the K2
calls its graph holds, with that replay's positions (the static context
lengths plus each pass's offsets, computed only then), and every replay
adds the K2/K3 launches it makes to the kernel wrappers' counters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from layerskip_tpu_torch.generation.core import RoundPlan
from layerskip_tpu_torch.generation.spec import early_exit_draft, early_exit_verify
from layerskip_tpu_torch.ops.cuda.paged_decode import (
    paged_decode_attention,
    paged_decode_attention_q8,
)
from layerskip_tpu_torch.ops.linear import QuantTensor
from layerskip_tpu_torch.utils import profiling

WARMUP = 3  # eager runs on a side stream before the capture


def plan_reason(plan: RoundPlan) -> Optional[str]:
    """Why rounds of ``plan`` draft eagerly on any engine, or None for
    greedy early-exit drafting from the base weights."""
    checks = (
        (plan.scfg.sample, "sampled drafts"),
        (bool(plan.ngram), "an n-gram ban"),
        (plan.source == "adaptive", "adaptive drafting"),
        (plan.source in ("lookup", "hybrid"), "prompt-lookup or hybrid drafting"),
        (plan.source == "tree", "tree drafting"),
        (plan.draft_params is not None, "a quantized drafter"),
    )
    return next((why for hit, why in checks if hit), None)


def eager_reason(session) -> Optional[str]:
    """Why ``session`` (a ``ContinuousSession``) drafts eagerly, or None
    when its draft passes replay from a ``DraftGraph``: a sharded engine,
    then its plan (``plan_reason``), then the rest of its engine."""
    eng = session.engine
    if eng.shard is not None:
        return "a sharded engine"
    layers = eng.params.layers
    weights = (layers.wq, layers.wk, layers.wv, layers.wo, layers.w_gate, layers.w_up,
               layers.w_down, eng.params.lm_head)
    checks = (
        (any(isinstance(w, QuantTensor) for w in weights), "a quantized base"),
        (layers.w_router is not None, "MoE layers"),
        (eng.cfg.scale_embeddings, "an embedding scale"),
        (eng.device.type != "cuda", "no CUDA device"),
    )
    return plan_reason(session.plan) or next((why for hit, why in checks if hit), None)


def _launch_counts() -> tuple:
    return paged_decode_attention.launches, paged_decode_attention_q8.launches


class _Graph:
    """What the two graphs share: a function of static buffers (``_run``),
    the K1/K2 records and K2/K3 launches of one eager call of it, its
    capture over the session's blank state, and its replay. A subclass sets
    ``ctx`` (the static context lengths its K2 positions are counted from)
    and ``_run``, then calls ``_build``."""

    ctx: torch.Tensor

    def _build(self, capture: bool) -> None:
        """The template of calls (``_calls``), then, with ``capture``, the
        graph: ``WARMUP`` eager runs on a side stream (the template's the
        first), then the capture. The warm-ups and the capture count no
        launches."""
        self.replays = 0
        self.graph = None
        self._out = None
        if not capture:
            self._template, self._offsets, self._launches = self._calls()
            return
        counts = _launch_counts()
        with torch.cuda.device(self.ctx.device):
            cur, side = torch.cuda.current_stream(), torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._template, self._offsets, self._launches = self._calls()
                for _ in range(WARMUP - 1):
                    self._run()
            cur.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self._out = self._run()
        paged_decode_attention.launches, paged_decode_attention_q8.launches = counts

    def _calls(self):
        """One eager run: the K1/K2 records the graph's calls would make,
        each K2 positions tensor replaced by the index of its offsets from
        ``ctx`` (one set a pass, shared by its layers), those offsets, and
        the K2 and K3 launches it makes."""
        before = _launch_counts()
        with profiling.RECORDS.calls_of() as calls:
            self._run()
        launches = tuple(a - b for a, b in zip(_launch_counts(), before))
        sets, offsets, template = {}, [], []
        for kind, rec in calls:
            if kind == "k2":
                pos = rec[1]
                if id(pos) not in sets:
                    sets[id(pos)] = len(offsets)
                    offsets.append(pos.long() - self.ctx[:, None])
                rec = (rec[0], sets[id(pos)]) + rec[2:]
            template.append((kind, rec))
        return template, offsets, launches

    def _record_replay(self) -> None:
        """Add the graph's K1/K2 calls to ``profiling.RECORDS``, each K2
        call with its pass's positions in this replay."""
        pos = [self.ctx[:, None] + off for off in self._offsets]
        for kind, rec in self._template:
            if kind == "k2":
                rec = (rec[0], pos[rec[1]]) + rec[2:]
            profiling.RECORDS.add(kind, rec)

    def _launch(self, *staged):
        """Replay the graph (or run the staged call on ``staged``), counting
        the round, its K2/K3 launches and, while a profiler records, its
        K1/K2 calls."""
        self.replays += 1
        if self.graph is None:
            return self._run(*staged)
        self.graph.replay()
        if _autograd_profiler._is_profiler_enabled:
            self._record_replay()
        paged_decode_attention.launches += self._launches[0]
        paged_decode_attention_q8.launches += self._launches[1]
        return self._out


def _refuse(plan: RoundPlan, what: str) -> None:
    why = plan_reason(plan)
    if why is not None:
        raise ValueError(f"a {what} graph replays greedy early-exit drafts from the base "
                         f"weights only, not {why}")


class DraftGraph(_Graph):
    """Static inputs ``next_tok`` [B, 1], ``ctx`` [B], ``hist`` [B, H] and
    ``hist_len0`` [B], and the draft of ``session``'s state captured over
    them (``capture``), or, without ``capture``, the same staging around an
    eager call (the CPU tests). ``replays`` counts the rounds drafted. The
    session's plan must be greedy early exit from the base weights."""

    def __init__(self, session, capture: bool = True):
        s, plan = session.state, session.plan
        _refuse(plan, "draft")
        self._params, self._cfg = session.engine.params, session.engine.cfg
        self._settings = dict(exit_layer=plan.exit_layer,
                              num_speculations=plan.num_speculations, scfg=plan.scfg)
        self.early = s.early
        self.next_tok, self.ctx, self.hist = s.next_tok.clone(), s.ctx.clone(), s.hist.clone()
        self.hist_len0 = s.prompt_len + s.out_len
        self._build(capture)

    def _run(self):
        return early_exit_draft(self._params, self._cfg, self.early, self.next_tok, self.ctx,
                                self.hist, self.hist_len0, **self._settings)

    def replay(self, s, hist_len0: torch.Tensor):
        """The W drafts of state ``s`` (``early_exit_draft``'s outputs):
        its inputs copied in, then the graph replayed (or the staged call
        run)."""
        if s.early.k is not self.early.k or s.early.v is not self.early.v:
            raise RuntimeError("the session's early KV is not the one the draft graph holds")
        self.next_tok.copy_(s.next_tok)
        self.ctx.copy_(s.ctx)
        self.hist.copy_(s.hist)
        self.hist_len0.copy_(hist_len0)
        return self._launch()


# the state a verify replay copies in (the draft graph's replay copies
# next_tok, ctx and hist, which the verify reads from its buffers)
_STATE = ("prompt_len", "out", "out_len", "steps", "done", "matches", "drafts")


class VerifyGraph(_Graph):
    """The verify pass, acceptance and commit of a greedy early-exit round
    (``spec.early_exit_verify``) over ``draft``'s static outputs and static
    copies of the round's state, captured over ``session``'s blank state
    (``capture``), or, without it, the same staging around an eager call
    (the CPU tests). Its inputs are ``draft``'s own buffers where the draft
    has them (``next_tok``, ``ctx``, ``hist``, ``hist_len0`` and its
    outputs); its output is the round's new state, window and ``n``, in
    static buffers. ``replays`` counts the rounds verified."""

    def __init__(self, session, draft: DraftGraph, capture: bool = True):
        s, plan = session.state, session.plan
        _refuse(plan, "verify")
        self._params, self._cfg, self._plan = session.engine.params, session.engine.cfg, plan
        self.early, self.full = s.early, s.full
        self.ctx, self.hist_len0 = draft.ctx, draft.hist_len0
        self.inputs = dataclasses.replace(
            s, next_tok=draft.next_tok, ctx=draft.ctx, hist=draft.hist, generator=None,
            **{name: getattr(s, name).clone() for name in _STATE})
        if draft.graph is None:
            self._drafted = draft._run()
        else:  # the draft's outputs hold the blank state's drafts from here on
            draft.graph.replay()
            self._drafted = draft._out
        self._build(capture)

    def _run(self, drafted=None):
        return early_exit_verify(self._params, self._cfg, self.inputs, self._plan,
                                 self._drafted if drafted is None else drafted, self.hist_len0)

    def replay(self, s, drafted):
        """The round's (new state, window, n) from state ``s`` and the
        draft graph's outputs ``drafted``: the state copied in, then the
        graph replayed (or the staged call run on ``drafted``). The new
        state keeps ``s``'s generators."""
        if (s.early.k is not self.early.k or s.early.v is not self.early.v
                or s.full.k is not self.full.k or s.full.v is not self.full.v):
            raise RuntimeError("the session's KV is not the one the verify graph holds")
        if self.graph is not None and drafted is not self._drafted:
            raise RuntimeError("a verify replay reads the draft graph's own outputs")
        for name in _STATE:
            src, dst = getattr(s, name), getattr(self.inputs, name)
            if src is not dst:
                dst.copy_(src)
        state, window, n = self._launch(drafted)
        return dataclasses.replace(state, generator=s.generator), window, n
