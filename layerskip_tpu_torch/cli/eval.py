"""Offline evaluation: the lm-eval-harness adapter and the eval CLI (port of
``layerskip_tpu/cli/eval.py``).

``EvalHarnessLM`` routes *generation* requests through ``LlamaGenerator``
(any generation strategy) and *loglikelihood* requests through
``TokenScorer``, a plain full forward of the model, as the JAX package and
LayerSkip's ``eval.py`` do. ``lm_eval`` is not required: the adapter
inherits its ``TemplateLM`` only when it is importable, and
``--tasks local:<file.jsonl>`` runs multiple-choice docs offline through the
same calling convention (``run_local_mc``).

Usage:
  python -m layerskip_tpu_torch.cli.eval --model <dir|random:preset> \
      --tasks local:task.jsonl --batch_size 8 [--num_fewshot N] [--limit N]
  (add --device cpu to run on the CPU)

Scoring memory: a batch's logits are fp32 ``[B, bucket, V]`` on the device,
and the log-sum-exp takes a second buffer of that size for its exponentials,
so a batch peaks at about ``2 * B * bucket * V * 4`` bytes above the
weights and the KV of the forward (8 rows of 4096 tokens: 8.4 GB at V 32000,
33.6 GB at V 128256). ``--batch_size`` bounds B.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from layerskip_tpu_torch.cli.args import Arguments, parse_dataclasses
from layerskip_tpu_torch.cli.loading import coordinator_only, load_from_args, mesh_from_args
from layerskip_tpu_torch.config import GenerationConfig, ModelConfig
from layerskip_tpu_torch.generation.core import _bucket
from layerskip_tpu_torch.generation.generator import LlamaGenerator
from layerskip_tpu_torch.models import llama
from layerskip_tpu_torch.models.llama import LlamaParams
from layerskip_tpu_torch.ops.kv_cache import init_kv_cache
from layerskip_tpu_torch.parallel.collectives import sharded
from layerskip_tpu_torch.parallel.distributed import is_coordinator

log = logging.getLogger(__name__)


@dataclasses.dataclass
class EvalArguments:
    """LayerSkip eval.py:32-55 (the subset consumed)."""

    tasks: Optional[str] = None
    num_fewshot: int = 0
    limit: Optional[int] = None
    batch_size: int = 1
    use_cache: Optional[str] = None
    log_samples: bool = False


class TokenScorer:
    """Batched full-forward loglikelihood scoring on the params' device.

    The joint ``context + continuation`` sequence is left-truncated to
    ``max_position_embeddings + 1`` tokens (RoPE positions stay in the
    trained range), its last token dropped, and rows are right-padded to
    their sequence bucket and batched by bucket. Each row runs the full
    forward over a fresh cache of its bucket (prompt blocks of more than 16
    tokens go through the flash-prefill kernel, which is causal, so the
    padding past a row's tokens never reaches them). The continuation's
    log-probability sum and its greedy exact match are reduced on the
    device; only those two values a row reach the host. ``shard`` is the
    engine's sharded context when the params are a rank's slices.
    """

    def __init__(self, params: LlamaParams, cfg: ModelConfig, max_batch: int = 8,
                 shard=None):
        self.params = params
        self.cfg = cfg
        self.device = params.embed.device
        self.max_length = int(cfg.max_position_embeddings)
        self.max_batch = max(int(max_batch), 1)
        self.shard = shard

    def _logits(self, ids: np.ndarray, bucket: int) -> torch.Tensor:
        """fp32 [B, bucket, V] logits of the full forward over ``ids``."""
        ids_t = torch.from_numpy(ids).to(self.device)
        cache = init_kv_cache(self.cfg, batch=ids.shape[0], max_len=bucket,
                              device=self.device)
        return llama.forward(self.params, self.cfg, ids_t, cache, 0).logits

    def _score(self, ids, targets, mask, bucket) -> Tuple[np.ndarray, np.ndarray]:
        with torch.inference_mode(), sharded(self.shard):
            logits = self._logits(ids, bucket)
            tgt = torch.from_numpy(targets).to(self.device)
            msk = torch.from_numpy(mask).to(self.device)
            lse = torch.logsumexp(logits, dim=-1)
            tl = logits.gather(-1, tgt[..., None])[..., 0]
            ll = torch.where(msk, tl - lse, 0.0).sum(dim=-1)
            greedy = torch.where(msk, logits.argmax(dim=-1) == tgt, True).all(dim=-1)
            return ll.cpu().numpy(), greedy.cpu().numpy()

    def logprobs(self, token_ids: List[int]) -> np.ndarray:
        """[T, V] fp32 log-probs of one sequence (position t predicts t+1),
        left-truncated to ``max_position_embeddings``. An inspection helper:
        the scoring paths never bring the logits to the host."""
        token_ids = list(token_ids)[-self.max_length:]
        t = len(token_ids)
        bucket = min(_bucket(t), self.max_length)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :t] = token_ids
        with torch.inference_mode(), sharded(self.shard):
            lp = torch.log_softmax(self._logits(ids, bucket), dim=-1)
            return lp[0, :t].cpu().numpy()

    def _prepare_row(self, context: List[int], continuation: List[int]):
        """(input ids, per-position targets, continuation mask, bucket):
        ``inp = (ctx + cont)[-(max_length + 1):][:-1]`` (LayerSkip eval.py
        :241-254); the continuation's logits sit at ``inp[inplen - contlen:]``."""
        if not context:
            raise ValueError("empty context")
        if not continuation:
            raise ValueError("empty continuation")
        if len(continuation) > self.max_length:
            raise ValueError(f"continuation length {len(continuation)} exceeds model "
                             f"max_length {self.max_length}")
        full = list(context) + list(continuation)
        trunc = full[-(self.max_length + 1):]
        inp = trunc[:-1] if len(trunc) > 1 else trunc
        inplen, contlen = len(inp), len(continuation)
        targets = np.zeros(inplen, np.int64)
        mask = np.zeros(inplen, bool)
        targets[inplen - contlen:] = continuation  # position i predicts trunc[i + 1]
        mask[inplen - contlen:] = True
        return inp, targets, mask, min(_bucket(inplen), self.max_length)

    def score_batch(self, rows: List[Tuple[List[int], List[int]]]) -> List[Tuple[float, bool]]:
        """(ll, greedy) of each (context, continuation) row, in the rows'
        order. Rows of one sequence bucket share a forward (up to
        ``max_batch`` rows, the batch padded with zero rows to a power of
        two)."""
        by_bucket = {}
        for i, (inp, tgt, msk, bucket) in enumerate(self._prepare_row(c, k) for c, k in rows):
            by_bucket.setdefault(bucket, []).append((i, inp, tgt, msk))
        out: List[Optional[Tuple[float, bool]]] = [None] * len(rows)
        for bucket, group in by_bucket.items():
            for s in range(0, len(group), self.max_batch):
                chunk = group[s:s + self.max_batch]
                b = 1 << (len(chunk) - 1).bit_length()
                ids = np.zeros((b, bucket), np.int64)
                tgts = np.zeros((b, bucket), np.int64)
                msks = np.zeros((b, bucket), bool)
                for r, (_, inp, tgt, msk) in enumerate(chunk):
                    ids[r, :len(inp)] = inp
                    tgts[r, :len(tgt)] = tgt
                    msks[r, :len(msk)] = msk
                ll, greedy = self._score(ids, tgts, msks, bucket)
                for r, (i, *_rest) in enumerate(chunk):
                    out[i] = (float(ll[r]), bool(greedy[r]))
        return out  # type: ignore[return-value]

    def loglikelihood_tokens(self, context: List[int],
                             continuation: List[int]) -> Tuple[float, bool]:
        """(continuation log-probability sum, greedy exact match): the
        contract of lm-eval's ``_loglikelihood_tokens`` rows."""
        return self.score_batch([(context, continuation)])[0]


def rolling_token_windows(tokens: List[int], prefix_token: int,
                          max_len: int) -> List[Tuple[List[int], List[int]]]:
    """lm-eval's ``get_rolling_token_windows(context_len=1)`` composed with
    ``make_disjoint_window``: disjoint (context, continuation) pairs in which
    every token of ``tokens`` is a continuation token of exactly one window,
    each model input is at most ``max_len`` tokens, and the first window's
    context is the EOT ``prefix_token``."""
    if not tokens:
        return []
    first = min(max_len, len(tokens))
    windows = [([prefix_token], tokens[:first])]
    done = first
    while done < len(tokens):
        n_pred = min(len(tokens) - done, max_len)
        end = done + n_pred
        # the model input is tokens[end - max_len - 1 : end - 1]; the
        # disjoint context is its part before the continuation
        windows.append((tokens[end - max_len - 1:end - n_pred], tokens[end - n_pred:end]))
        done = end
    return windows


class EvalHarnessLM:
    """lm-eval ``TemplateLM``-compatible wrapper over (generator, scorer);
    it inherits ``TemplateLM`` when ``lm_eval`` is importable, so the module
    imports without it."""

    def __new__(cls, *a, **kw):
        try:
            from lm_eval.api.model import TemplateLM

            cls = type("EvalHarnessLM", (cls, TemplateLM), {})
        except ImportError:
            pass
        return object.__new__(cls)

    def __init__(self, generator: LlamaGenerator, generation_config: GenerationConfig,
                 batch_size: int = 8):
        self.generator = generator
        self.generation_config = generation_config
        self.scorer = TokenScorer(generator.engine.params, generator.cfg,
                                  max_batch=batch_size, shard=generator.engine.shard)
        self.tokenizer = generator.tokenizer

    # --- TemplateLM API ---

    @property
    def eot_token_id(self):
        return self.generator.eos_ids[0]

    def tok_encode(self, string: str, **kw) -> List[int]:
        return self.generator._encode(string)

    def generate_until(self, requests, disable_tqdm: bool = False) -> List[str]:
        """Generate, then cut the text at the first of each stop string
        (LayerSkip eval.py:92-115)."""
        out = []
        for req in requests:
            prompt, gen_args = req.args
            text = self.generator.generate(prompt, self.generation_config).decoded_prediction
            for stop in gen_args.get("until", []):
                if stop and stop in text:
                    text = text.split(stop)[0]
            out.append(text)
        return out

    def _loglikelihood_tokens(self, requests, disable_tqdm: bool = False):
        """Rows sorted by descending joint length (LayerSkip's ``_collate``),
        scored in right-padded batches, then put back in request order."""
        rows = []
        for req in requests:
            _key, context_enc, continuation_enc = req.args if hasattr(req, "args") else req
            rows.append((list(context_enc), list(continuation_enc)))
        order = sorted(range(len(rows)), key=lambda i: -(len(rows[i][0]) + len(rows[i][1])))
        scored = self.scorer.score_batch([rows[i] for i in order])
        res: List[Optional[Tuple[float, bool]]] = [None] * len(rows)
        for rank, i in enumerate(order):
            res[i] = scored[rank]
        return res

    def loglikelihood_rolling(self, requests, disable_tqdm: bool = False):
        """Whole-text loglikelihood over lm-eval's rolling windows: the first
        window EOT-prefixed, every token scored once."""
        out = []
        max_len = self.generator.cfg.max_position_embeddings
        for req in requests:
            (string,) = req.args if hasattr(req, "args") else (req,)
            windows = rolling_token_windows(self.tok_encode(string), self.eot_token_id,
                                            max_len)
            out.append(sum(ll for ll, _ in self.scorer.score_batch(windows)))
        return out


class _Instance:
    """Shape-compatible stand-in for ``lm_eval.api.instance.Instance``."""

    def __init__(self, args):
        self.args = args


def run_local_mc(wrap: EvalHarnessLM, task_path: str, limit: Optional[int] = None,
                 num_fewshot: int = 0) -> dict:
    """Offline multiple-choice evaluation through the adapter, in the calling
    convention lm-eval's evaluator uses for MC tasks: one loglikelihood
    request per (context, choice) with ``Instance.args = (key, context_enc,
    continuation_enc)``, scored by ``_loglikelihood_tokens``; ``acc`` is the
    argmax ll's hit rate and ``acc_norm`` that of the ll per byte of the
    choice. The task file holds JSONL rows ``{"query": str, "choices":
    [str, ...], "gold": int}``; with ``num_fewshot`` its first docs become
    the shots."""
    docs = []
    with open(task_path) as f:
        for line in f:
            line = line.strip()
            if line:
                docs.append(json.loads(line))
    if limit:
        docs = docs[:limit]
    if not docs:
        raise ValueError(f"no docs in {task_path}")

    fewshot = ""
    if num_fewshot > 0:
        shots, docs = docs[:num_fewshot], docs[num_fewshot:]
        fewshot = "\n\n".join(d["query"] + d["choices"][d["gold"]] for d in shots) + "\n\n"

    requests, spans = [], []
    for d in docs:
        ctx = fewshot + d["query"]
        ctx_enc = wrap.tok_encode(ctx)
        start = len(requests)
        for choice in d["choices"]:
            # the continuation is the joint encoding past the context's
            # (lm-eval's split); a merged boundary falls back to the choice
            cont_enc = wrap.tok_encode(ctx + choice)[len(ctx_enc):]
            if not cont_enc:
                cont_enc = wrap.tok_encode(choice)
            requests.append(_Instance(((ctx, choice), ctx_enc, cont_enc)))
        spans.append((start, len(requests), d))

    scored = wrap._loglikelihood_tokens(requests)
    acc = acc_norm = 0
    for start, end, d in spans:
        lls = [scored[i][0] for i in range(start, end)]
        norm = [ll / max(len(c.encode("utf-8")), 1) for ll, c in zip(lls, d["choices"])]
        acc += int(int(np.argmax(lls)) == d["gold"])
        acc_norm += int(int(np.argmax(norm)) == d["gold"])
    n = len(spans)
    return {"acc": acc / n, "acc_norm": acc_norm / n, "num_docs": n,
            "num_requests": len(requests)}


def main(args: Arguments, eval_args: EvalArguments, gen_cfg: GenerationConfig):
    tasks = [t for t in (eval_args.tasks or "").split(",") if t]
    local = [t for t in tasks if t.startswith("local:")]
    params, cfg, tokenizer = load_from_args(args)
    generator = LlamaGenerator(tokenizer, params, cfg, device=args.device,
                               mesh=mesh_from_args(args))
    coordinator_only()
    wrap = EvalHarnessLM(generator, gen_cfg, batch_size=eval_args.batch_size)

    if local:
        # "local:/path/to/task.jsonl": offline MC eval (run_local_mc)
        results = {"results": {}}
        for t in local:
            results["results"][os.path.basename(t[6:])] = run_local_mc(
                wrap, t[6:], limit=eval_args.limit, num_fewshot=eval_args.num_fewshot)
    else:
        try:
            import lm_eval
        except ImportError as e:
            raise SystemExit(
                "lm_eval is not installed in this container. Use "
                "--tasks local:<task.jsonl> for the offline MC path; the "
                "adapter itself is tested in tests/test_apps.py "
                "(lm-eval scoring core section)."
            ) from e
        results = lm_eval.simple_evaluate(
            wrap, tasks=tasks, num_fewshot=eval_args.num_fewshot, limit=eval_args.limit,
            log_samples=eval_args.log_samples)
    if not is_coordinator():
        return results
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"eval_{int(time.time())}.json")
    with open(out_path, "w") as f:
        json.dump(results.get("results", results), f, indent=2, default=str)
    print(json.dumps(results.get("results", {}), indent=2, default=str))
    return results


if __name__ == "__main__":
    main(*parse_dataclasses((Arguments, EvalArguments, GenerationConfig)))
