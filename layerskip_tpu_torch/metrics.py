"""Text-quality and generation-stat metrics in pure Python (port of
``layerskip_tpu/metrics.py``, the same schema and arithmetic):

  * ROUGE-1/2/3/L F-measure, lowercased, averaged per sample;
  * BLEU-4 accumulated over the corpus;
  * character edit distance, mean per sample (under the key "exact_match",
    the name LayerSkip's output schema gives it);
  * means of acceptance_rate / total_time / time_per_token /
    tokens_per_second, a missing acceptance (AR runs) counted as 0.

The JAX package can hand Levenshtein and LCS to an optional host C++
library; the port keeps the Python loops, which give the same integers.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List


def _tokenize(text: str) -> List[str]:
    """torchmetrics-style ROUGE tokenization: lowercase, alnum word chars."""
    return re.findall(r"[a-z0-9]+", text.lower())


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _fmeasure(match: int, pred: int, tgt: int) -> float:
    if pred == 0 or tgt == 0 or match == 0:
        return 0.0
    p, r = match / pred, match / tgt
    return 2 * p * r / (p + r)


def rouge_n(pred: str, target: str, n: int) -> float:
    pt, tt = _tokenize(pred), _tokenize(target)
    pc, tc = _ngrams(pt, n), _ngrams(tt, n)
    match = sum((pc & tc).values())
    return _fmeasure(match, max(len(pt) - n + 1, 0), max(len(tt) - n + 1, 0))


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(pred: str, target: str) -> float:
    pt, tt = _tokenize(pred), _tokenize(target)
    return _fmeasure(_lcs_len(pt, tt), len(pt), len(tt))


def edit_distance(a: str, b: str) -> int:
    """Character-level Levenshtein distance."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class Mean:
    def __init__(self):
        self.total, self.count = 0.0, 0

    def update(self, x: float):
        self.total += float(x)
        self.count += 1

    def compute(self) -> float:
        return self.total / self.count if self.count else 0.0


class RougeMetric:
    """Per-sample-averaged ROUGE F (torchmetrics ROUGEScore + wrapper,
    utils.py:15-42)."""

    def __init__(self, key: str):
        self.key = key  # "rouge1" | "rouge2" | "rouge3" | "rougeL"
        self.mean = Mean()

    def update(self, target: str, pred: str):
        if self.key == "rougeL":
            self.mean.update(rouge_l(pred, target))
        else:
            self.mean.update(rouge_n(pred, target, int(self.key[-1])))

    def compute(self) -> float:
        return self.mean.compute()


class BleuMetric:
    """Corpus-level BLEU-n with brevity penalty (torchmetrics BLEUScore)."""

    def __init__(self, n_gram: int = 4):
        self.n = n_gram
        self.matches = [0] * n_gram
        self.totals = [0] * n_gram
        self.pred_len = 0
        self.tgt_len = 0

    def update(self, target: str, pred: str):
        # torchmetrics BLEUScore default tokenizer: whitespace split
        pt, tt = pred.split(), target.split()
        self.pred_len += len(pt)
        self.tgt_len += len(tt)
        for k in range(1, self.n + 1):
            pc, tc = _ngrams(pt, k), _ngrams(tt, k)
            self.matches[k - 1] += sum((pc & tc).values())
            self.totals[k - 1] += max(len(pt) - k + 1, 0)

    def compute(self) -> float:
        if min(self.totals) == 0 or min(self.matches) == 0:
            return 0.0
        log_p = sum(
            math.log(m / t) for m, t in zip(self.matches, self.totals)
        ) / self.n
        bp = (
            1.0
            if self.pred_len >= self.tgt_len
            else math.exp(1 - self.tgt_len / max(self.pred_len, 1))
        )
        return bp * math.exp(log_p)


class EditDistanceMetric:
    def __init__(self):
        self.mean = Mean()

    def update(self, target: str, pred: str):
        self.mean.update(edit_distance(pred, target))

    def compute(self) -> float:
        return self.mean.compute()


class EvaluationMetrics:
    """LayerSkip benchmark.py:58-153 (same nested output schema)."""

    def __init__(self):
        self.predicted_text = {
            "rouge-l": RougeMetric("rougeL"),
            "rouge-1": RougeMetric("rouge1"),
            "rouge-2": RougeMetric("rouge2"),
            "rouge-3": RougeMetric("rouge3"),
            "bleu_score": BleuMetric(4),
            "exact_match": EditDistanceMetric(),  # LayerSkip's (mis)label
        }
        self.acceptance_rate = {"mean": Mean()}
        self.total_time = {"mean": Mean()}
        self.time_per_token = {"mean": Mean()}
        self.tokens_per_second = {"mean": Mean()}

    @classmethod
    def build_metrics(cls) -> "EvaluationMetrics":
        return cls()

    def update(self, evaluation_example, generation_result) -> None:
        if evaluation_example is not None:
            for m in self.predicted_text.values():
                m.update(
                    evaluation_example.output, generation_result.decoded_prediction
                )
        acc = generation_result.generation_strategy_result.acceptance_rate
        self.acceptance_rate["mean"].update(0.0 if acc is None else acc)
        self.total_time["mean"].update(generation_result.total_time)
        self.time_per_token["mean"].update(generation_result.time_per_token)
        self.tokens_per_second["mean"].update(generation_result.tokens_per_second)

    def compute(self) -> Dict[str, Dict[str, float]]:
        return {
            "predicted_text": {
                k: m.compute() for k, m in self.predicted_text.items()
            },
            "acceptance_rate": {
                k: m.compute() for k, m in self.acceptance_rate.items()
            },
            "total_time": {k: m.compute() for k, m in self.total_time.items()},
            "time_per_token": {
                k: m.compute() for k, m in self.time_per_token.items()
            },
            "tokens_per_second": {
                k: m.compute() for k, m in self.tokens_per_second.items()
            },
        }
