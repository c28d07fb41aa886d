"""Dataset/task layer: (prompt, target) evaluation examples (port of
``layerskip_tpu/data.py``).

The JAX package's dataset formats, prompt templates, shuffle and head
sampling, so benchmark numbers compare prompt for prompt. HF ``datasets`` is
imported only by the hub-backed formats; ``custom_jsonl`` and
``chat_format`` read local files. Shuffling uses a local
``random.Random(seed)``.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, List, Optional

# LayerSkip data.py:17 — prefix length for language-modeling tasks
PREFIX_LENGTH: int = 100


@dataclasses.dataclass
class EvaluationExample:
    """LayerSkip data.py:20-23."""

    input: str
    output: str


class DatasetFormat:
    """LayerSkip data.py:26-33."""

    CHAT_FORMAT = "chat_format"
    CNN_DM_SUMMARIZATION = "cnn_dm_summarization"
    CNN_DM_LM = "cnn_dm_lm"
    XSUM_SUMMARIZATION = "xsum_summarization"
    HUMAN_EVAL = "human_eval"
    CUSTOM_JSONL = "custom_jsonl"
    TOP_V2 = "top_v2"


def get_valid_dataset_formats() -> List[str]:
    return [
        v for k, v in DatasetFormat.__dict__.items() if not k.startswith("__")
    ]


def apply_template(message: str, template: Optional[str]) -> str:
    """LayerSkip data.py:40-53 — ``template`` has a ``{message}`` slot."""
    if template is None:
        return message
    return template.format(message=message)


def _load_dataset(*args, **kwargs):
    from datasets import load_dataset  # lazy: hub-backed formats only

    return load_dataset(*args, **kwargs)


def _shot_prefix(rows, n_shot: int, key_in: str, key_out: str) -> str:
    """n-shot 'Article: ...\\nSummary: ...' prefix (LayerSkip data.py:104-112)."""
    prompt_shots = ""
    for i in range(n_shot):
        prompt_shots += (
            "Article: " + rows[i][key_in]
            + "\nSummary: " + rows[i][key_out].replace("\n", "") + "\n"
        )
    return prompt_shots + "\n" if n_shot > 0 else ""


def prepare_cnn_dm_summarization(
    n_shot: int = 0, seed: int = 42, template: Optional[str] = None
) -> List[EvaluationExample]:
    """LayerSkip data.py:104-125."""
    shots = ""
    if n_shot > 0:
        rows = (
            _load_dataset("cnn_dailymail", name="3.0.0", split="train")
            .shuffle(seed=seed).select(range(n_shot))
        )
        shots = _shot_prefix(rows, n_shot, "article", "highlights")
    out = []
    for dp in _load_dataset("cnn_dailymail", name="3.0.0", split="test"):
        prompt = apply_template(
            shots + f"Article: {dp['article']}\nSummary:", template
        )
        out.append(EvaluationExample(input=prompt, output=f" {dp['highlights']}"))
    return out


def prepare_xsum_summarization(
    n_shot: int = 0, seed: int = 42, template: Optional[str] = None
) -> List[EvaluationExample]:
    """LayerSkip data.py:127-148."""
    shots = ""
    if n_shot > 0:
        rows = (
            _load_dataset("xsum", split="train").shuffle(seed=seed)
            .select(range(n_shot))
        )
        shots = _shot_prefix(rows, n_shot, "document", "summary")
    out = []
    for dp in _load_dataset("xsum", split="test"):
        prompt = apply_template(
            shots + f"Article: {dp['document']}\nSummary:", template
        )
        out.append(EvaluationExample(input=prompt, output=f" {dp['summary']}"))
    return out


def prepare_cnn_dm_lm(template: Optional[str] = None) -> List[EvaluationExample]:
    """First PREFIX_LENGTH words -> rest (LayerSkip data.py:90-101)."""
    out = []
    for dp in _load_dataset("cnn_dailymail", "3.0.0")["test"]:
        words = dp["article"].split()
        out.append(
            EvaluationExample(
                input=apply_template(" ".join(words[:PREFIX_LENGTH]), template),
                output=" ".join(words[PREFIX_LENGTH:]),
            )
        )
    return out


def prepare_human_eval(template: Optional[str] = None) -> List[EvaluationExample]:
    """LayerSkip data.py:150-160."""
    return [
        EvaluationExample(
            input=apply_template(dp["prompt"], template),
            output=dp["canonical_solution"],
        )
        for dp in _load_dataset("openai_humaneval", split="test")
    ]


def prepare_top_v2(template: Optional[str] = None) -> List[EvaluationExample]:
    """LayerSkip data.py:162-173."""
    return [
        EvaluationExample(
            input=apply_template(dp["utterance"], template),
            output=dp["semantic_parse"],
        )
        for dp in _load_dataset("WillHeld/top_v2", split="test")
    ]


def prepare_chat_format(
    data_path: str, template: Optional[str] = None
) -> List[EvaluationExample]:
    """[role]...[/role] transcript JSONL (LayerSkip data.py:61-87)."""
    turn = "\n[{role}]\n{message}\n[/{role}]"

    def stringify(conv: List[Dict[str, str]]) -> str:
        return "".join(
            turn.format(role=x["role"], message=x["message"]) for x in conv
        )

    out = []
    with open(data_path) as f:
        for line in f:
            row = json.loads(line)
            data = row["data"]
            for i, msg in enumerate(data):
                if msg["role"] == "PARSER":
                    prompt = apply_template(
                        stringify(data[1:i]) + "\n[PARSER]\n", template
                    )
                    out.append(
                        EvaluationExample(input=prompt, output=stringify([msg]))
                    )
    return out


def prepare_custom_jsonl(
    data_path: str,
    prompt_field: str = "prompt",
    response_field: str = "response",
    template: Optional[str] = None,
) -> List[EvaluationExample]:
    """Plain JSONL with configurable fields (LayerSkip data.py:175-185)."""
    out = []
    with open(data_path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            out.append(
                EvaluationExample(
                    input=apply_template(row[prompt_field], template),
                    output=row[response_field],
                )
            )
    return out


def get_data(
    random_shuffle: bool,
    num_samples: int,
    dataset: str,
    data_path: Optional[str] = None,
    n_shot: int = 0,
    seed: int = 42,
    prompt_field: str = "prompt",
    response_field: str = "response",
    template: Optional[str] = None,
) -> List[EvaluationExample]:
    """Dispatcher + shuffle + head-sample (LayerSkip data.py:187-222)."""
    if dataset == DatasetFormat.CHAT_FORMAT:
        examples = prepare_chat_format(data_path, template)
    elif dataset == DatasetFormat.CNN_DM_SUMMARIZATION:
        examples = prepare_cnn_dm_summarization(n_shot=n_shot, seed=seed, template=template)
    elif dataset == DatasetFormat.XSUM_SUMMARIZATION:
        examples = prepare_xsum_summarization(n_shot=n_shot, seed=seed, template=template)
    elif dataset == DatasetFormat.CNN_DM_LM:
        examples = prepare_cnn_dm_lm(template)
    elif dataset == DatasetFormat.HUMAN_EVAL:
        examples = prepare_human_eval(template)
    elif dataset == DatasetFormat.CUSTOM_JSONL:
        examples = prepare_custom_jsonl(
            data_path, prompt_field=prompt_field,
            response_field=response_field, template=template,
        )
    elif dataset == DatasetFormat.TOP_V2:
        examples = prepare_top_v2(template)
    else:
        raise NotImplementedError(f"Unknown dataset format {dataset}")

    if random_shuffle:
        random.Random(seed).shuffle(examples)
    if num_samples:
        examples = examples[:num_samples]
    return examples


def LowercaseProcessingFunction(input: str) -> str:
    """LayerSkip data.py:56-57."""
    return input.lower()
