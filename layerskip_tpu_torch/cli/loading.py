"""Model and tokenizer loading for the CLI apps (port of
``layerskip_tpu/cli/loading.py``).

``model`` is a local HF checkpoint directory (``config.json`` and
``*.safetensors`` shards, read by the port's own reader) or
``random:<preset>``: random weights of a preset shape with a byte-level
tokenizer, for runs without a checkpoint. A checkpoint directory without
usable tokenizer files (or a machine without ``transformers``) falls back to
that tokenizer too.

With ``dp`` or ``tp`` above 1 the app runs as ``dp * tp`` ranks (torchrun,
or the port's launcher ``python -m layerskip_tpu_torch.parallel.launch``):
``mesh_for`` joins the process group and makes the (dp, tp) mesh, and each
rank keeps its shard of the weights (parallel/sharding.py) and frees the
rest. The backend is ``LAYERSKIP_TORCH_BACKEND`` when set (the launcher
sets it from its ``--backend``), else NCCL on CUDA and gloo on the CPU; it
is printed when the group starts.
"""

from __future__ import annotations

import os
import sys
from typing import Tuple

import torch

from layerskip_tpu_torch.config import PRESETS, ModelConfig, tiny_config
from layerskip_tpu_torch.device import resolve_device
from layerskip_tpu_torch.models.llama import LlamaParams
from layerskip_tpu_torch.models.params import init_params, load_params
from layerskip_tpu_torch.parallel.distributed import (
    BACKEND_ENV,
    setup,
    world_size_from_env,
)
from layerskip_tpu_torch.parallel.mesh import make_mesh
from layerskip_tpu_torch.parallel.sharding import (
    check_divisible,
    context_from_mesh,
    shard_params,
)


class SimpleTokenizer:
    """Whitespace/byte fallback tokenizer for random-weights smoke runs."""

    eos_token_id = 0

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str):
        return [1 + (b % (self.vocab_size - 2)) for b in text.encode()[:512]]

    def __call__(self, text: str):
        return {"input_ids": self.encode(text)}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in ids)


def _preset_config(name: str) -> ModelConfig:
    """The shapes of the JAX package's ``random:`` presets, in bf16."""
    bf16 = torch.bfloat16
    gemma = dict(hidden_act="gelu_pytorch_tanh", rms_norm_offset=True,
                 scale_embeddings=True, tie_word_embeddings=True, post_norms=True)
    if name == "tiny":
        return tiny_config(dtype=bf16)
    if name in PRESETS:  # 1b, 7b, and the Gemma-2-2B and moe-3b shapes
        return PRESETS[name]()
    if name == "qwen3":  # tiny Qwen3: per-head q/k norms before RoPE
        return tiny_config(dtype=bf16, qk_norm=True, tie_word_embeddings=True)
    if name == "gemma2":  # tiny Gemma-2: alternating windows and softcaps
        return tiny_config(dtype=bf16, attn_logit_softcap=50.0, final_logit_softcap=30.0,
                           query_pre_attn_scalar=32.0, sliding_window=8,
                           sliding_window_pattern=2, **gemma)
    if name == "gemma3":  # tiny Gemma-3: 5 of 6 layers slide, local RoPE base
        return tiny_config(dtype=bf16, num_hidden_layers=6, qk_norm=True,
                           query_pre_attn_scalar=32.0, sliding_window=8,
                           sliding_window_pattern=6, rope_theta=100000.0,
                           rope_local_theta=10000.0, **gemma)
    if name == "qwen3moe":  # tiny Qwen3-MoE: q/k norms and top-k experts
        return tiny_config(dtype=bf16, qk_norm=True, tie_word_embeddings=True,
                           num_local_experts=4, num_experts_per_tok=2,
                           norm_topk_prob=False)
    if name == "moe":  # tiny Mixtral-style MoE
        return tiny_config(dtype=bf16, num_local_experts=4, num_experts_per_tok=2)
    raise ValueError(f"unknown random preset: {name}")


def mesh_for(dp: int, tp: int, device="cuda", seed: int = 42):
    """The (dp, tp) mesh of this run, after joining the process group
    (``parallel.distributed.setup``) when the run has several ranks; None
    for one rank at dp = tp = 1. Raises when dp * tp is not the number of
    ranks."""
    dev = torch.device(device)
    if dp * tp <= 1 and world_size_from_env() <= 1:
        return None
    backend = os.environ.get(BACKEND_ENV) or ("nccl" if dev.type == "cuda" else "gloo")
    setup(backend, seed=seed)
    return make_mesh(dp=dp, tp=tp, device_type=dev.type)


def maybe_shard(params: LlamaParams, dp: int = 1, tp: int = 1,
                cfg: ModelConfig = None) -> LlamaParams:
    """This rank's shard of ``params`` over the (dp, tp) mesh when more than
    one device is asked (``shard_params``: contiguous copies of the split
    weights); ``params`` as they are otherwise."""
    if dp * tp <= 1:
        return params
    mesh = mesh_for(dp, tp, params.embed.device)
    return shard_params(params, mesh, cfg)[0]


def coordinator_only() -> None:
    """On every rank but rank 0, send standard output and error to the null
    device: only the coordinator prints. An uncaught exception's traceback
    still reaches the process's standard error."""
    import traceback

    from layerskip_tpu_torch.parallel.distributed import is_coordinator

    if not is_coordinator():
        sys.stdout = sys.stderr = open(os.devnull, "w")  # noqa: SIM115
        sys.excepthook = lambda *exc: traceback.print_exception(*exc, file=sys.__stderr__)


def mesh_from_args(args):
    """``mesh_for`` of a CLI app's ``Arguments``."""
    return mesh_for(args.dp, args.tp, args.device, args.seed)


def _maybe_quantize(params: LlamaParams, quantize: str) -> LlamaParams:
    """Weight-only quantization at load (``none`` | ``int8`` | ``int4``)."""
    if quantize in ("", "none", None):
        return params
    bits = {"int8": 8, "int4": 4}.get(quantize)
    if bits is None:
        raise ValueError(f"quantize must be none, int8 or int4, not {quantize!r}")
    from layerskip_tpu_torch.quant import quantize_llama_params

    return quantize_llama_params(params, bits=bits)


def _release(dev: torch.device, dp: int, tp: int) -> None:
    """After sharding, return the freed whole weights' blocks to the card."""
    if dp * tp > 1 and dev.type == "cuda":
        torch.cuda.empty_cache()


def _scale_tail(params: LlamaParams, tail_eps: float, tail_from: int) -> LlamaParams:
    """Scale wo/w_down of layers >= tail_from by tail_eps, in place on the
    weights' device (no second copy of the stack). 0 makes those layers
    identities, so early exits agree with the full model."""
    for w in (params.layers.wo, params.layers.w_down):
        w[tail_from:].mul_(torch.tensor(tail_eps, dtype=w.dtype, device=w.device))
    return params


def load_model_and_tokenizer(
    model: str, dtype=torch.bfloat16, seed: int = 0, dp: int = 1, tp: int = 1,
    quantize: str = "none", device="cuda",
) -> Tuple[LlamaParams, ModelConfig, object]:
    """(params on ``device``, config, tokenizer) for ``model``.

    ``model`` is a local HF checkpoint directory (its weights cast to
    ``dtype``) or ``random:<preset>`` (tiny, 1b, 7b, qwen3, gemma2,
    gemma2-2b, gemma3, moe, qwen3moe or moe-3b, always bf16) with an
    optional query ``?tail_eps=E&tail_from=F``: the output projections
    (wo, w_down, every expert's w_down) of layers >= F (default L/4) are
    scaled by E, the acceptance dial of the bench (0 makes them
    identities). The dial is inert above 0 for the post-norm families
    (Gemma-2/3): their post-sublayer norms normalize a uniformly scaled
    output back to the same direction, so acceptance stays where it is;
    0 still makes the tail an identity (a zero output stays zero through
    the norm). ``random:``
    weights come from torch's generator seeded with ``seed``, so they differ
    from the JAX package's for the same seed (threefry); to compare the two
    packages on the same weights, go through a checkpoint (``save_params``)
    or ``params_from_numpy``. ``quantize`` applies weight-only int8/int4.
    ``dp``/``tp`` > 1 return this rank's shard over the (dp, tp) mesh
    (``mesh_for``; every rank builds or reads the whole weights, keeps its
    slices and frees the rest); quantization is refused there, in the JAX
    package's words. Raises without a GPU unless ``device="cpu"``.
    """
    dev = resolve_device(device)
    if dp * tp > 1:  # refuse before any weights are built
        if quantize not in ("", "none", None):
            raise ValueError("--quantize requires dp=tp=1 (dense shard specs)")
        mesh = mesh_for(dp, tp, dev, seed)
    if model.startswith("random:"):
        preset, _, query = model.split(":", 1)[1].partition("?")
        cfg = _preset_config(preset)
        if dp * tp > 1:
            check_divisible(cfg, context_from_mesh(mesh))
        params = init_params(cfg, seed=seed, device=dev)
        kv = dict(p.split("=", 1) for p in query.split("&") if p)
        if "tail_eps" in kv:
            tail_from = int(kv.get("tail_from", max(cfg.num_hidden_layers // 4, 1)))
            params = _scale_tail(params, float(kv["tail_eps"]), tail_from)
        params = maybe_shard(_maybe_quantize(params, quantize), dp, tp, cfg)
        _release(dev, dp, tp)
        return params, cfg, SimpleTokenizer(cfg.vocab_size)

    if not os.path.isdir(model):
        raise FileNotFoundError(
            f"model {model!r} is not a local directory; download checkpoints "
            "beforehand or use random:<preset>")
    cfg = ModelConfig.from_pretrained(model, dtype=dtype)
    if dp * tp > 1:
        check_divisible(cfg, context_from_mesh(mesh))
    params = maybe_shard(_maybe_quantize(load_params(model, cfg, device=dev), quantize),
                         dp, tp, cfg)
    _release(dev, dp, tp)
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model)
    except Exception as exc:  # noqa: BLE001
        # no transformers, or a checkpoint without tokenizer files (e.g. one
        # written by save_params), for which transformers raises OSError,
        # ValueError or AttributeError depending on the config
        print(f"[loading] no usable tokenizer in {model} ({type(exc).__name__}); "
              "falling back to the byte-level smoke tokenizer", file=sys.stderr)
        tokenizer = SimpleTokenizer(cfg.vocab_size)
    return params, cfg, tokenizer


_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def load_from_args(args) -> Tuple[LlamaParams, ModelConfig, object]:
    """``load_model_and_tokenizer`` for a CLI app's ``Arguments``.
    ``--model_args dtype=float32`` (or bfloat16, the default, or float16)
    sets a checkpoint's dtype; ``random:`` presets stay bf16."""
    from layerskip_tpu_torch.cli.args import simple_parse_args_string

    kw = simple_parse_args_string(args.model_args)
    dtype = kw.pop("dtype", "bfloat16")
    if kw or dtype not in _DTYPES:
        raise ValueError(f"model_args takes dtype={'|'.join(_DTYPES)}, not {args.model_args!r}")
    return load_model_and_tokenizer(args.model, dtype=_DTYPES[dtype], seed=args.seed,
                                    dp=args.dp, tp=args.tp, quantize=args.quantize,
                                    device=args.device)
