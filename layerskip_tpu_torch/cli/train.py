"""LayerSkip training/finetuning command line (port of ``layerskip_tpu/cli/train.py``).

Makes the recipe in ``training/recipe.py`` (layer dropout and the
rotational early-exit loss, the procedure that produces LayerSkip
checkpoints) runnable end to end:

  * token batches from the offline data layer the benchmarks use
    (``data.get_data``, e.g. ``--dataset custom_jsonl --data_path ...``),
  * checkpoints of the params, the optimizer state and the step under
    ``--checkpoint_dir`` every ``--save_every`` steps (``<dir>/<step>/``,
    the newest 3 kept), and resume from the newest one (``--resume``),
  * an HF-compatible safetensors export at the end
    (``models/params.save_params``), so a trained model feeds straight
    into the inference engines.

As in the JAX package, a resumed run restarts the layer-dropout draws and
the batch stream from ``--seed``.

With ``--dp``, ``--fsdp`` or ``--tp`` above 1 the run is ``dp * fsdp *
tp`` ranks of the port's launcher (or torchrun) on the [dp, fsdp, tp]
training mesh (``parallel/mesh.make_train_mesh``): every rank builds the
whole model, cuts its shards (fsdp: its ``L/fsdp`` layers; tp: its
Megatron slices) and frees the rest, builds the same batches and takes
its part (rows over dp, the sequence over fsdp, ``act_spec=("dp",
"fsdp", None)``). Checkpoints and the export hold the whole weights
(gathered), so a run resumes under any mesh; rank 0 prints and writes.

Usage:
  python -m layerskip_tpu_torch.cli.train --model random:tiny --device cpu \\
      --dataset custom_jsonl --data_path data.jsonl --steps 100 --checkpoint_dir ckpts/
  python -m layerskip_tpu_torch.parallel.launch --nproc 2 --backend gloo -- \\
      -m layerskip_tpu_torch.cli.train --model random:tiny --device cpu --fsdp 2 ...
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from typing import List, Optional

import numpy as np
import torch

from layerskip_tpu_torch.cli.args import Arguments, parse_dataclasses
from layerskip_tpu_torch.cli.loading import coordinator_only, load_from_args
from layerskip_tpu_torch.data import get_data
from layerskip_tpu_torch.device import resolve_device
from layerskip_tpu_torch.models.llama import LlamaParams
from layerskip_tpu_torch.models.params import save_params
from layerskip_tpu_torch.parallel.collectives import ShardContext
from layerskip_tpu_torch.parallel.distributed import (
    BACKEND_ENV,
    is_coordinator,
    setup,
    world_size_from_env,
)
from layerskip_tpu_torch.parallel.mesh import make_train_mesh
from layerskip_tpu_torch.parallel.sharding import (
    check_divisible,
    gather_params,
    gather_tensor,
    named_specs,
    param_specs_from,
    shard_params,
    shard_tensor,
)
from layerskip_tpu_torch.training.recipe import (
    ACT_SPEC,
    TrainConfig,
    make_train_step,
    trainable_tensors,
)

log = logging.getLogger(__name__)

KEEP_CHECKPOINTS = 3  # the JAX package's orbax CheckpointManager(max_to_keep=3)
_STATE = "state.pt"


@dataclasses.dataclass
class TrainArguments:
    dataset: str = "custom_jsonl"
    data_path: Optional[str] = None
    steps: int = 100
    batch_size: int = 4
    seq_len: int = 256
    # LayerSkip recipe
    p_max: float = 0.1
    dropout_scale: str = "exp"
    early_exit_layers: Optional[str] = None  # comma ints; default: sparse
    # quarter-depth exits (training.recipe.default_exit_layers)
    ce_chunk_tokens: int = 1024  # token-chunked CE; 0 => dense [B,T,V]
    e_scale: float = 1.0
    rotational_r: int = 0
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    # infra
    checkpoint_dir: Optional[str] = None
    save_every: int = 50
    resume: bool = True
    export_dir: Optional[str] = None  # HF safetensors export at the end
    fsdp: int = 1  # fully sharded data-parallel mesh axis (layers and sequence);
    # dp/tp come from the shared Arguments flags
    log_every: int = 10


def build_batches(examples, tokenizer, batch_size, seq_len, steps, pad_id=0):
    """Pack (input+output) token streams into [B, T] id/label batches."""
    token_stream: List[int] = []
    for ex in examples:
        text = ex.input + ex.output
        ids = tokenizer.encode(text) if hasattr(tokenizer, "encode") else (
            tokenizer(text)["input_ids"]
        )
        token_stream.extend(int(t) for t in ids)
    if not token_stream:
        raise ValueError("no training tokens")
    need = steps * batch_size * (seq_len + 1)
    reps = need // len(token_stream) + 1
    token_stream = (token_stream * reps)[:need]
    arr = np.asarray(token_stream, np.int32).reshape(
        steps, batch_size, seq_len + 1
    )
    for i in range(steps):
        yield arr[i, :, :-1], arr[i, :, 1:]


def checkpoint_steps(root: str) -> List[int]:
    """The steps saved under ``root``, oldest first."""
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root)
                  if d.isdigit() and os.path.exists(os.path.join(root, d, _STATE)))


def _specs(params: LlamaParams, ctx: Optional[ShardContext]) -> Optional[dict]:
    """name -> sharding spec of each trainable weight on ``ctx``'s mesh."""
    if ctx is None:
        return None
    return named_specs(param_specs_from(params, fsdp=ctx.fsdp is not None))


def _map_opt_state(state: dict, names: List[str], fn) -> dict:
    """A copy of an AdamW ``state_dict`` with ``fn(name, tensor)`` applied
    to each weight's moments (the state's keys are the weights' indices in
    ``trainable_tensors`` order)."""
    out = {"param_groups": state["param_groups"], "state": {}}
    for idx, st in state["state"].items():
        out["state"][idx] = {k: (fn(names[idx], v) if k in ("exp_avg", "exp_avg_sq") else v)
                             for k, v in st.items()}
    return out


def save_checkpoint(root: str, step: int, params: LlamaParams,
                    opt_state: torch.optim.Optimizer,
                    ctx: Optional[ShardContext] = None) -> None:
    """Write ``<root>/<step>/state.pt`` (params, optimizer state, step),
    written under a temporary name and then renamed, and delete all but
    the newest ``KEEP_CHECKPOINTS`` steps. Under a mesh (``ctx``) every
    rank gathers the whole weights and moments (a collective) and rank 0
    writes them: the file is the same under any mesh."""
    named = trainable_tensors(params)
    specs = _specs(params, ctx)
    full = {k: gather_tensor(w.detach(), specs[k], ctx) if ctx else w.detach()
            for k, w in named.items()}
    opt = opt_state.state_dict()
    if ctx is not None:
        opt = _map_opt_state(opt, list(named), lambda n, t: gather_tensor(t, specs[n], ctx))
    if not is_coordinator():
        return
    d = os.path.join(root, str(step))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, _STATE + ".tmp")
    torch.save({"step": step, "opt_state": opt, "params": full}, tmp)
    os.replace(tmp, os.path.join(d, _STATE))
    for old in checkpoint_steps(root)[:-KEEP_CHECKPOINTS]:
        shutil.rmtree(os.path.join(root, str(old)))


def restore_checkpoint(root: str, step: int, params: LlamaParams,
                       opt_state: torch.optim.Optimizer,
                       ctx: Optional[ShardContext] = None) -> None:
    """Load ``<root>/<step>`` into ``params`` (in place) and ``opt_state``;
    under a mesh (``ctx``) they are this rank's shards, cut from the whole
    tensors of the file."""
    dev = params.embed.device
    state = torch.load(os.path.join(root, str(step), _STATE),
                       map_location="cpu" if ctx else dev, weights_only=True)
    named = trainable_tensors(params)
    specs = _specs(params, ctx)

    def local(name, t):
        return shard_tensor(t, specs[name], ctx, name).to(dev) if ctx else t

    with torch.no_grad():
        for name, w in named.items():
            w.copy_(local(name, state["params"][name]))
    opt_state.load_state_dict(_map_opt_state(state["opt_state"], list(named), local)
                              if ctx else state["opt_state"])


def _train_mesh(args: Arguments, targs: "TrainArguments"):
    """The [dp, fsdp, tp] mesh of a run of several ranks (after joining the
    process group; the backend is ``LAYERSKIP_TORCH_BACKEND``, else NCCL
    on CUDA and gloo on the CPU), or None for one rank at dp = fsdp = tp =
    1. Raises when dp * fsdp * tp is not the number of ranks."""
    if args.dp * targs.fsdp * args.tp <= 1 and world_size_from_env() <= 1:
        return None
    dev = resolve_device(args.device)
    setup(os.environ.get(BACKEND_ENV) or ("nccl" if dev.type == "cuda" else "gloo"),
          seed=args.seed)
    return make_train_mesh(args.dp, targs.fsdp, args.tp, device_type=dev.type)


def main(args: Arguments, targs: TrainArguments):
    """Train as the command line asks: (this rank's params, the logged
    (step, loss) history)."""
    params, _, history = run(args, targs)
    return params, history


def run(args: Arguments, targs: TrainArguments):
    """``main``'s run: (this rank's params, its AdamW optimizer, the logged
    (step, loss) history)."""
    mesh = _train_mesh(args, targs)
    if mesh is not None:
        coordinator_only()
    # the whole model on every rank, cut to its shards below (the
    # inference loader's (dp, tp) mesh is not the training mesh)
    params, cfg, tokenizer = load_from_args(dataclasses.replace(args, dp=1, tp=1))
    dev = params.embed.device
    ctx = None
    if mesh is not None:
        params, ctx = shard_params(params, mesh, cfg)
        check_divisible(cfg, ctx, batch=targs.batch_size, seq=targs.seq_len)
        if dev.type == "cuda":
            torch.cuda.empty_cache()  # the whole weights' blocks back to the card

    exits = ()
    if targs.early_exit_layers:
        exits = tuple(int(x) for x in str(targs.early_exit_layers).split(","))
    tcfg = TrainConfig(
        p_max=targs.p_max, dropout_scale=targs.dropout_scale,
        early_exit_layers=exits, e_scale=targs.e_scale,
        rotational_r=targs.rotational_r, learning_rate=targs.learning_rate,
        weight_decay=targs.weight_decay,
        ce_chunk_tokens=targs.ce_chunk_tokens,
        act_spec=ACT_SPEC if args.dp * targs.fsdp * args.tp > 1 else None,
    )
    train_step, init_opt = make_train_step(cfg, tcfg, mesh)
    opt_state = init_opt(params)
    start_step = 0

    root = os.path.abspath(targs.checkpoint_dir) if targs.checkpoint_dir else None
    if root and targs.resume and checkpoint_steps(root):
        start_step = checkpoint_steps(root)[-1]
        restore_checkpoint(root, start_step, params, opt_state, ctx)
        log.info("resumed from step %d", start_step)
        print(f"resumed from checkpoint step {start_step}")

    examples = get_data(
        random_shuffle=True, num_samples=0, dataset=targs.dataset,
        data_path=targs.data_path, seed=args.seed,
    )
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    dp, fsdp = (None, None) if ctx is None else (ctx.dp, ctx.fsdp)

    def part(x: np.ndarray) -> torch.Tensor:
        """This rank's rows (dp) and positions (fsdp) of a [B, T] batch."""
        b, t = x.shape
        if dp is not None:
            x = x[dp.rank * b // dp.size:(dp.rank + 1) * b // dp.size]
        if fsdp is not None:
            x = x[:, fsdp.rank * t // fsdp.size:(fsdp.rank + 1) * t // fsdp.size]
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, torch.long)

    t0 = time.time()
    batches = build_batches(
        examples, tokenizer, targs.batch_size, targs.seq_len,
        targs.steps - start_step,
    )
    history = []
    for step, (ids, labels) in enumerate(batches, start=start_step):
        params, opt_state, aux = train_step(params, opt_state, part(ids), part(labels),
                                            generator, step)
        if (step + 1) % targs.log_every == 0 or step == start_step:
            loss = float(aux["loss"])  # sync
            dt = time.time() - t0
            tokens = targs.batch_size * targs.seq_len * (step + 1 - start_step)
            history.append((step + 1, loss))
            print(f"step {step + 1}/{targs.steps} loss={loss:.4f} "
                  f"({tokens / max(dt, 1e-9):.0f} tok/s)")
        if root and (step + 1) % targs.save_every == 0:
            save_checkpoint(root, step + 1, params, opt_state, ctx)
    if targs.export_dir:
        whole = gather_params(params, ctx)
        if is_coordinator():
            path = save_params(whole, targs.export_dir, cfg)
            print(f"exported HF-compatible checkpoint to {path}")
        del whole
    return params, opt_state, history


if __name__ == "__main__":
    a, t = parse_dataclasses((Arguments, TrainArguments))
    main(a, t)
