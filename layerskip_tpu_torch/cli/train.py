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
the batch stream from ``--seed``. The JAX package's (dp, fsdp, tp) mesh is
not ported yet: ``--dp``, ``--tp`` or ``--fsdp`` above 1 raise.

Usage:
  python -m layerskip_tpu_torch.cli.train --model random:tiny --device cpu \\
      --dataset custom_jsonl --data_path data.jsonl --steps 100 --checkpoint_dir ckpts/
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
from layerskip_tpu_torch.cli.loading import load_from_args
from layerskip_tpu_torch.data import get_data
from layerskip_tpu_torch.device import refuse_parallelism
from layerskip_tpu_torch.models.llama import LlamaParams
from layerskip_tpu_torch.models.params import save_params
from layerskip_tpu_torch.training.recipe import TrainConfig, make_train_step, trainable_tensors

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
    fsdp: int = 1  # fully sharded data-parallel mesh axis; > 1 is not ported yet
    # (nor are --dp and --tp for training: the inference mesh is not the
    # training mesh)
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


def save_checkpoint(root: str, step: int, params: LlamaParams,
                    opt_state: torch.optim.Optimizer) -> None:
    """Write ``<root>/<step>/state.pt`` (params, optimizer state, step),
    written under a temporary name and then renamed, and delete all but
    the newest ``KEEP_CHECKPOINTS`` steps."""
    d = os.path.join(root, str(step))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, _STATE + ".tmp")
    torch.save({"step": step, "opt_state": opt_state.state_dict(),
                "params": {k: w.detach() for k, w in trainable_tensors(params).items()}},
               tmp)
    os.replace(tmp, os.path.join(d, _STATE))
    for old in checkpoint_steps(root)[:-KEEP_CHECKPOINTS]:
        shutil.rmtree(os.path.join(root, str(old)))


def restore_checkpoint(root: str, step: int, params: LlamaParams,
                       opt_state: torch.optim.Optimizer) -> None:
    """Load ``<root>/<step>`` into ``params`` (in place) and ``opt_state``."""
    state = torch.load(os.path.join(root, str(step), _STATE),
                       map_location=params.embed.device, weights_only=True)
    with torch.no_grad():
        for name, w in trainable_tensors(params).items():
            w.copy_(state["params"][name])
    opt_state.load_state_dict(state["opt_state"])


def main(args: Arguments, targs: TrainArguments):
    if targs.fsdp != 1 or args.dp != 1 or args.tp != 1:
        refuse_parallelism(f"dp={args.dp} fsdp={targs.fsdp} tp={args.tp}")
    params, cfg, tokenizer = load_from_args(args)
    dev = params.embed.device

    exits = ()
    if targs.early_exit_layers:
        exits = tuple(int(x) for x in str(targs.early_exit_layers).split(","))
    tcfg = TrainConfig(
        p_max=targs.p_max, dropout_scale=targs.dropout_scale,
        early_exit_layers=exits, e_scale=targs.e_scale,
        rotational_r=targs.rotational_r, learning_rate=targs.learning_rate,
        weight_decay=targs.weight_decay,
        ce_chunk_tokens=targs.ce_chunk_tokens,
    )
    train_step, init_opt = make_train_step(cfg, tcfg)
    opt_state = init_opt(params)
    start_step = 0

    root = os.path.abspath(targs.checkpoint_dir) if targs.checkpoint_dir else None
    if root and targs.resume and checkpoint_steps(root):
        start_step = checkpoint_steps(root)[-1]
        restore_checkpoint(root, start_step, params, opt_state)
        log.info("resumed from step %d", start_step)
        print(f"resumed from checkpoint step {start_step}")

    examples = get_data(
        random_shuffle=True, num_samples=0, dataset=targs.dataset,
        data_path=targs.data_path, seed=args.seed,
    )
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    t0 = time.time()
    batches = build_batches(
        examples, tokenizer, targs.batch_size, targs.seq_len,
        targs.steps - start_step,
    )
    history = []
    for step, (ids, labels) in enumerate(batches, start=start_step):
        ids_d = torch.from_numpy(ids).to(dev, torch.long)
        labels_d = torch.from_numpy(labels).to(dev, torch.long)
        params, opt_state, aux = train_step(params, opt_state, ids_d, labels_d,
                                            generator, step)
        if (step + 1) % targs.log_every == 0 or step == start_step:
            loss = float(aux["loss"])  # sync
            dt = time.time() - t0
            tokens = targs.batch_size * targs.seq_len * (step + 1 - start_step)
            history.append((step + 1, loss))
            print(f"step {step + 1}/{targs.steps} loss={loss:.4f} "
                  f"({tokens / max(dt, 1e-9):.0f} tok/s)")
        if root and (step + 1) % targs.save_every == 0:
            save_checkpoint(root, step + 1, params, opt_state)
    if targs.export_dir:
        path = save_params(params, targs.export_dir, cfg)
        print(f"exported HF-compatible checkpoint to {path}")
    return params, history


if __name__ == "__main__":
    a, t = parse_dataclasses((Arguments, TrainArguments))
    main(a, t)
