"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for (the default of every entry point) and none is present.

    On CUDA it also pins matmul precision: float32 products stay full
    float32 (no TF32, in cuBLAS and in cuDNN), and bf16 products reduce in
    fp32 without the reduced-precision split-K path. The JAX package
    accumulates every product in fp32, and greedy decoding compares
    argmaxes of logits whose near-ties a coarser reduction would flip.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def refuse_parallelism(setting: str) -> None:
    """Raise for a setting of the JAX package's training mesh (the train
    CLI's dp, tp and fsdp, sequence-sharded activations, ring attention):
    inference runs sharded (parallel/), training on one device until its
    mesh is ported, and every such training setting is refused here, in the
    same words."""
    raise NotImplementedError(f"{setting}: sharding is not ported yet")
