"""Process-group setup (port of ``layerskip_tpu/parallel/distributed.py``).

The JAX package joins its multi-host runtime with
``jax.distributed.initialize``; the port joins a ``torch.distributed``
process group. Every rank runs the same program on its own shard (no rank
exits), so the ranks must start together: under ``torchrun
--nproc-per-node N`` (one rank per card, NCCL), or under the port's own
launcher (``python -m layerskip_tpu_torch.parallel.launch``), which also
starts ranks that share a card or the CPU (gloo).

The caller names the backend; nothing here picks another one when the
named one fails.
"""

from __future__ import annotations

import os
import random
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# the init method the port's launcher hands its ranks (``file://`` or
# ``tcp://``); torchrun's ranks use ``env://`` (MASTER_ADDR / MASTER_PORT)
INIT_ENV = "LAYERSKIP_TORCH_INIT"
# the backend the port's launcher names for its ranks (read by the CLI apps)
BACKEND_ENV = "LAYERSKIP_TORCH_BACKEND"


def world_size_from_env() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def setup(
    backend: str,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    seed: int = 42,
) -> None:
    """Join the process group of ``world_size`` ranks over ``backend``
    (``nccl`` when each rank owns a card, ``gloo`` when ranks share a card
    or run on the CPU), then seed Python's, numpy's and torch's generators
    with ``seed``. Arguments left None come from the environment that
    torchrun or the port's launcher sets (``WORLD_SIZE``, ``RANK``, and
    ``LAYERSKIP_TORCH_INIT`` or else ``env://``). A world of one joins
    nothing. Under NCCL the rank's card is ``LOCAL_RANK`` (under gloo
    ``LOCAL_RANK`` modulo the cards, so ranks may share one). Prints the
    rank, world size and backend to stderr."""
    world_size = world_size_from_env() if world_size is None else int(world_size)
    if world_size > 1 and not dist.is_initialized():
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be nccl or gloo, not {backend!r}")
        rank = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
        init_method = init_method or os.environ.get(INIT_ENV) or "env://"
        if torch.cuda.is_available():  # NCCL: one card per rank; gloo may share
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local if backend == "nccl"
                                  else local % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
        print(f"[dist] rank {rank} of {world_size} joined over {backend} "
              f"({init_method})", file=sys.stderr, flush=True)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def teardown() -> None:
    from layerskip_tpu_torch.parallel.mesh import forget_meshes

    forget_meshes()
    if dist.is_initialized():
        dist.destroy_process_group()
