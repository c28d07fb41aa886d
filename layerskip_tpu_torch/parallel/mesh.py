"""Device meshes over ``torch.distributed`` (port of
``layerskip_tpu/parallel/mesh.py``).

A mesh is a ``DeviceMesh`` with named dims over the ranks of the process
group (``parallel/distributed.setup``), the trailing dim varying fastest:

  * ``dp`` — data parallel (batch rows)
  * ``ep`` — expert parallel (MoE experts), between dp and tp when > 1
  * ``tp`` — tensor parallel (heads, MLP features, vocab)
  * ``sp`` — the KV cache's sequence dim (``make_sp_mesh``; the engine's
    ``kv_shard_axis``)
  * ``fsdp`` — training only (``make_train_mesh``): the stacked layers'
    [L] dim, ZeRO-3 style (each layer lives on one rank and reaches the
    others when it runs), and the activations' sequence dim

The sharding itself is explicit (``parallel/sharding.py``); the mesh only
supplies the groups.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


# meshes made in this process, by (shape, dim names, device type): asking
# again for a mesh returns the same one (and creates no new groups, which
# every rank would have to join), so a loader and an engine can each ask
_MESHES: dict = {}


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape, names, device_type: str) -> Optional[DeviceMesh]:
    if not dist.is_initialized():
        return None  # one process, one device: nothing to split
    key = (tuple(shape), tuple(names), device_type)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device_type, tuple(shape),
                                        mesh_dim_names=tuple(names))
    return _MESHES[key]


def forget_meshes() -> None:
    """Drop the meshes made so far (their groups end with the process group)."""
    _MESHES.clear()


def make_mesh(dp: int = 1, tp: int = 1, ep: int = 1,
              device_type: str = "cuda") -> Optional[DeviceMesh]:
    """A [dp, tp] (or, with ``ep`` > 1, [dp, ep, tp]) mesh over every rank;
    ``dp * ep * tp`` must be the world size. None in a process that joined
    no process group (a world of one)."""
    shape = (dp, ep, tp) if ep > 1 else (dp, tp)
    names = ("dp", "ep", "tp") if ep > 1 else ("dp", "tp")
    if dp * ep * tp != _world():
        raise ValueError(f"dp*ep*tp={dp * ep * tp} != #devices={_world()}")
    return _mesh(shape, names, device_type)


def make_sp_mesh(sp: int, tp: int = 1, device_type: str = "cuda") -> Optional[DeviceMesh]:
    """An [sp] (or [sp, tp]) mesh: the KV sequence dim over ``sp`` (pass
    ``kv_shard_axis="sp"`` to the engine), the weights over ``tp``."""
    if sp * tp != _world():
        raise ValueError(f"sp*tp={sp * tp} != #devices={_world()}")
    return _mesh((sp, tp) if tp > 1 else (sp,), ("sp", "tp") if tp > 1 else ("sp",),
                 device_type)


def make_train_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1,
                    device_type: str = "cuda") -> Optional[DeviceMesh]:
    """The [dp, fsdp, tp] training mesh over every rank: ``dp`` data
    parallel (gradients summed), ``fsdp`` the stacked layers and the
    sequence (``training/recipe.py``), ``tp`` Megatron tensor parallel;
    ``dp * fsdp * tp`` must be the world size. None in a process that
    joined no process group (a world of one)."""
    if dp * fsdp * tp != _world():
        raise ValueError(f"dp*fsdp*tp={dp * fsdp * tp} != #devices={_world()}")
    return _mesh((dp, fsdp, tp), ("dp", "fsdp", "tp"), device_type)


def single_device_mesh(device_type: str = "cuda") -> Optional[DeviceMesh]:
    return make_mesh(1, 1, device_type=device_type)
