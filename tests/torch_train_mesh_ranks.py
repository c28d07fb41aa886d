"""Rank bodies of the port's training-mesh CPU tests
(tests/test_torch_ring_attention.py, tests/test_torch_train_mesh.py).

    python tests/torch_train_mesh_ranks.py <suite> <workdir>

runs under the port's launcher (``layerskip_tpu_torch.parallel.launch``,
gloo, a ``file://`` rendezvous): it reads ``<workdir>/inputs.pt`` (numpy
arrays and config keywords the test process made, the JAX package's keep
masks among them), runs the suite's cases and writes
``<workdir>/rank<r>.pt``. It imports torch and the port only, never JAX:
the test process compares the results with the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist

from layerskip_tpu_torch.config import tiny_config
from layerskip_tpu_torch.models import llama
from layerskip_tpu_torch.models.llama import LlamaParams
from layerskip_tpu_torch.models.params import params_from_numpy
from layerskip_tpu_torch.ops import moe
from layerskip_tpu_torch.ops.ring_attention import ring_attention_sharded
from layerskip_tpu_torch.parallel import collectives
from layerskip_tpu_torch.parallel.collectives import Axis, sharded
from layerskip_tpu_torch.parallel.distributed import setup, teardown
from layerskip_tpu_torch.parallel.mesh import make_train_mesh
from layerskip_tpu_torch.parallel.sharding import check_divisible, gather_params, shard_params
from layerskip_tpu_torch.training import recipe

# name -> (dp, fsdp, tp, ring) of each world size's meshes
MESHES = {
    "mesh2": {"dp2": (2, 1, 1, False), "fsdp2": (1, 2, 1, False), "tp2": (1, 1, 2, False),
              "fsdp2_ring": (1, 2, 1, True)},
    "mesh4": {"fsdp2tp2": (1, 2, 2, False), "dp2fsdp2": (2, 2, 1, False)},
    "mesh8": {"dp2fsdp2tp2": (2, 2, 2, False), "dp2fsdp2tp2_ring": (2, 2, 2, True)},
}
FAMILIES = ("dense", "moe")


def run_suite(suite: str, nproc: int, work: str, inputs: dict):
    """Launch ``suite`` over ``nproc`` gloo ranks on ``inputs``; every
    rank's results."""
    from layerskip_tpu_torch.parallel.launch import launch

    torch.save(inputs, os.path.join(work, "inputs.pt"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=path)
    rc = launch([os.path.abspath(__file__), suite, work], nproc, "gloo",
                init_method="file://" + os.path.join(work, "rendezvous"), env=env,
                timeout=600)
    assert rc == 0, f"suite {suite} failed with exit code {rc}"
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(nproc)]


def world_axis(rank: int) -> Axis:
    return Axis(group=dist.group.WORLD, size=dist.get_world_size(), rank=rank)


# ------------------------------------------------------------ ring attention


def suite_ring(inputs, rank):
    """The ring over every rank: output and dq/dk/dv of sum(out * cot);
    and ``reduce_scatter`` of each rank's own rows, with its gradient."""
    ax = world_axis(rank)
    q, k, v = (torch.from_numpy(inputs[n]).requires_grad_(True) for n in ("q", "k", "v"))
    collectives.reset_calls()
    out = ring_attention_sharded(q, k, v, ax)
    (out * torch.from_numpy(inputs["cot"])).sum().backward()
    res = dict(out=out.detach(), dq=q.grad, dk=k.grad, dv=v.grad,
               shifts=collectives.CALLS["ring_shift"])
    x = torch.from_numpy(inputs["rs_x"][rank]).requires_grad_(True)
    y = collectives.reduce_scatter(x, ax, 0)
    rows = y.shape[0]
    (y * torch.from_numpy(inputs["rs_cot"][rank][:rows])).sum().backward()
    res.update(rs_y=y.detach(), rs_grad=x.grad)
    return res


# ------------------------------------------------------------ the training mesh


def model(inputs, family):
    cfg = tiny_config(**inputs["cfg"][family])
    return cfg, params_from_numpy(inputs["trees"][family], device="cpu")


def tcfg_of(inputs, ring, **over):
    return recipe.TrainConfig(**{**inputs["tcfg"], **over}, act_spec=recipe.ACT_SPEC,
                              ring_axis="fsdp" if ring else None)


def part(x: np.ndarray, ctx) -> torch.Tensor:
    """This rank's rows (dp) and positions (fsdp) of a global [B, T] batch."""
    b, t = x.shape
    for ax, dim, n in ((ctx.dp, 0, b), (ctx.fsdp, 1, t)):
        if ax is not None:
            x = np.take(x, range(ax.rank * n // ax.size, (ax.rank + 1) * n // ax.size), axis=dim)
    return torch.from_numpy(np.ascontiguousarray(x))


def grads_of(local: LlamaParams) -> LlamaParams:
    """The gradients, in the params' layout."""
    g = lambda w: None if w is None else w.grad  # noqa: E731
    return LlamaParams(embed=g(local.embed), layers=dataclasses.replace(
        local.layers, **{f.name: g(getattr(local.layers, f.name))
                         for f in dataclasses.fields(local.layers)}),
        final_norm=g(local.final_norm), lm_head=g(local.lm_head))


def named(params: LlamaParams) -> dict:
    return {k: w.detach().clone() for k, w in recipe.trainable_tensors(params).items()}


def mesh_case(inputs, family, dp, fsdp, tp, ring):
    """Loss, aux and whole gradients of one step; the losses and whole
    params after two AdamW steps."""
    cfg, params = model(inputs, family)
    mesh = make_train_mesh(dp, fsdp, tp, device_type="cpu")
    tcfg = tcfg_of(inputs, ring)
    ids, labels = inputs["ids"], inputs["labels"]
    local, ctx = shard_params(params, mesh, cfg)
    check_divisible(cfg, ctx, batch=ids.shape[0], seq=ids.shape[1])
    shapes = {k: tuple(w.shape) for k, w in recipe.trainable_tensors(local).items()}
    for w in recipe.trainable_tensors(local).values():
        w.requires_grad_(True)
    moe.reset_path_calls()
    collectives.reset_calls()
    with sharded(ctx):
        _, aux = recipe.loss_and_grads(local, cfg, tcfg, part(ids, ctx), part(labels, ctx),
                                       step=1, keep=torch.from_numpy(inputs["keep"]))
        grads = named(gather_params(grads_of(local), ctx))
    calls = dict(collectives.CALLS)

    cfg, params = model(inputs, family)
    local, _ = shard_params(params, mesh, cfg)
    tcfg = tcfg_of(inputs, ring, **inputs["adam"])
    step_fn, init_opt = recipe.make_train_step(cfg, tcfg, mesh)
    opt = init_opt(local)
    losses, after = [], []
    for step in range(2):
        local, opt, saux = step_fn(local, opt, part(ids, ctx), part(labels, ctx), step=step,
                                   keep=torch.from_numpy(inputs["adam_keep"][step]))
        losses.append(float(saux["loss"]))
        with sharded(ctx):
            after.append(named(gather_params(local, ctx)))
    return dict(aux=aux, grads=grads, shapes=shapes, calls=calls, losses=losses, after=after)


def _inference_era_all_reduce(x, ax, op="sum"):
    """The port's all-reduce before the training mesh: a clone reduced in
    place (no gradient rule: its backward is the identity)."""
    if ax is None:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=collectives._OPS[op], group=ax.group)
    return y


def _inference_era_all_gather(x, ax, dim, grad="slice"):
    """The port's all-gather before the training mesh: fresh buffers, no
    gradient reaches ``x``."""
    if ax is None:
        return x
    parts = [torch.empty_like(x.contiguous()) for _ in range(ax.size)]
    dist.all_gather(parts, x.contiguous(), group=ax.group)
    return torch.cat(parts, dim=dim)


def inference_era_tp2(inputs):
    """The dense model at tp 2 with the collectives as the port had them for
    inference (and no f in front of the column-parallel products): first
    with their all-gather (does the loss reach any weight?), then with only
    their all-reduce (the whole gradients)."""
    saved = (recipe.all_gather, recipe.all_reduce, recipe.copy_to_group, llama.all_reduce,
             moe.copy_to_group)
    mesh = make_train_mesh(1, 1, 2, device_type="cpu")
    tcfg = tcfg_of(inputs, False)
    out = {}
    try:
        # torch warns that c10d's in-place all-reduce has no autograd rule:
        # the fault shown here
        warnings.filterwarnings("ignore", message="c10d::allreduce_")
        recipe.copy_to_group = moe.copy_to_group = lambda x, ax: x
        recipe.all_reduce = llama.all_reduce = _inference_era_all_reduce
        for label, gather in (("old_gather", _inference_era_all_gather),
                              ("old_reduce", saved[0])):
            recipe.all_gather = gather
            cfg, params = model(inputs, "dense")
            local, ctx = shard_params(params, mesh, cfg)
            for w in recipe.trainable_tensors(local).values():
                w.requires_grad_(True)
            with sharded(ctx):
                loss, _ = recipe.layerskip_loss(local, cfg, tcfg, part(inputs["ids"], ctx),
                                                part(inputs["labels"], ctx), step=1,
                                                keep=torch.from_numpy(inputs["keep"]))
                out[label] = {"requires_grad": loss.requires_grad}
                if loss.requires_grad:
                    loss.backward()
                    out[label]["grads"] = named(gather_params(grads_of(local), ctx))
    finally:
        (recipe.all_gather, recipe.all_reduce, recipe.copy_to_group, llama.all_reduce,
         moe.copy_to_group) = saved
    return out


def suite_mesh(inputs, rank, suite):
    res = {}
    for name, (dp, fsdp, tp, ring) in MESHES[suite].items():
        for family in FAMILIES:
            if ring and family == "moe":
                continue
            res[(name, family)] = mesh_case(inputs, family, dp, fsdp, tp, ring)
    if suite == "mesh2":
        res["inference_era_tp2"] = inference_era_tp2(inputs)
    return res


def main() -> int:
    suite, work = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    setup("gloo")
    rank = dist.get_rank()
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    res = suite_ring(inputs, rank) if suite == "ring" else suite_mesh(inputs, rank, suite)
    torch.save(res, os.path.join(work, f"rank{rank}.pt"))
    teardown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
