"""Two-host rehearsal of a sharded run on the CPU (port of
``scripts/multihost_smoke.py``).

Two launchers ("hosts") of two local ranks each join one gloo process
group of four ranks through a shared ``file://`` rendezvous, and each rank
checks:

  1. an all-gather over the world sees every rank,
  2. a sum over a global 2 x 2 (dp, tp) mesh reduces across both hosts,
  3. a tp 4 self-speculative decode of a tiny fp32 model over the world
     emits exactly the single-process token stream.

    python -m layerskip_tpu_torch.parallel.multihost_smoke

Exit 0 when every check passes on every rank.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

HOSTS, LOCAL = 2, 2


def rank_body() -> None:
    import torch

    from layerskip_tpu_torch.config import GenerationConfig, tiny_config
    from layerskip_tpu_torch.generation.engine import Engine, postprocess_output
    from layerskip_tpu_torch.models.params import init_params
    from layerskip_tpu_torch.parallel.collectives import Axis, all_gather, all_reduce
    from layerskip_tpu_torch.parallel.distributed import setup, teardown
    from layerskip_tpu_torch.parallel.mesh import make_mesh
    from layerskip_tpu_torch.parallel.sharding import shard_params

    setup("gloo")
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == HOSTS * LOCAL, world

    # 1. every rank, through the world group
    everyone = Axis(group=dist.group.WORLD, size=world, rank=rank)
    got = all_gather(torch.tensor([rank]), everyone, 0).tolist()
    assert got == list(range(world)), got
    print(f"[rank {rank}] all-gather sees ranks {got} OK", flush=True)

    # 2. a sum over the global (dp, tp) mesh: each rank sums its rows, then
    # tp and dp reduce across both hosts
    mesh = make_mesh(dp=HOSTS, tp=LOCAL, device_type="cpu")
    rows = torch.arange(world * 8, dtype=torch.float64).reshape(world, 8)
    part = rows[rank].sum()
    dp = Axis(mesh.get_group(0), HOSTS, mesh.get_local_rank(0))
    tp = Axis(mesh.get_group(1), LOCAL, mesh.get_local_rank(1))
    total = float(all_reduce(all_reduce(part, tp), dp))
    want = float(world * 8 * (world * 8 - 1) / 2)
    assert total == want, (total, want)
    print(f"[rank {rank}] (dp, tp) mesh sum == {want:.0f} OK", flush=True)

    # 3. tp 4 over both hosts == the single-process stream
    cfg = tiny_config(num_attention_heads=4, num_key_value_heads=4)
    params = init_params(cfg, seed=1, device="cpu")  # the same on every rank
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        getattr(params.layers, name).mul_(7.5)
    params.embed.mul_(15.0)
    gen = GenerationConfig(max_steps=12, sample=False, generation_strategy="self_speculative",
                           exit_layer=2, num_speculations=3)
    prompt = [3, 17, 52, 9, 30]
    ref = postprocess_output(Engine(params, cfg, device="cpu").generate(prompt, gen), (), 12)
    tp_mesh = make_mesh(dp=1, tp=world, device_type="cpu")
    local, _ = shard_params(params, tp_mesh, cfg)
    got = postprocess_output(Engine(local, cfg, device="cpu", mesh=tp_mesh).generate(
        prompt, gen), (), 12)
    assert got == ref, (got, ref)
    print(f"[rank {rank}] tp={world} cross-host spec decode == single-process "
          f"({len(ref)} tokens) OK", flush=True)
    teardown()


def main() -> int:
    if sys.argv[1:] == ["--rank-body"]:
        rank_body()
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
        hosts = [subprocess.Popen(
            [sys.executable, "-m", "layerskip_tpu_torch.parallel.launch", "--nproc",
             str(LOCAL), "--nnodes", str(HOSTS), "--node-rank", str(h), "--backend", "gloo",
             "--init", init, "--timeout", "600", "--", "-m",
             "layerskip_tpu_torch.parallel.multihost_smoke", "--rank-body"], env=env)
            for h in range(HOSTS)]
        rcs = [h.wait() for h in hosts]
    ok = all(rc == 0 for rc in rcs)
    print(f"multihost smoke: {'PASS' if ok else 'FAIL'} (host exit codes {rcs})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
