"""Start the ranks of a sharded run on this host: a small torchrun.

    python -m layerskip_tpu_torch.parallel.launch --nproc 2 --backend gloo \\
        -- -m layerskip_tpu_torch.cli.generate --model random:tiny --tp 2 --device cpu

runs ``python <args after -->`` as ``--nproc`` processes with torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``) plus the init method (``LAYERSKIP_TORCH_INIT``) and
the backend (``LAYERSKIP_TORCH_BACKEND``) that ``parallel.distributed.setup``
and the CLI apps read. The init method defaults to a ``file://`` rendezvous
in a new temporary directory (no port to collide with); ranks of several
launchers ("hosts", ``--nnodes``/``--node-rank``) share one given with
``--init``. Rank 0 inherits the launcher's standard input, the others read
nothing; every rank writes to the launcher's standard output and error.
Ranks that share one card, or the CPU, need ``--backend gloo``: NCCL takes
one card per rank. The exit code is the first failing rank's (the others
are then stopped), or 0.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

from layerskip_tpu_torch.parallel.distributed import BACKEND_ENV, INIT_ENV


def launch(argv: Sequence[str], nproc: int, backend: str, init_method: Optional[str] = None,
           nnodes: int = 1, node_rank: int = 0, env: Optional[dict] = None,
           timeout: Optional[float] = None) -> int:
    """Run ``python *argv`` as ``nproc`` ranks of a world of ``nproc *
    nnodes`` (this launcher's ranks are ``node_rank * nproc`` onwards) and
    wait for them. Returns the first failing rank's exit code, or 0; a rank
    that fails, or ``timeout`` seconds, stops them all (124 on a timeout)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, not {backend!r}")
    tmp = None
    if init_method is None:
        if nnodes > 1:
            raise ValueError("ranks of several launchers need a shared --init")
        tmp = tempfile.TemporaryDirectory()
        init_method = "file://" + os.path.join(tmp.name, "rendezvous")
    world = nproc * nnodes
    procs = []
    try:
        for local in range(nproc):
            rank = node_rank * nproc + local
            penv = dict(os.environ if env is None else env, RANK=str(rank),
                        WORLD_SIZE=str(world), LOCAL_RANK=str(local),
                        LOCAL_WORLD_SIZE=str(nproc), **{INIT_ENV: init_method,
                                                        BACKEND_ENV: backend})
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env=penv,
                stdin=None if rank == 0 else subprocess.DEVNULL))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            failed = [rc for rc in rcs if rc not in (None, 0)]
            if failed:
                return failed[0]
            if all(rc == 0 for rc in rcs):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                return 124
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if tmp is not None:
            tmp.cleanup()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, required=True, help="ranks on this host")
    ap.add_argument("--backend", required=True, choices=("nccl", "gloo"))
    ap.add_argument("--init", default=None, help="init method shared by every host")
    ap.add_argument("--nnodes", type=int, default=1)
    ap.add_argument("--node-rank", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="-- then the arguments of python for each rank")
    ns = ap.parse_args(argv)
    args = ns.args[1:] if ns.args[:1] == ["--"] else ns.args
    if not args:
        ap.error("nothing to run: give python's arguments after --")
    return launch(args, ns.nproc, ns.backend, ns.init, ns.nnodes, ns.node_rank,
                  timeout=ns.timeout)


if __name__ == "__main__":
    sys.exit(main())
