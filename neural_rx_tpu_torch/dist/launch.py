"""Start a group of ranks on this machine and collect what each returns.

`run_ranks(target, world, backend, payload)` starts `world` processes
with the `spawn` method (CUDA cannot be forked), joins them into one
`torch.distributed` group through a `file://` rendezvous in a temporary
directory, calls the function `target` ("module:function") with `payload`
in each, and returns the ranks' results in rank order. A rank that raises
or a group that outlives `timeout` fails the call, with the ranks'
tracebacks; every process started is ended before it returns.

Under NCCL each rank takes card `rank % device_count`; under gloo the
ranks share the card (or the CPU). Payloads and results pass through
`torch.save` files this module writes itself. For launching across
machines use `torchrun` and `multihost.initialize` instead.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .multihost import initialize


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(target: str, rank: int, world: int, backend: str,
               workdir: str):
    torch.set_num_threads(1)  # ranks share the host's cores
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        initialize(backend, f"file://{workdir}/rendezvous", world, rank)
        payload = torch.load(os.path.join(workdir, "payload.pt"),
                             weights_only=False)
        result = _resolve(target)(payload)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target: str, world: int, backend: str, payload,
              timeout: float = 600.0) -> list:
    """[result of rank 0, ..., rank world-1] of target(payload) run in a
    group of `world` spawned ranks over `backend`, each with torch in one
    thread."""
    if world < 2:
        raise ValueError("a group of ranks has at least 2")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="nrx_ranks_") as workdir:
        torch.save(payload, os.path.join(workdir, "payload.pt"))
        procs = [ctx.Process(target=_rank_main,
                             args=(target, r, world, backend, workdir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:  # until all are done, one fails (the rest would wait on it)
            while (any(p.is_alive() for p in procs)
                   and time.monotonic() < deadline
                   and not any(p.exitcode for p in procs)):
                time.sleep(0.05)
        finally:
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(workdir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0 and r not in alive:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if alive or errors:
            why = (f"ranks {alive} ended after a failure" if errors
                   else f"ranks {alive} outlived {timeout} s") if alive \
                else "failed"
            raise RuntimeError(f"{target} on {world} ranks ({backend}): "
                               f"{why}\n" + "\n".join(errors))
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
