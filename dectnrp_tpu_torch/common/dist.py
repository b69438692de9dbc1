"""The process group and the launcher of the multi-process code (the port's
counterpart of `jax.distributed.initialize` in tools/run_dcn_dryrun.py).

- `init(rank, world, store_path, backend, timeout_s)` joins the default
  process group through a FileStore (`init_method="file://<store_path>"`).
  No TCP port is named anywhere, so runs side by side on one host (tests
  under xdist) never collide on one. Every group has a timeout: a dead
  peer fails the run instead of hanging it.
- `spawn(fn, world, backend, devices, args, timeout_s)` starts `world`
  children with the spawn start method (CUDA does not survive a fork).
  Child `rank` selects its device, joins the group, calls `fn(rank, world,
  device, *args)` and returns its JSON-able dict; `spawn` returns those
  reports in rank order, each with its rank and backend. A child's stdout and stderr
  go to a log file. If a child fails, or the time runs out, the others are
  killed and `spawn` raises, quoting the tail of that child's log.

The backend is the caller's: `nccl` where every rank owns a distinct card,
`gloo` otherwise (on one card a block that crosses processes is then
copied to host memory, sent by gloo, and copied back to the shard's
device). Nothing here switches backend when one fails.
"""
from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import multiprocessing.connection
import os
import pathlib
import tempfile
import time

import torch
import torch.distributed as dist

#: bytes of a failed child's log quoted in spawn's error
TAIL_BYTES = 4000
#: seconds the peers of a failed child get to end on their own
GRACE_S = 2.0


def init(rank: int, world: int, store_path: str, backend: str,
         timeout_s: float = 300.0) -> None:
    """Join the default process group as `rank` of `world` through the
    FileStore at `store_path` (a file that no earlier group used)."""
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _child(fn, rank, world, store_path, backend, device, timeout_s, args,
           workdir):
    work = pathlib.Path(workdir)
    log = open(work / f"rank{rank}.log", "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    if backend == "gloo":
        # every child runs on this host: gloo's pairs go over the loopback
        # device, whatever the host name resolves to
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)      # before any CUDA work of this process
    else:
        # the children share the host's cores: spinning intra-op threads of
        # one slow down the others' collectives by orders of magnitude
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init(rank, world, store_path, backend, timeout_s)
    try:
        rep = fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()
    (work / f"rank{rank}.json").write_text(
        json.dumps({"rank": rank, "backend": backend, **rep}))


def _tail(path: pathlib.Path) -> str:
    data = path.read_bytes() if path.exists() else b""
    return data[-TAIL_BYTES:].decode(errors="replace")


def spawn(fn, world: int, backend: str, devices, args=(),
          timeout_s: float = 300.0) -> list[dict]:
    """Run fn(rank, world, device, *args) in `world` spawned processes
    joined into one group over `backend`; device = devices[rank], which the
    child selects before it joins (a card, or the CPU where the caller
    lists it: there is no default). fn is a module-level function; it and
    args are pickled. Returns the children's reports in rank order.
    Raises RuntimeError if a child fails or all have not finished within
    timeout_s, after killing the others."""
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != world:
        raise ValueError(f"spawn: {len(devices)} devices for {world} ranks")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dectnrp_dist_") as tmp:
        work = pathlib.Path(tmp)
        procs = [ctx.Process(target=_child, daemon=True, args=(
            fn, r, world, str(work / "store"), backend, devices[r], timeout_s,
            tuple(args), tmp)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = timed_out = False
        try:
            while True:
                codes = [p.exitcode for p in procs]
                left = deadline - time.monotonic()
                if all(c == 0 for c in codes):
                    break
                if any(c not in (None, 0) for c in codes):
                    failed = True
                    # the peers of a failed rank fail soon after it: let
                    # them, so that every failed rank's output is quoted
                    end = time.monotonic() + min(max(left, 0), GRACE_S)
                    while any(p.exitcode is None for p in procs) and \
                            time.monotonic() < end:
                        mp.connection.wait([p.sentinel for p in procs
                                            if p.exitcode is None],
                                           timeout=end - time.monotonic())
                    break
                if left <= 0:
                    timed_out = True
                    break
                mp.connection.wait([p.sentinel for p in procs
                                    if p.exitcode is None], timeout=min(left, 1.0))
        finally:
            codes = [p.exitcode for p in procs]
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        if failed or timed_out:
            if failed:
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                head = "; ".join(f"rank {r} of {world} ({backend}) exited with "
                                 f"code {codes[r]}" for r in bad)
            else:
                bad = [r for r, c in enumerate(codes) if c != 0]
                head = (f"rank(s) {bad} of {world} ({backend}) had not "
                        f"finished after {timeout_s} s")
            raise RuntimeError(
                f"dist.spawn: {head}; the other ranks were killed.\n" + "\n".join(
                    f"The tail of rank {r}'s output:\n{_tail(work / f'rank{r}.log')}"
                    for r in bad))
        return [json.loads((work / f"rank{r}.json").read_text())
                for r in range(world)]
