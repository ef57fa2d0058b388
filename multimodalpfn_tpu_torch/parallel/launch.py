"""Run a function on several ranks of one machine: each rank is a process
started with ``spawn``, joins a process group through a file store (no
network port) and returns its value through a file. The CPU tests run their
gloo rings this way, and `chip_smoke.py` its ranks on the card."""

from __future__ import annotations

import multiprocessing
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist

from multimodalpfn_tpu_torch.parallel.mesh import initialize_distributed

# after one rank fails, the others get this long to finish before they are
# terminated (they may wait in a collective the failed rank never joins)
FAILURE_GRACE_S = 10.0


def _rank_main(rank: int, world: int, fn: Callable, args: tuple, device: str, store: str,
               result: str, threads: int | None) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        initialize_distributed(device=device, init_method=f"file://{store}", world_size=world, rank=rank)
        value = fn(rank, world, *args)
        torch.save({"ok": True, "value": value}, result)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, result)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world: int, *args: Any, workdir: str | Path, device: str = "cpu",
              threads: int | None = 1, timeout: float = 600.0) -> list[Any]:
    """``[fn(rank, world, *args) for rank in range(world)]``, each call in a
    process of its own inside one process group: gloo for ``device="cpu"``,
    NCCL for ``"cuda"`` (one card a rank). ``fn`` must be importable (a
    module-level function) and its value picklable. ``workdir`` (empty or
    new) holds the store and the results. Raises RuntimeError with the
    failed ranks' tracebacks when any rank fails or the run outlasts
    ``timeout`` seconds; no process outlives the call."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    if store.exists():
        raise FileExistsError(f"run_ranks: {store} exists; give a new workdir")
    results = [workdir / f"rank{r}.pt" for r in range(world)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, fn, args, device, str(store), str(results[r]),
                                                 threads), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    t0, failed_at = time.monotonic(), None
    try:
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            if now - t0 > timeout or (failed_at is not None and now - failed_at > FAILURE_GRACE_S):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    errors, values = [], []
    for r, (p, path) in enumerate(zip(procs, results)):
        out = torch.load(path, weights_only=False) if path.exists() else None
        if out is None or not out["ok"]:
            detail = out["error"] if out is not None else f"no result (exit code {p.exitcode})"
            errors.append(f"rank {r}: {detail}")
        else:
            values.append(out["value"])
    if errors:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}) failed on {len(errors)} of {world} "
                           "ranks:\n" + "\n".join(errors))
    return values
