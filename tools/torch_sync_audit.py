#!/usr/bin/env python3
"""Which host syncs the port makes, and whether each is a ``mmpfn.sync.*``
span: PyTorch's sync debug mode (``torch.cuda.set_sync_debug_mode("warn")``)
warns at every operation that waits for the card; `audit` runs a call under
it and under a profiler (so that `utils.profiling.span` records), and puts
each warning down to the innermost span open on its thread.

    python3 tools/torch_sync_audit.py [--seed N] [--out chiprun_out/sync_audit.json]

On a card, this runs the flagship classifier's three paths at the sizes of
`portbench/`'s cells: a warm 460-row ``predict_proba`` after a fit on 1838
rows (``fit_preprocessors``), a warm batch of 8 such requests through
``predict_proba_many`` against the K/V cache (``fit_with_cache``, 2 in
flight), and warm iterations of ``fine_tune_mmpfn`` on 2298 rows; it prints
every sync site with its span, count and host wait, and exits 1 where a
sync is outside a sync span or a sync span holds no sync or several.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import sys
import threading
import time
import traceback
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SYNC_WARNING = "called a synchronizing CUDA operation"
SYNC_PREFIX = "mmpfn.sync."
PACKAGE = "multimodalpfn_tpu_torch"


@dataclasses.dataclass
class Span:
    index: int  # order of entry, over every thread
    name: str
    thread: str
    seconds: float = 0.0  # host time from entry to exit


@dataclasses.dataclass
class Sync:
    thread: str
    span: Span | None  # the innermost span open on the thread
    site: str  # the innermost frame of the port that made the call
    pos: int  # spans entered before it


@dataclasses.dataclass
class Audit:
    syncs: list[Sync]
    spans: list[Span]

    def between(self, lo: int, hi: int) -> "Audit":
        """The syncs and spans from span index ``lo`` up to ``hi``."""
        return Audit([s for s in self.syncs if lo <= s.pos < hi],
                     [s for s in self.spans if lo <= s.index < hi])

    def main_syncs(self) -> list[Sync]:
        return [s for s in self.syncs if s.thread == threading.main_thread().name]

    def unmatched(self) -> list[str]:
        """Every sync of the main thread outside a sync span, and every sync
        span that holds other than one sync."""
        problems, held = [], collections.Counter()
        for s in self.main_syncs():
            if s.span is None or not s.span.name.startswith(SYNC_PREFIX):
                problems.append(f"a sync at {s.site} inside {s.span.name if s.span else 'no span'}")
            else:
                held[s.span.index] += 1
        for sp in self.spans:
            if sp.name.startswith(SYNC_PREFIX) and sp.thread == threading.main_thread().name \
                    and held[sp.index] != 1:
                problems.append(f"{sp.name} (span {sp.index}) holds {held[sp.index]} syncs")
        return problems

    def sites(self) -> list[dict]:
        """The syncs by (span, thread, site): count and the host's wait in
        their sync spans."""
        rows: dict[tuple, dict] = {}
        for s in self.syncs:
            name = s.span.name if s.span else None
            key = (name, s.thread, s.site)
            row = rows.setdefault(key, {"span": name, "thread": s.thread, "site": s.site,
                                        "count": 0, "wait_ms": 0.0})
            row["count"] += 1
            if s.span is not None and name.startswith(SYNC_PREFIX):
                row["wait_ms"] += 1e3 * s.span.seconds
        return sorted(rows.values(), key=lambda r: -r["count"])

    def report(self) -> str:
        return json.dumps({"unmatched": self.unmatched(), "sites": self.sites()}, indent=1)


@contextlib.contextmanager
def _tracked():
    """``torch.profiler.record_function`` that also keeps, per thread, the
    spans open (innermost last), and a log of every span entered."""
    real = torch.profiler.record_function
    local = threading.local()
    log: list[Span] = []

    class Tracked:
        def __init__(self, name, args=None):
            self.rf, self.name = real(name, args), name

        def __enter__(self):
            if not hasattr(local, "stack"):
                local.stack = []
            self.span = Span(len(log), self.name, threading.current_thread().name)
            log.append(self.span)
            local.stack.append(self.span)
            self.t0 = time.perf_counter()
            self.rf.__enter__()
            return self

        def __exit__(self, *exc):
            out = self.rf.__exit__(*exc)
            self.span.seconds = time.perf_counter() - self.t0
            local.stack.pop()
            return out

    torch.profiler.record_function = Tracked
    try:
        yield log, local
    finally:
        torch.profiler.record_function = real


def _site() -> str:
    frames = [f for f in traceback.extract_stack() if PACKAGE in f.filename]
    if not frames:
        return "(outside the port)"
    f = frames[-1]
    return f"{f.filename[f.filename.index(PACKAGE):]}:{f.lineno} ({f.name})"


def audit(fn) -> Audit:
    """``fn()`` under a CPU profiler and the sync debug mode: each sync
    warning put down to the innermost span open on its thread."""
    syncs: list[Sync] = []
    with _tracked() as (log, local), warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING not in str(message):
                return shown(message, category, filename, lineno, file, line)
            stack = getattr(local, "stack", [])
            syncs.append(Sync(threading.current_thread().name, stack[-1] if stack else None,
                              _site(), len(log)))

        warnings.showwarning = show
        mode = torch.cuda.get_sync_debug_mode()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()
    return Audit(syncs, list(log))


def audit_finetune(kwargs: dict, warm: int) -> list[Audit]:
    """``fine_tune_mmpfn(**kwargs)`` under `audit`, cut into its iterations
    (one ``mmpfn.train.step`` span's entry to the next's); returns those
    after the first ``warm`` and before the last, whose end is the call's."""
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    result = audit(lambda: fine_tune_mmpfn(**kwargs))
    starts = [s.index for s in result.spans if s.name == "mmpfn.train.step"]
    return [result.between(lo, hi) for lo, hi in zip(starts[warm:], starts[warm + 1:])]


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=4400000123)
    ap.add_argument("--iterations", type=int, default=6)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sync_audit.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import tempfile

    from portbench import bench, make
    from portbench.drivers import closed_loop, pipelined

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    declared = bench.load_json(ROOT / "BENCHMARK.json")
    config = bench.load_json(ROOT / declared["configs"][0]["file"])
    out, failed = {"device": torch.cuda.get_device_name(device)}, False

    def record(tag: str, result: Audit, per: int) -> None:
        nonlocal failed
        problems = result.unmatched()
        failed |= bool(problems)
        n_main = len(result.main_syncs())
        out[tag] = {"syncs_per_unit": n_main / per, "units": per, "unmatched": problems,
                    "sites": result.sites()}
        print(f"{tag}: {n_main} syncs over {per} unit(s), {len(problems)} unmatched", flush=True)
        for row in result.sites():
            print(f"  {row['count']:3d} x {row['span']} [{row['thread']}] {row['site']} "
                  f"{row['wait_ms']:.3f} ms", flush=True)
        for p in problems:
            print(f"  UNMATCHED {p}", flush=True)

    for module, traffic in ((closed_loop, "fitpre-460"), (pipelined, "cache-stream")):
        tr = bench.load_json(ROOT / "portbench" / "traffic" / f"{traffic}.json")
        cell = module.Cell(config, tr, args.seed, device)
        cell.setup()
        if traffic == "fitpre-460":
            reqs = [cell.request(rows) for rows in cell.next_rows(3)]
            for X, img in reqs[:2]:
                cell.clf.predict_proba(X, img)
            record(traffic, audit(lambda: cell.clf.predict_proba(*reqs[2])), 1)
        else:
            n = tr["batch"]
            reqs = [cell.request(rows) for rows in cell.next_rows(n)]
            record(traffic, audit(lambda: cell.clf.predict_proba_many(
                [r[0] for r in reqs], [r[1] for r in reqs], max_in_flight=tr["max_in_flight"])), n)
        cell.release()
        torch.cuda.empty_cache()

    arch = {**config["architecture"], "model_seed": make.model_seed(args.seed)}
    X, img, y = make.pad_ufes_like(args.seed, config["data"])
    with tempfile.TemporaryDirectory() as tmp:
        make.write_npz(Path(tmp) / "model.npz", make.make_weights(arch, args.seed, device), arch, args.seed)
        mix, ft = arch["mixer"], bench.load_json(ROOT / "portbench" / "traffic" / "finetune.json")
        iterations = audit_finetune(dict(
            mixer_type=mix["mixer_type"], mgm_heads=mix["mgm_heads"], cap_heads=mix["cap_heads"],
            features_per_group=arch["features_per_group"], path_to_base_model=str(Path(tmp) / "model.npz"),
            save_path_to_fine_tuned_model=str(Path(tmp) / "ft.ckpt"),
            finetuning_config={"learning_rate": ft["learning_rate"], "max_steps": args.iterations},
            validation_metric=config["validation_metric"], task_type=config["task"], device=device,
            X_train=X, image_train=img, y_train=y, random_seed=args.seed % 2**32, logger_level=30,
            freeze_input=ft["freeze_input"], state_checkpoint_every=0), warm=3)
    for i, it in enumerate(iterations):
        record(f"finetune-iteration-{i + 4}", it, 1)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
