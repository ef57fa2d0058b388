"""Fine-tune snapshotting off the training loop (a copy of the JAX package's
`multimodalpfn_tpu/train/snapshots.py` writer).

The reference ``torch.save``s the full state dict on every validation
improvement (``finetune_mmpfn_main.py:440-450``). Here the best parameters stay
on the device (a copy of one set of weights) and a single background writer
thread performs the device-to-host copy and the disk write, overlapped with
training. Only the latest submission is kept pending: intermediate bests that
are superseded before the writer gets to them are skipped (the on-disk
contract is "the best snapshot so far", which the final ``close()`` flush
guarantees).
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class AsyncSnapshotWriter:
    """Single background writer; keeps at most one pending payload."""

    def __init__(self, write_fn: Callable[[Any], None]) -> None:
        self._write_fn = write_fn
        self._pending: Any = None
        self._has_pending = False
        self._cond = threading.Condition()
        self._closed = False
        self._error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, name="mmpfn-snapshot-writer", daemon=True
        )
        self._thread.start()

    def submit(self, payload: Any) -> None:
        """Replace the pending payload (device arrays are fine — the fetch
        happens on the writer thread, overlapped with training)."""
        with self._cond:
            if self._closed:
                raise RuntimeError("snapshot writer already closed")
            self._pending = payload
            self._has_pending = True
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._has_pending and not self._closed:
                    self._cond.wait()
                if not self._has_pending and self._closed:
                    return
                payload, self._pending = self._pending, None
                self._has_pending = False
            try:
                self._write_fn(payload)
            except BaseException as e:  # surfaced at close()
                self._error = e

    def close(self) -> None:
        """Drain the queue (the latest pending payload IS written), then join.
        Re-raises the last writer error, if any."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join()
        if self._error is not None:
            raise self._error
