"""The readers of the program's phases on small synthetic profiler traces,
written as Chrome traces and read back as a run reads them: the
preprocessing from the program's own spans (``mmpfn.*``), the host's waits
and the fine-tune's idle from the card's events."""

from __future__ import annotations

import json

import pytest

from portbench import trace
from portbench.metrics import program
from portbench.tests.test_portbench_readers import ev, read, record

KERNEL = "void at::native::elementwise_kernel<128, 2>()"


def write(tmp_path, events, **extra) -> dict:
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = trace.parse(path)
    out.update(launch_counts={}, **extra)
    return out


PAGEABLE_UP = "Memcpy HtoD (Pageable -> Device)"
PINNED_UP = "Memcpy HtoD (Pinned -> Device)"
FETCH = "Memcpy DtoH (Device -> Pageable)"
READ = "Memcpy DtoH (Device -> Pinned)"


def request(t: float) -> list[dict]:
    """One request from ``t``: its dispatch (validation 2 us, transform 10,
    two stacks of 3, a blocking upload, a pinned one that does not block, a
    forward), then its finalize with the fetch."""
    a = "user_annotation"
    return [ev(a, "mmpfn.predict.dispatch", t + 2, 58),
            ev(a, "mmpfn.preprocess.validate", t + 3, 2),
            ev(a, "mmpfn.preprocess.transform", t + 6, 10),
            ev(a, "mmpfn.preprocess.stack", t + 17, 3),
            ev(a, "mmpfn.sync.upload", t + 21, 4),
            ev("cpu_op", "aten::copy_", t + 22, 2),
            ev("gpu_memcpy", PAGEABLE_UP, t + 22, 1),
            ev("gpu_memcpy", PINNED_UP, t + 25, 1),
            ev(a, "mmpfn.forward", t + 26, 3),
            ev(a, "mmpfn.preprocess.stack", t + 30, 3),
            ev(a, "mmpfn.predict.finalize", t + 60, 20),
            ev(a, "mmpfn.sync.fetch", t + 61, 15),
            ev("gpu_memcpy", FETCH, t + 70, 2)]


def served(tmp_path, per_unit: int) -> dict:
    """Two units of 200 us, ``per_unit`` requests each, and one blocking
    upload outside the units."""
    events = []
    for u in (0, 200):
        events.append(ev("user_annotation", trace.UNIT, u, 200))
        for r in range(per_unit):
            events += request(u + 100 * r)
        events.append(ev("kernel", KERNEL, u + 30, 20))
    events += [ev("user_annotation", "mmpfn.sync.upload", 500, 5), ev("gpu_memcpy", PAGEABLE_UP, 501, 2)]
    return write(tmp_path, events, units=2, rows=[460] * (2 * per_unit))


def test_union_of_intervals():
    spans = [{"ts": 0, "dur": 10}, {"ts": 5, "dur": 10}, {"ts": 20, "dur": 2}, {"ts": 1, "dur": 2}]
    assert program.union_us(spans) == 17
    assert program.union_us([]) == 0


@pytest.mark.parametrize("name,waits", [(PAGEABLE_UP, True), (PINNED_UP, False), (FETCH, True),
                                        (READ, True), ("Memcpy DtoD (Device -> Device)", False)])
def test_host_waits_are_the_blocking_copies(name, waits):
    assert program.host_wait({"name": name}) is waits


@pytest.mark.parametrize("cell,per_unit", [("serve", 1), ("stream", 2)])
def test_served_readers(tmp_path, cell, per_unit):
    rec = record(served(tmp_path, per_unit))
    # 2 + 10 + 3 + 3 us of preprocessing a request
    assert read(f"host_preprocess_ms.{cell}", rec) == pytest.approx(0.018)
    # a blocking upload and a fetch a request; the pinned upload does not
    # block, and the copy outside the units is not counted
    assert read(f"host_syncs.{cell}", rec) == pytest.approx(2.0)


def test_train_readers(tmp_path):
    events = []
    for u in (0, 100):
        events += [ev("user_annotation", trace.UNIT, u, 100),
                   ev("user_annotation", "mmpfn.train.step", u, 60),
                   ev("user_annotation", "mmpfn.train.batch", u + 1, 5),
                   # the device busy 10-40 and 55-75 of the iteration: 50 us
                   ev("kernel", KERNEL, u + 10, 20),
                   ev("kernel", KERNEL, u + 25, 15),
                   ev("kernel", KERNEL, u + 55, 20),
                   # two index uploads and two scalar reads block; a copy
                   # on the card does not
                   ev("gpu_memcpy", PAGEABLE_UP, u + 11, 1),
                   ev("gpu_memcpy", PAGEABLE_UP, u + 13, 1),
                   ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", u + 15, 1),
                   ev("gpu_memcpy", READ, u + 56, 1),
                   ev("gpu_memcpy", READ, u + 58, 1)]
    rec = record(write(tmp_path, events, units=2), metrics={"finetune_iter_ms": 0.08})
    assert read("host_syncs.train", rec) == pytest.approx(4.0)
    # an untraced iteration of 80 us less the card's 50
    assert read("step_idle_ms.train", rec) == pytest.approx(0.03)


def test_a_program_without_spans(tmp_path):
    """The preprocessing is read from the program's spans alone; the waits
    and the idle from the card, with or without them."""
    events = [ev("user_annotation", trace.UNIT, 0, 100), ev("user_annotation", trace.REQUEST, 0, 90),
              ev("cpu_op", "aten::copy_", 5, 10), ev("gpu_memcpy", PAGEABLE_UP, 6, 2),
              ev("kernel", KERNEL, 25, 15), ev("gpu_memcpy", FETCH, 80, 5)]
    rec = record(write(tmp_path, events, units=1, rows=[460]), metrics={"finetune_iter_ms": 0.1})
    for name in ("host_preprocess_ms.serve", "host_preprocess_ms.stream"):
        assert read(name, rec) is None, name
    for name in ("host_syncs.serve", "host_syncs.stream", "host_syncs.train"):
        assert read(name, rec) == pytest.approx(2.0), name
    assert read("step_idle_ms.train", rec) == pytest.approx(0.078)


def test_no_card_gives_nothing(tmp_path):
    """The card's readers read nothing from a host-only trace."""
    events = [ev("user_annotation", trace.UNIT, 0, 100), ev("user_annotation", "mmpfn.predict.dispatch", 1, 90),
              ev("user_annotation", "mmpfn.sync.fetch", 50, 10)]
    rec = record(write(tmp_path, events, units=1, rows=[460]), metrics={"finetune_iter_ms": 0.1})
    for name in ("host_syncs.serve", "host_syncs.stream", "host_syncs.train", "step_idle_ms.train"):
        assert read(name, rec) is None, name
