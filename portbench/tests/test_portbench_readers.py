"""Each per-layer reader on a small synthetic profiler trace, written as a
Chrome trace and read back as a run reads it; a trace that holds fewer of a
kernel's launches than the program counted is refused."""

from __future__ import annotations

import json

import pytest

from portbench import bench, trace
from portbench.tests.conftest import ROOT
from portbench.work import attention
from portbench.work.peaks import bound_s

ARCH = bench.load_json(ROOT / "portbench/configs/mmpfn-clf-mgmcap16x8.json")["architecture"]
K2A = "void attn::fwd_wg_kernel<32, (anonymous namespace)::ItemFwdGeo<32> >(attn::Maps)"
PROJ = "void gemm::wgmma_kernel<false, true, gemm::Store<__nv_bfloat16> >(gemm::Maps)"
OTHER = "void at::native::elementwise_kernel<128, 2>()"


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


def chrome(tmp_path, kernels_per_unit=(K2A, PROJ)):
    """Two units of 100 us, each a request: the host works 20 us, launches
    at 20 and 30, the card runs the unit's kernels from 25 to 65 (15 us of
    K2a's attention, 10 of its projection) and a copy at 70-80."""
    events = []
    for u in (0, 100):
        events += [ev("user_annotation", trace.UNIT, u, 100),
                   ev("user_annotation", trace.REQUEST, u, 90),
                   ev("cpu_op", "aten::copy_", u + 5, 10),
                   ev("cuda_runtime", "cudaLaunchKernel", u + 20, 2),
                   ev("cuda_runtime", "cudaLaunchKernel", u + 30, 2)]
        t = u + 25
        for name in kernels_per_unit:
            dur = 15 if name == K2A else 10
            events.append(ev("kernel", name, t, dur))
            t += dur
        events.append(ev("kernel", OTHER, u + 50, 15))
        events.append(ev("gpu_memcpy", "Memcpy DtoH", u + 70, 10))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = trace.parse(path)
    out.update(launch_counts={"K2a": 2, "K4": 0, "K9": 0}, units=2, rows=[460, 460])
    return out


def record(tr, **window):
    shapes = {"members": [39, 39, 22, 22], "image_tokens": 1, "train_rows": 1838, "cached": False}
    return {"config": {"architecture": ARCH}, "traffic": {}, "shapes": shapes,
            "window": {"wall_s": 1.0, "rows": [460], "iterations": 1, **window}, "trace": tr}


def read(name, rec):
    return bench.load_module(bench.HERE / "metrics" / f"{name}.py").read(rec)


def test_parse_sorts_events(tmp_path):
    tr = chrome(tmp_path)
    assert [len(tr[k]) for k in ("device", "launches", "spans", "host")] == [8, 4, 4, 2]
    assert trace.window_of(tr) == (0.0, 200.0)


def test_busy_time(tmp_path):
    # busy 25-65 and 70-80 of each 100 us: the result line's busy_s
    assert trace.busy_us(chrome(tmp_path)) == pytest.approx(100.0)


def test_host_lead(tmp_path):
    assert read("host_lead_ms.serve", record(chrome(tmp_path))) == pytest.approx(0.020)


def test_roofline_and_short_trace(tmp_path):
    rec = record(chrome(tmp_path))
    work = 2 * ARCH["nlayers"] * sum(bound_s(*attention.item_attention_forward(ARCH, f, 1838, 460))
                                     for f in (39, 39, 22, 22))
    # two units, 25 us of K2a a unit
    assert read("item_attn_fwd_roofline.serve", rec) == pytest.approx(100.0 * work / 50e-6)
    short = record(chrome(tmp_path, kernels_per_unit=(K2A,)))
    with pytest.raises(trace.ShortTrace):
        read("item_attn_fwd_roofline.serve", short)
    # no launches of the kernel in the slice: nothing to read
    assert read("cache_attn_roofline.stream", rec) is None


def test_mfu_needs_a_card(tmp_path):
    rec = record(chrome(tmp_path))
    from portbench.work.forward import request_flops
    from portbench.work.peaks import BF16_FLOPS

    assert read("mfu.serve", rec) == pytest.approx(100.0 * request_flops(ARCH, rec["shapes"], 460) / BF16_FLOPS)
    rec["trace"]["device"] = []
    assert read("mfu.serve", rec) is None


def test_breakdown(tmp_path):
    out = trace.breakdown(chrome(tmp_path))
    assert out["device_ops"][0] == [K2A, pytest.approx(30e-6)]
    gaps = dict(out["idle_gaps"])
    # 0-25 (the copy_ op covers 5-15, so its middle 12.5 lies in it), 65-70,
    # 80-125 (the request span), 165-170, 180-200 (the unit span)
    assert gaps["aten::copy_"] == pytest.approx(25e-6)
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10
