"""What the readers of the program's phases share. The port names its
spans ``mmpfn.<layer>.<what>`` (`multimodalpfn_tpu_torch/utils/profiling.py`);
`trace.parse` files them under ``host`` with the host's operators, and a
program without them gives `preprocess_ms` nothing to read. The host's
waits and the fine-tune's idle are read from the card's own events, so
they do not rest on the spans."""

import statistics

from portbench import trace

PREFIX = "mmpfn."
PREPROCESS = PREFIX + "preprocess."
DISPATCH = PREFIX + "predict.dispatch"


def named(tr: dict, name: str) -> list[dict]:
    return [h for h in tr["host"] if h["name"] == name]


def inside(ev: dict, outer: dict) -> bool:
    return outer["ts"] <= ev["ts"] and ev["ts"] + ev["dur"] <= outer["ts"] + outer["dur"]


def union_us(evs: list[dict]) -> float:
    """The length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for ev in sorted(evs, key=lambda e: e["ts"]):
        a, b = ev["ts"], ev["ts"] + ev["dur"]
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def preprocess_ms(record: dict):
    """The median over the traced requests (each ``mmpfn.predict.dispatch``
    span) of the union of the request's ``mmpfn.preprocess.*`` spans, ms."""
    tr = record["trace"]
    prep = [h for h in tr["host"] if h["name"].startswith(PREPROCESS)]
    per = [union_us([p for p in prep if inside(p, d)]) / 1e3 for d in named(tr, DISPATCH)]
    return statistics.median(per) if per else None


def host_wait(ev: dict) -> bool:
    """A copy on the card that the host waits for: every copy to the host
    (a fetch, a scalar read), and every copy from pageable host memory (an
    upload without pinning). The program's uploads from pinned memory do
    not block, and are left out."""
    name = ev["name"]
    return name.startswith("Memcpy DtoH") or (name.startswith("Memcpy HtoD") and "Pageable" in name)


def waits_in_units(tr: dict) -> int:
    """The card's copies that the host waits for, inside the traced units.
    They are counted on the card, apart from the program's
    ``mmpfn.sync.*`` spans, which name each site."""
    units = trace.spans(tr, trace.UNIT)
    return sum(1 for ev in tr["device"] if host_wait(ev) and any(inside(ev, u) for u in units))


def syncs_per_request(record: dict):
    """The host waits in the traced units over the requests the units hold;
    nothing without a card."""
    tr = record["trace"]
    if not tr["device"]:
        return None
    return waits_in_units(tr) / len(tr["rows"])


def syncs_per_iteration(record: dict):
    """The host waits in the traced iterations, per iteration; nothing
    without a card."""
    tr = record["trace"]
    if not tr["device"]:
        return None
    return waits_in_units(tr) / tr["units"]


def step_idle_ms(record: dict):
    """The card's idle time in an untraced fine-tune iteration: the
    window's iteration time less the card's busy time an iteration of the
    traced slice, ms. The profiler slows the host and not the card, so the
    traced slice gives the card's time and the untraced window the host's;
    nothing without a card."""
    tr = record["trace"]
    if not tr["device"] or not tr["units"]:
        return None
    return record["window"]["metrics"]["finetune_iter_ms"] - trace.busy_us(tr) / 1e3 / tr["units"]
