"""What the served cells' readers share: the window's share of the card's
bf16 peak, and the host's lead of a request."""

import statistics

from portbench import trace
from portbench.work.forward import request_flops
from portbench.work.peaks import BF16_FLOPS


def mfu(record: dict):
    """The operations the window's requests need (`work/forward.py`, at the
    reference's member widths) over the window's wall time, in % of the
    peak; nothing without a card."""
    if not record["trace"]["device"]:
        return None
    win, arch = record["window"], record["config"]["architecture"]
    flops = sum(request_flops(arch, record["shapes"], n) for n in win["rows"])
    return 100.0 * flops / win["wall_s"] / BF16_FLOPS


def host_lead_ms(record: dict):
    """The median over the traced requests of the time from the benchmark's
    span at the request's start to the request's first kernel launch (the
    profiler's runtime events), in ms."""
    tr = record["trace"]
    launches = [ev["ts"] for ev in tr["launches"]]
    leads = []
    for span in trace.spans(tr, trace.REQUEST):
        first = next((t for t in launches if span["ts"] <= t <= span["ts"] + span["dur"]), None)
        if first is not None:
            leads.append((first - span["ts"]) / 1e3)
    return statistics.median(leads) if leads else None
