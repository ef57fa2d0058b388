"""The sweep window's share of the card's bf16 peak: the operations of its
sweep steps, each every run's iteration (`work/forward.iteration_flops` at
the run's own MGM head count: the episode's forward, its backward, the
validation forward), over the window's wall time."""

from portbench.work.forward import iteration_flops
from portbench.work.peaks import BF16_FLOPS


def read(record: dict):
    if not record["trace"]["device"]:  # no card, no share of its peak
        return None
    win, arch, shapes = record["window"], record["config"]["architecture"], record["shapes"]
    step = sum(iteration_flops({**arch, "mixer": {**arch["mixer"], "mgm_heads": h}}, shapes)
               for h in shapes["mgm_heads"])
    return 100.0 * win["iterations"] * step / win["wall_s"] / BF16_FLOPS
