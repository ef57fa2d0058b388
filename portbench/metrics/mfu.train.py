"""The fine-tune window's share of the card's bf16 peak: the operations of
its iterations (`work/forward.py`: the episode's forward, its backward,
the validation forward) over the window's wall time."""

from portbench.work.forward import iteration_flops
from portbench.work.peaks import BF16_FLOPS


def read(record: dict):
    if not record["trace"]["device"]:  # no card, no share of its peak
        return None
    win, arch = record["window"], record["config"]["architecture"]
    flops = win["iterations"] * iteration_flops(arch, record["shapes"])
    return 100.0 * flops / win["wall_s"] / BF16_FLOPS
