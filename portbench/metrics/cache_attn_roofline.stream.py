"""K4's share of its roofline in the cached predicts: the test rows'
attention against each member's cached train keys and values, every layer,
over the device time of K4's launches."""

from pathlib import Path

from portbench.metrics.roofline import member_layers_s, share
from portbench.work.attention import cached_attention


def read(record: dict):
    shapes, arch = record["shapes"], record["config"]["architecture"]
    work = sum(member_layers_s(arch, shapes["members"], shapes["train_rows"], n, cached_attention)
               for n in record["trace"]["rows"])
    return share(record, str(Path(__file__).with_suffix(".json")), work)
