"""K2a's share of its roofline in the served requests: the item attention
with its QKV projection, every layer of every member of a request of the
held-out rows, over the device time of K2a's launches."""

from pathlib import Path

from portbench.metrics.roofline import member_layers_s, share
from portbench.work.attention import item_attention_forward


def read(record: dict):
    shapes, arch = record["shapes"], record["config"]["architecture"]
    work = sum(member_layers_s(arch, shapes["members"], shapes["train_rows"], n, item_attention_forward)
               for n in record["trace"]["rows"])
    return share(record, str(Path(__file__).with_suffix(".json")), work)
