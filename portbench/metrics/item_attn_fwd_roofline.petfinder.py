"""K2a's share of its roofline in the PetFinder requests: the item
attention with its QKV projection at 35 token columns against 11,722 train
rows, every layer of every member of a request of the 2,930 held-out rows,
over the device time of K2a's launches (the served cells' kernel patterns,
`item_attn_fwd_roofline.serve.json`)."""

from pathlib import Path

from portbench.metrics.roofline import member_layers_s, share
from portbench.work.attention import item_attention_forward


def read(record: dict):
    shapes, arch = record["shapes"], record["config"]["architecture"]
    work = sum(member_layers_s(arch, shapes["members"], shapes["train_rows"], n, item_attention_forward)
               for n in record["trace"]["rows"])
    return share(record, str(Path(__file__).with_name("item_attn_fwd_roofline.serve.json")), work)
