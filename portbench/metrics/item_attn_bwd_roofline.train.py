"""K9's share of its roofline in the fine-tune: the attention backward of
the episode's item attention (dq and dk/dv passes), every layer, over the
device time of those passes. K9's projection products run on the product
tile, whose profiler name K7, K8 and K10 share, and are not counted."""

from pathlib import Path

from portbench.metrics.roofline import member_layers_s, share
from portbench.work.attention import item_attention_backward


def read(record: dict):
    s, arch = record["shapes"], record["config"]["architecture"]
    per_step = member_layers_s(arch, [s["features"]], s["episode_train"], s["episode_test"],
                               item_attention_backward)
    return share(record, str(Path(__file__).with_suffix(".json")), record["trace"]["units"] * per_step)
