"""What the kernel roofline readers share: the share of a kernel's device
time that its layer's least time (`work/peaks.py:bound_s`) takes. The
kernel's launches are found by the profiler names in the reader's data
file, and their count is held against the program's launch counter
(`trace.kernel_us`)."""

import json
from pathlib import Path

from portbench import trace
from portbench.work.peaks import bound_s


def share(record: dict, data_file: str, work_s: float):
    """``work_s``: the least time of all the traced units' work."""
    spec = json.loads(Path(data_file).read_text())
    tr = record["trace"]
    if not tr["device"] or not tr["launch_counts"].get(spec["kernel"]):
        return None
    return 100.0 * work_s / (trace.kernel_us(tr, spec) / 1e6)


def member_layers_s(arch: dict, members, sep: int, n: int, work_fn) -> float:
    return arch["nlayers"] * sum(bound_s(*work_fn(arch, f, sep, n)) for f in members)
