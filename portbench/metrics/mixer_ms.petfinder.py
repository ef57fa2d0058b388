"""The mixer's device time in a PetFinder request: the kernels and copies
launched inside the program's ``mmpfn.forward.mixer`` spans (MGM over two
embeddings a row, CAP's 24 queries, float32), summed a traced request, the
median over the traced requests, ms. A program without the span gives
nothing."""

import statistics

from portbench import span_device


def read(record: dict):
    tr = record["trace"]
    per = span_device.per_unit_ms(tr, span_device.MIXER)
    if not tr["device"] or not per:
        return None
    return statistics.median(per)
