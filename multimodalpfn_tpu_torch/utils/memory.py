"""Device-memory estimation and batch splitting.

The reference manages GPU peak memory by chunking flat-batch ops inside the
model (`mmpfn/models/mmpfn/model/memory.py:33-389`). Here the lever is the
ensemble-member batch: a closed-form activation estimate splits the members of
one width group into chunks that fit the device's free memory. The kernel path
never materializes item-attention scores (the item-attention kernel streams
K/V tiles); the plain path materializes ``(b, t, h, S, S)`` scores, so its
estimate carries them.
"""

from __future__ import annotations

import os
from typing import Iterator

import torch


def device_memory_bytes(device: torch.device | str) -> int:
    """Free memory of ``device``: ``torch.cuda.mem_get_info`` on a CUDA device,
    available physical memory on the host otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES"))


def estimate_forward_bytes(
    cfg,
    *,
    batch: int,
    seq_len: int,
    n_feature_tokens: int,
    kernels: bool,
    kv_len: int | None = None,
) -> int:
    """Closed-form activation estimate for one batched forward (the spirit of
    reference `memory.py:146-226`).

    Dominant terms per layer: the state (b, s, t, e), the MLP hidden
    (b, s, t, nhid) and, on the plain path only, the item-attention logits,
    their softmax and its compute-dtype copy, each (b, t, h, s, kv_len).
    ``kv_len`` is the key count (None: ``seq_len``): the train rows when the
    KV cache is primed (``seq_len`` train rows too) or read (``seq_len`` test
    rows).
    """
    t = n_feature_tokens + 1
    e, h, nhid = cfg.emsize, cfg.nhead, cfg.nhid
    kv_len = seq_len if kv_len is None else kv_len
    bytes_per = 2 if cfg.compute_dtype == "bfloat16" else 4
    state = batch * seq_len * t * e * bytes_per
    mlp_hidden = batch * seq_len * t * nhid * bytes_per
    attn_scores = 0 if kernels else 3 * batch * t * h * seq_len * kv_len * 4
    return int(3 * state + attn_scores + mlp_hidden)


def memory_budget(device: torch.device | str) -> int:
    """The bytes a forward may take: 80% of the device's free memory."""
    return int(device_memory_bytes(device) * 0.8)


def split_batch_for_memory(
    batch: int,
    cfg,
    *,
    seq_len: int,
    n_feature_tokens: int,
    device: torch.device | str,
    kernels: bool,
    kv_len: int | None = None,
    budget: int | None = None,
) -> Iterator[range]:
    """Yield batch ranges sized to fit the device memory budget
    (`memory_budget` unless ``budget`` is given)."""
    budget = budget if budget is not None else memory_budget(device)
    per_one = max(
        estimate_forward_bytes(
            cfg,
            batch=1,
            seq_len=seq_len,
            n_feature_tokens=n_feature_tokens,
            kernels=kernels,
            kv_len=kv_len,
        ),
        1,
    )
    chunk = max(1, min(batch, budget // per_one))
    for start in range(0, batch, chunk):
        yield range(start, min(start + chunk, batch))
