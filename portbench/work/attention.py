"""The work of the attention kernels' layers, from shapes: each input read
once and each output written once (bf16, lse float32), and the products
the layer needs (`forward.item_attention_flops`)."""

from __future__ import annotations

from portbench.work.forward import item_attention_flops, tokens

BF16, F32 = 2, 4


def item_attention_forward(arch: dict, features: int, sep: int, n: int) -> tuple[float, float]:
    """One layer's item attention with its QKV projection, one member
    (K2a's layer): reads x and W_qkv, writes o and the log-sum-exp."""
    e, h, t = arch["emsize"], arch["nhead"], tokens(arch, features)
    rows = t * (sep + n)
    nbytes = BF16 * (2 * rows * e + 3 * e * e) + F32 * rows * h
    return item_attention_flops(e, t, sep, n), nbytes


def item_attention_backward(arch: dict, features: int, sep: int, n: int) -> tuple[float, float]:
    """The attention part of one layer's item-attention backward, one
    member: dV, dP, dQ and dK of the train rows against the train rows
    (every head) and of the test rows against the train rows (the shared KV
    head). Reads q, k, v, do and the log-sum-exp, writes dq, dk, dv. The
    projection's products are not counted."""
    e, h, t = arch["emsize"], arch["nhead"], tokens(arch, features)
    flops = 8.0 * t * e * (sep * sep + n * sep)
    q_rows = t * (sep + n)
    kv_rows = t * sep
    nbytes = BF16 * (2 * q_rows * e + 2 * kv_rows * e + q_rows * e + 2 * kv_rows * e) + F32 * q_rows * h
    return flops, nbytes


def cached_attention(arch: dict, features: int, sep: int, n: int) -> tuple[float, float]:
    """One layer's attention of ``n`` test rows against a member's cached
    train keys and values (the shared KV head), one member: reads q and the
    cached k, v; writes o."""
    e, h, t = arch["emsize"], arch["nhead"], tokens(arch, features)
    d = e // h
    flops = 4.0 * t * e * n * sep
    nbytes = BF16 * (2 * t * n * e + 2 * t * sep * d)
    return flops, nbytes
