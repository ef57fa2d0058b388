"""Operations of the MMPFN forward, counted from shapes: 2·M·N·K for every
product the configuration needs, at each member's own token count, with no
padding, merging or recompute (the reference's work)."""

from __future__ import annotations


def dims(arch: dict) -> tuple[int, int, int]:
    e = arch["emsize"]
    return e, e * arch["nhid_factor"], arch["nlayers"]


def tokens(arch: dict, features: int) -> int:
    """A member's tokens: its feature groups, the mixer's tokens, the target."""
    fpg = arch["features_per_group"]
    return -(-features // fpg) + arch["mixer"]["cap_heads"] + 1


def item_attention_flops(e: int, t: int, sep: int, n: int) -> float:
    """One layer's item attention over ``t`` token columns: q, k, v of the
    train rows and q of the ``n`` test rows, the train rows' scores and
    weighted values against the train rows (every head), the test rows'
    against the train rows (the shared KV head). The out-projection is the
    epilogue's."""
    return 2.0 * t * e * e * (3 * sep + n) + 4.0 * t * e * (sep * sep + n * sep)


def layer_flops(arch: dict, t: int, sep: int, n: int, cached: bool) -> float:
    """One encoder layer of one member over ``sep`` train and ``n`` test
    rows; ``cached``: the train rows' keys and values come from the cache
    and only the test rows run."""
    e, nhid, _ = dims(arch)
    rows = n if cached else sep + n
    feat = 8.0 * rows * t * e * e + 4.0 * rows * t * t * e
    if cached:
        item = 2.0 * n * t * e * e + 4.0 * t * e * n * sep
    else:
        item = item_attention_flops(e, t, sep, n)
    item += 2.0 * rows * t * e * e  # out-projection
    mlp = 4.0 * rows * t * e * nhid
    return feat + item + mlp


def mixer_flops(arch: dict, rows: int, image_tokens: int) -> float:
    """MGM+CAP over ``rows`` rows' embeddings (the members share it)."""
    e = arch["emsize"]
    mix = arch["mixer"]
    H, C, din = mix["mgm_heads"], mix["cap_heads"], mix["in_dim"]
    m = H * image_tokens  # MGM's tokens, CAP's keys
    mgm = 2.0 * rows * image_tokens * H * (din * din + (din // 2) * e)
    cap = rows * (2.0 * m * e * 2 * e + 4.0 * C * m * e + 2.0 * C * e * e + 8.0 * C * e * e)
    return mgm + cap + 4.0 * C * e * e  # the learned queries, once


def member_flops(arch: dict, features: int, sep: int, n: int, cached: bool = False) -> float:
    """One member's forward without the mixer: its encoders, layers and decoder."""
    e, nhid, L = dims(arch)
    t = tokens(arch, features)
    rows = n if cached else sep + n
    enc = 2.0 * rows * features * 2 * e + 2.0 * rows * 2 * e + 2.0 * (t - 1) * (e // 4) * e
    dec = 2.0 * n * e * nhid + 2.0 * n * nhid * arch["n_out"]
    return enc + L * layer_flops(arch, t, sep, n, cached) + dec


def request_flops(arch: dict, shapes: dict, n: int) -> float:
    """A served request of ``n`` rows: every member, and the mixer once
    (over the train and test rows, or the test rows against the cache)."""
    sep, cached = shapes["train_rows"], shapes["cached"]
    rows = n if cached else sep + n
    return (sum(member_flops(arch, f, sep, n, cached) for f in shapes["members"])
            + mixer_flops(arch, rows, shapes["image_tokens"]))


def iteration_flops(arch: dict, shapes: dict) -> float:
    """A fine-tune iteration: the episode's forward and its backward (twice
    the forward's products), then the validation forward."""
    f, img = shapes["features"], shapes["image_tokens"]
    sep, n = shapes["episode_train"], shapes["episode_test"]
    step = member_flops(arch, f, sep, n) + mixer_flops(arch, sep + n, img)
    vsep, vn = shapes["val_train"], shapes["val_test"]
    val = member_flops(arch, f, vsep, vn) + mixer_flops(arch, vsep + vn, img)
    return 3.0 * step + val
