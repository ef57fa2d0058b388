"""The port's modality encoders against the JAX package's, in float32 on the
CPU: DINOv2 (`modal/dinov2.py`: `forward_features`, `interpolate_pos_embed`,
`embed_images`, `load_dinov2_vitb14`), ELECTRA (`modal/electra.py`: `forward`,
`convert_hf_state_dict`, `cls_embeddings`) and `modal/text.py:embed_texts`,
on the same weights (the JAX init carried over, or a random HF model) and the
same inputs from a numpy seed. No test downloads anything: the HF model and
tokenizer are built here and handed to ``from_pretrained`` by monkeypatch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalpfn_tpu.modal import dinov2 as jdinov2
from multimodalpfn_tpu.modal import electra as jelectra
from multimodalpfn_tpu_torch.modal import dinov2, electra

# float32 forwards of the same weights whose op orders differ: 5e-5 of the
# largest output
F32_REL = 5e-5
# the bf16 port against the float32 port (not parity: the JAX package cannot
# run bf16, its scan refuses the float32 carry its blocks return): eight bits
# of mantissa through two blocks, 2**-5 of the largest output
BF16_REL = 2.0**-5

TINY = dict(patch_size=14, embed_dim=48, depth=2, num_heads=4, mlp_ratio=2, pos_embed_size=37,
            compute_dtype="float32")


def _close(got, want, rel=F32_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, f"relative error {err:.3e} > {rel:.1e}"


@pytest.fixture(scope="module")
def tiny_vit():
    """The JAX package's random init, with every bias and norm moved off its
    constant so that each leaf is exercised, and the same weights in the
    port."""
    jcfg = jdinov2.ViTConfig(**TINY)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(jdinov2.init_vit_params(jax.random.PRNGKey(0), jcfg)),
    )
    return tree, jcfg, dinov2.vit_params_from_jax(tree), dinov2.ViTConfig(**TINY)


def _images(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, size=shape).astype(np.float32)


@pytest.mark.parametrize("px", [56, 84])
def test_forward_features_matches_jax(tiny_vit, px):
    tree, jcfg, params, cfg = tiny_vit
    imgs = _images(px, 3, 3, px, px)
    want = jdinov2.forward_features(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(imgs))
    got = dinov2.forward_features(params, cfg, torch.from_numpy(imgs))
    for key in ("x_norm_clstoken", "x_norm_patchtokens"):
        assert got[key].dtype == torch.float32
        _close(got[key].numpy(), want[key])
    assert got["x_norm_patchtokens"].shape == (3, (px // 14) ** 2, 48)


@pytest.mark.parametrize("grid", [4, 6, 24, 37, 40])
def test_interpolate_pos_embed_matches_jax(tiny_vit, grid):
    """Bicubic with antialiasing, as ``jax.image.resize`` computes it: without
    ``antialias=True`` the shrunk grids (4, 6, 24) are far off."""
    tree, _, params, _ = tiny_vit
    want = np.asarray(jdinov2.interpolate_pos_embed(jnp.asarray(tree["pos_embed"]), grid, 37))
    got = dinov2.interpolate_pos_embed(params["pos_embed"], grid, 37).numpy()
    assert got.shape == (1, grid * grid + 1, 48)
    if grid == 37:
        np.testing.assert_array_equal(got, tree["pos_embed"])
    _close(got, want, rel=1e-5)


def test_embed_images_batching_and_jax(tiny_vit):
    tree, jcfg, params, cfg = tiny_vit
    imgs = _images(1, 5, 2, 3, 56, 56)
    got4 = dinov2.embed_images(params, cfg, imgs, batch_size=4, device="cpu")
    got16 = dinov2.embed_images(params, cfg, imgs, batch_size=16, device="cpu")
    assert got4.shape == (5, 2, 48) and got4.dtype == np.float32
    _close(got4, got16, rel=1e-6)
    want = jdinov2.embed_images(jax.tree.map(jnp.asarray, tree), jcfg, imgs, batch_size=4)
    _close(got4, want)


def test_bf16_port_stays_near_float32_port(tiny_vit):
    """The bf16 stream (tokens rounded once at entry, float32 residual after)
    runs and stays within bf16's reach of the float32 port."""
    _, _, params, cfg = tiny_vit
    imgs = _images(2, 4, 1, 3, 56, 56)
    f32 = dinov2.embed_images(params, cfg, imgs, device="cpu")
    bf16 = dinov2.embed_images(params, dataclasses.replace(cfg, compute_dtype="bfloat16"), imgs,
                               device="cpu")
    assert bf16.dtype == np.float32 and np.isfinite(bf16).all()
    _close(bf16, f32, rel=BF16_REL)
    assert not np.array_equal(bf16, f32)  # the products did round


def test_load_dinov2_vitb14_matches_jax(tmp_path):
    """A random ViT-B/14 state dict in the published key names, loaded by
    both packages and run at 28 px in float32."""
    D, L, hid = 768, 12, 3072
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy((0.02 * rng.standard_normal(shape)).astype(np.float32))

    sd = {"cls_token": t(1, 1, D), "pos_embed": t(1, 37 * 37 + 1, D), "mask_token": t(1, D),
          "patch_embed.proj.weight": t(D, 3, 14, 14), "patch_embed.proj.bias": t(D),
          "norm.weight": 1 + t(D), "norm.bias": t(D)}
    for i in range(L):
        p = f"blocks.{i}."
        sd |= {p + "norm1.weight": 1 + t(D), p + "norm1.bias": t(D),
               p + "attn.qkv.weight": t(3 * D, D), p + "attn.qkv.bias": t(3 * D),
               p + "attn.proj.weight": t(D, D), p + "attn.proj.bias": t(D),
               p + "ls1.gamma": 1 + t(D), p + "ls2.gamma": 1 + t(D),
               p + "norm2.weight": 1 + t(D), p + "norm2.bias": t(D),
               p + "mlp.fc1.weight": t(hid, D), p + "mlp.fc1.bias": t(hid),
               p + "mlp.fc2.weight": t(D, hid), p + "mlp.fc2.bias": t(D)}
    path = tmp_path / "dinov2_vitb14_pretrain.pth"
    torch.save(sd, path)

    params, cfg = dinov2.load_dinov2_vitb14(path, device="cpu")
    jparams, jcfg = jdinov2.load_dinov2_vitb14(path)
    assert cfg == dinov2.ViTConfig() and cfg.compute_dtype == "bfloat16"
    flat = {f"blocks/{k}": v for k, v in params["blocks"].items()} | {
        k: v for k, v in params.items() if k != "blocks"}
    jflat = {f"blocks/{k}": v for k, v in jparams["blocks"].items()} | {
        k: v for k, v in jparams.items() if k != "blocks"}
    assert flat.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_array_equal(flat[k].numpy(), np.asarray(jflat[k]), err_msg=k)

    imgs = _images(4, 2, 3, 28, 28)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    want = jdinov2.forward_features(jparams, dataclasses.replace(jcfg, compute_dtype="float32"),
                                    jnp.asarray(imgs))["x_norm_clstoken"]
    got = dinov2.forward_features(params, cfg32, torch.from_numpy(imgs))["x_norm_clstoken"]
    _close(got.numpy(), want)


# --- ELECTRA -----------------------------------------------------------------


def _hf_electra(seed, **kw):
    tfs = pytest.importorskip("transformers")
    hf_cfg = tfs.ElectraConfig(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                               type_vocab_size=2, **kw)
    torch.manual_seed(seed)
    return tfs.ElectraModel(hf_cfg).eval()


SMALL_HF = dict(vocab_size=120, hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=40, embedding_size=32)


def _cfg(hf):
    hc = hf.config
    return electra.ElectraConfig(
        vocab_size=hc.vocab_size, hidden=hc.hidden_size, layers=hc.num_hidden_layers,
        heads=hc.num_attention_heads, intermediate=hc.intermediate_size,
        max_position=hc.max_position_embeddings, type_vocab=hc.type_vocab_size,
        embedding_size=hc.embedding_size)


def _jcfg(cfg):
    return jelectra.ElectraConfig(**dataclasses.asdict(cfg))


def test_electra_forward_matches_jax_with_padding():
    hf = _hf_electra(0, **SMALL_HF)
    cfg = _cfg(hf)
    sd = {("electra." + k if i % 2 else k): v for i, (k, v) in enumerate(hf.state_dict().items())}
    params = electra.convert_hf_state_dict(sd, cfg)  # keys with and without the prefix
    jparams = jelectra.convert_hf_state_dict(hf.state_dict(), _jcfg(cfg))
    for k, v in params["layers"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams["layers"][k]), err_msg=k)

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 120, size=(3, 17)).astype(np.int64)
    mask = np.ones((3, 17), np.int64)
    mask[1, 12:] = 0
    want = np.asarray(jelectra.forward(jparams, _jcfg(cfg), jnp.asarray(ids, jnp.int32),
                                       jnp.asarray(mask, jnp.int32)))
    got = electra.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    _close(got.numpy()[1, :12], ref.last_hidden_state.numpy()[1, :12])

    # the CLS contract (B, 1, hidden), batched with a ragged tail
    emb = electra.cls_embeddings(params, cfg, ids, mask, batch_size=2, device="cpu")
    jemb = jelectra.cls_embeddings(jparams, _jcfg(cfg), ids, mask, batch_size=2)
    assert emb.shape == (3, 1, 32) and emb.dtype == np.float32
    _close(emb, jemb)
    _close(emb[:, 0], got.numpy()[:, 0], rel=1e-6)


def test_electra_small_projection_matches_jax():
    """embedding_size != hidden: the embeddings_project path."""
    hf = _hf_electra(1, vocab_size=90, hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=96, max_position_embeddings=24, embedding_size=16)
    cfg = _cfg(hf)
    params = electra.convert_hf_state_dict(hf.state_dict(), cfg)
    assert params["emb_proj_w"].shape == (16, 48)
    jparams = jelectra.convert_hf_state_dict(hf.state_dict(), _jcfg(cfg))
    ids = np.random.default_rng(1).integers(0, 90, size=(2, 9)).astype(np.int64)
    want = np.asarray(jelectra.forward(jparams, _jcfg(cfg), jnp.asarray(ids, jnp.int32)))
    _close(electra.forward(params, cfg, torch.from_numpy(ids)).numpy(), want)


def test_electra_params_from_jax_and_bf16():
    """The JAX init carried over gives the JAX forward; the bf16 port runs
    with its float32 residual stream and stays near the float32 port."""
    jcfg = jelectra.ElectraConfig(vocab_size=50, hidden=32, layers=2, heads=4, intermediate=64,
                                  max_position=20, embedding_size=16)
    cfg = electra.ElectraConfig(**dataclasses.asdict(jcfg))
    tree = jax.device_get(jelectra.init_params(jax.random.PRNGKey(2), jcfg))
    params = electra.electra_params_from_jax(tree)
    ids = np.random.default_rng(2).integers(0, 50, size=(4, 11)).astype(np.int64)
    mask = (np.arange(11)[None] < np.array([[11], [7], [3], [9]])).astype(np.int64)
    want = np.asarray(jelectra.forward(jax.tree.map(jnp.asarray, tree), jcfg,
                                       jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)))
    got = electra.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    _close(got, want)
    bf16 = electra.forward(params, dataclasses.replace(cfg, compute_dtype="bfloat16"),
                           torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.isfinite(bf16).all()
    _close(bf16, got, rel=BF16_REL)
    fresh = electra.init_params(torch.Generator().manual_seed(0), cfg)
    assert {k: v.shape for k, v in fresh["layers"].items()} == {
        k: tuple(v.shape) for k, v in params["layers"].items()}


def _vocab(tmp_path, size=120):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(size - 5)]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(words) + "\n")
    return path


def test_embed_texts_matches_jax(tmp_path, monkeypatch):
    """A tokenizer from a local vocab file and a random HF model, handed to
    both packages' ``from_pretrained`` calls."""
    tfs = pytest.importorskip("transformers")
    from multimodalpfn_tpu.modal.text import embed_texts as jembed_texts
    from multimodalpfn_tpu_torch.modal.text import embed_texts

    tok = tfs.ElectraTokenizerFast(vocab_file=str(_vocab(tmp_path)))
    hf = _hf_electra(4, **SMALL_HF)
    asked = []

    def fake(obj):
        def load(name, **kw):
            asked.append((name, kw))
            return obj
        return load

    monkeypatch.setattr(tfs.AutoTokenizer, "from_pretrained", fake(tok))
    monkeypatch.setattr(tfs.AutoModel, "from_pretrained", fake(hf))
    texts = ["w1 w2 w3", "w7", "w9 w10 w11 w12 w13 w14 w15 w16 w17 w18 w19 w20 w21", "", "w4 w4"]
    got = embed_texts(texts, max_length=24, batch_size=2, device="cpu")
    assert asked[:2] == [("google/electra-base-discriminator", {"local_files_only": True})] * 2
    want = jembed_texts(texts, max_length=24, batch_size=2)
    assert got.shape == (5, 1, 32) and got.dtype == np.float32
    _close(got, want)


def test_embed_texts_raises_without_the_model(monkeypatch):
    tfs = pytest.importorskip("transformers")
    from multimodalpfn_tpu_torch.modal.text import embed_texts

    def missing(name, **kw):
        assert kw == {"local_files_only": True}
        raise OSError(f"{name} is not in the local cache")

    monkeypatch.setattr(tfs.AutoTokenizer, "from_pretrained", missing)
    with pytest.raises(RuntimeError, match="unavailable"):
        embed_texts(["a"], device="cpu")


def test_encoders_refuse_a_missing_card(tiny_vit):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from multimodalpfn_tpu_torch.modal.text import embed_texts

    _, _, params, cfg = tiny_vit
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dinov2.embed_images(params, cfg, _images(0, 1, 1, 3, 28, 28))
    ecfg = electra.ElectraConfig(vocab_size=10, hidden=8, layers=1, heads=2, intermediate=16,
                                 max_position=8, embedding_size=8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        electra.cls_embeddings(electra.init_params(torch.Generator(), ecfg), ecfg,
                               np.zeros((1, 4), np.int64))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        embed_texts(["a"])
