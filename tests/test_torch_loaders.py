"""The port's data path against the JAX package's, on the CPU: the six dataset
loaders (`datasets/loaders.py`: ``x``, ``y``, the encoders' categories and
the embedding caches, from CSVs and images written here), PAD-UFES from
files to ``predict_proba`` through a tiny DINOv2, scikit-learn 1.9.0's two
encoders against the loaders' numpy ones, and the checkpoint downloader
(`models/download.py`, as `tests/test_download.py` holds the JAX one). No
test opens a connection: every download injects both transports or stubs the
defaults to fail.
"""

import math
import urllib.error
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalpfn_tpu.datasets import loaders as jloaders
from multimodalpfn_tpu.modal import dinov2 as jdinov2
from multimodalpfn_tpu_torch.datasets import loaders
from multimodalpfn_tpu_torch.modal import dinov2
from multimodalpfn_tpu_torch.models import download as dl

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

IMG = 56
BOOL_CATS = ["smoke", "drink", "pesticide", "skin_cancer_history", "cancer_history",
             "has_piped_water", "has_sewage_system", "itch", "grew", "hurt", "bleed",
             "elevation", "biopsed", "changed"]


def _png(path: Path, seed: int, size: int = 24) -> None:
    arr = np.random.default_rng(seed).integers(0, 255, size=(size, size, 3), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def _pad_ufes(root: Path, n: int = 24, missing: bool = True) -> Path:
    """PAD-UFES-20's metadata (bool columns with missing answers, as the
    published CSV has) and an image per row."""
    rng = np.random.default_rng(0)
    df = pd.DataFrame({c: rng.integers(0, 2, n).astype(bool) for c in BOOL_CATS})
    if missing:
        df["smoke"] = df["smoke"].astype(object)
        df.loc[[2, 5], "smoke"] = np.nan
    df["background_father"] = rng.choice(["POMERANIA", "GERMANY", "BRAZIL"], n)
    df["background_mother"] = rng.choice(["POMERANIA", "ITALY"], n)
    df["gender"] = rng.choice(["MALE", "FEMALE"], n)
    df["region"] = rng.choice(["ARM", "FACE", "HAND"], n)
    df["age"] = rng.integers(20, 80, n)
    df["diameter_1"] = rng.uniform(2, 12, n).round(1)
    df["diameter_2"] = rng.uniform(2, 12, n).round(1)
    df["diagnostic"] = rng.choice(["BCC", "MEL", "NEV"], n)
    df["img_id"] = [f"PAT_{i}.png" for i in range(n)]
    root.mkdir(parents=True)
    df.to_csv(root / "metadata.csv", index=False)
    for i in range(n):
        _png(root / "imgs" / f"PAT_{i}.png", seed=i)
    return root


def _cbis(root: Path, kind: str) -> Path:
    """CBIS-DDSM: DICOM-style paths in the CSV, jpegs under jpeg/<uid>/; case 3's
    cropped image is missing."""
    rng = np.random.default_rng(1)
    cats = (["mass shape", "mass margins"] if kind == "mass" else ["calc type", "calc distribution"])
    density = "breast_density" if kind == "mass" else "breast density"
    rows = []
    for i in range(10):
        uids = [f"uid_full_{i}", f"uid_crop_{i}", f"uid_roi_{i}"]
        rows.append({
            "left or right breast": rng.choice(["LEFT", "RIGHT"]),
            "image view": rng.choice(["CC", "MLO"]),
            "abnormality id": int(rng.integers(1, 3)),
            cats[0]: rng.choice(["OVAL", "ROUND", "LOBULATED"]),
            cats[1]: rng.choice(["CIRCUMSCRIBED", "SPICULATED"]),
            density: int(rng.integers(1, 5)),
            "assessment": int(rng.integers(0, 6)),
            "subtlety": int(rng.integers(1, 6)),
            "pathology": rng.choice(["MALIGNANT", "BENIGN", "BENIGN_WITHOUT_CALLBACK"]),
            "image file path": f"Mass/{uids[0]}/000000.dcm",
            "cropped image file path": f"Mass/{uids[1]}/000001.dcm",
            "ROI mask file path": f"Mass/{uids[2]}/000002.dcm",
        })
        for j, uid in enumerate(uids):
            if not (i == 3 and j == 1):
                _png(root / "jpeg" / uid / "1.jpg", seed=i * 3 + j)
    root.mkdir(parents=True, exist_ok=True)
    pd.DataFrame(rows).to_csv(root / f"{kind}_case.csv", index=False)
    return root


def _cloth(root: Path, n: int = 25) -> Path:
    rng = np.random.default_rng(2)
    df = pd.DataFrame({
        "Division Name": rng.choice(["General", "Petite", None], n),
        "Department Name": rng.choice(["Tops", "Dresses"], n),
        "Class Name": rng.choice(["Blouses", "Knits"], n),
        "Age": rng.integers(18, 80, n),
        "Positive Feedback Count": rng.integers(0, 10, n),
        "Title": ["Nice" if i % 2 else None for i in range(n)],
        "Review Text": [f"review {i}" for i in range(n)],
        "Rating": rng.integers(1, 6, n),
    })
    root.mkdir(parents=True)
    df.to_csv(root / "reviews.csv", index=False)
    return root


AIRBNB_CATS = [
    "host_location", "host_since_year", "host_is_superhost", "host_neighborhood",
    "host_has_profile_pic", "host_identity_verified", "neighborhood", "city", "smart_location",
    "suburb", "state", "is_location_exact", "property_type", "room_type", "bed_type",
    "instant_bookable", "cancellation_policy", "require_guest_profile_picture",
    "require_guest_phone_verification", "host_response_time", "calendar_updated",
    "host_verifications", "last_review_year",
]
AIRBNB_NUMS = [
    "host_response_rate", "latitude", "longitude", "accommodates", "bathrooms", "bedrooms", "beds",
    "security_deposit", "cleaning_fee", "guests_included", "extra_people", "minimum_nights",
    "maximum_nights", "availability_30", "availability_60", "availability_90", "availability_365",
    "number_of_reviews", "review_scores_rating", "review_scores_accuracy",
    "review_scores_cleanliness", "review_scores_checkin", "review_scores_communication",
    "review_scores_location", "review_scores_value", "calculated_host_listings_count",
    "reviews_per_month",
]


def _airbnb(root: Path, n: int = 40) -> Path:
    """Listings with missing categories (strings and years) and prices, so that
    the deciles drop rows."""
    rng = np.random.default_rng(3)
    df = pd.DataFrame({c: rng.choice(["a", "b", "c", None], n) for c in AIRBNB_CATS})
    df["host_since_year"] = rng.choice([2010.0, 2012.0, np.nan], n)
    df["host_is_superhost"] = rng.choice(["t", "f"], n)
    for c in AIRBNB_NUMS:
        df[c] = rng.normal(size=n).round(3)
    df.loc[[1, 7], "beds"] = np.nan
    df["price"] = rng.integers(20, 400, n).astype(float)
    df.loc[[4, 9], "price"] = np.nan
    df["name"] = [f"flat {i}" for i in range(n)]
    df["summary"] = [None if i % 3 else "sunny" for i in range(n)]
    df["description"] = ["quiet"] * n
    root.mkdir(parents=True)
    df.to_csv(root / "listings.csv", index=False)
    return root


def _salary(root: Path, n: int = 30) -> Path:
    """The raw salary CSV: ``experience`` and ``salary`` strings, no ``Y``."""
    rng = np.random.default_rng(4)
    df = pd.DataFrame({
        "location": rng.choice(["Delhi", "Mumbai", "Pune"], n),
        "company_name_encoded": rng.integers(0, 6, n),
        "job_type": rng.choice(["full", None], n),
        "experience": [f"{int(a)}-{int(a) + 3} yrs" for a in rng.integers(0, 9, n)],
        "salary": rng.choice(["0to3", "3to6", "6to10", "10to15"], n),
        "job_description": [f"job {i}" for i in range(n)],
        "job_desig": rng.choice(["dev", "ops", None], n),
        "key_skills": ["python"] * n,
    })
    root.mkdir(parents=True)
    df.to_csv(root / "Final_dataset.csv", index=False)
    return root


def _petfinder(root: Path, n: int = 20) -> Path:
    """Pets with images for all but pet 5 (dropped, as the reference keeps
    pets with a first image)."""
    rng = np.random.default_rng(5)
    cats = ["Breed1", "Breed2", "Color1", "Color2", "Color3", "Dewormed", "FurLength", "Gender",
            "Health", "MaturitySize", "State", "Sterilized", "Type", "Vaccinated"]
    df = pd.DataFrame({c: rng.integers(0, 4, n) for c in cats})
    for c in ["Age", "VideoAmt", "Quantity", "PhotoAmt", "Fee"]:
        df[c] = rng.integers(0, 10, n)
    df["PetID"] = [f"pet{i}" for i in range(n)]
    df["Description"] = [None if i % 4 == 0 else f"a pet {i}" for i in range(n)]
    df["AdoptionSpeed"] = rng.integers(0, 5, n)
    (root / "train").mkdir(parents=True)
    df.to_csv(root / "train" / "train.csv", index=False)
    for i in range(n):
        if i != 5:
            _png(root / "train_images" / f"pet{i}-1.jpg", seed=100 + i)
    _png(root / "train_images" / "pet5-2.jpg", seed=99)
    return root


def _build(name: str, tmp_path: Path):
    """(port dataset, JAX dataset) of one loader on the same files."""
    emb = dict(embeddings_root=str(tmp_path / "emb"))
    if name == "pad_ufes_20":
        root = _pad_ufes(tmp_path / "pad")
        args = (str(root),)
    elif name.startswith("cbis_ddsm"):
        kind = name.split("_")[-1]
        root = _cbis(tmp_path / "cbis", kind)
        args = (str(root), f"{kind}_case.csv", kind, "all")
    elif name == "cloth":
        args = (str(_cloth(tmp_path / "cloth")), "reviews.csv")
    elif name == "airbnb":
        args = (str(_airbnb(tmp_path / "airbnb")),)
    elif name == "salary":
        args = (str(_salary(tmp_path / "salary")),)
    else:
        args = (str(_petfinder(tmp_path / "pf")),)
    key = name.split("_mass")[0].split("_calc")[0]
    return loaders.DATASETS[key](*args, **emb), jloaders.DATASETS[key](*args, **emb)


def _items(a) -> list:
    """An array's entries with NaN made comparable, and each one's type."""
    return [("nan", float) if isinstance(v, float) and math.isnan(v) else (v, type(v)) for v in a]


def _same_categories(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _items(g) == _items(w)


DATASET_NAMES = ["pad_ufes_20", "cbis_ddsm_mass", "cbis_ddsm_calc", "cloth", "airbnb", "salary",
                 "petfinder"]


@pytest.mark.parametrize("name", DATASET_NAMES)
def test_loader_matches_jax(name, tmp_path):
    ds, jds = _build(name, tmp_path)
    assert ds.cat_features == jds.cat_features and ds.num_features == jds.num_features
    assert ds.x.dtype == jds.x.dtype and ds.y.dtype == jds.y.dtype
    np.testing.assert_array_equal(ds.x, jds.x)
    np.testing.assert_array_equal(ds.y, jds.y)
    _same_categories(ds.encoder.categories_, jds.encoder.categories_)
    _same_categories([ds.target_encoder.classes_], [jds.target_encoder.classes_])
    if hasattr(jds, "text"):
        assert list(ds.text) == list(jds.text)
    assert ds._cache_path() == jds._cache_path()
    if ds.image_features:  # the same images, and the same rows dropped with a missing file
        np.testing.assert_array_equal(ds.get_images(IMG), jds.get_images(IMG))
        np.testing.assert_array_equal(ds.x, jds.x)
        np.testing.assert_array_equal(ds.y, jds.y)


@pytest.mark.parametrize("name", ["pad_ufes_20", "cbis_ddsm_mass", "cloth", "petfinder"])
def test_embedding_caches_match_jax(name, tmp_path):
    """The reference's ``.pt`` cache and each package's ``.npz`` read alike by
    both; a cache hit needs no device (the default is "cuda")."""
    ds, jds = _build(name, tmp_path)
    n = len(ds)
    cache = ds._cache_path("all" if name == "petfinder" else "")
    cache.parent.mkdir(parents=True, exist_ok=True)
    pt = torch.from_numpy(np.random.default_rng(6).normal(size=(n, 1, 8)).astype(np.float32))
    torch.save(pt, cache.with_suffix(".pt"))
    np.testing.assert_array_equal(ds.get_embeddings(), pt.numpy())
    np.testing.assert_array_equal(jds.get_embeddings(), pt.numpy())
    for save, load in ((loaders._save_cache, jloaders._load_cache),
                       (jloaders._save_cache, loaders._load_cache)):
        emb = np.random.default_rng(7).normal(size=(n, 2, 8)).astype(np.float32)
        save(cache, emb)
        got = load(cache)
        assert got.dtype == emb.dtype
        np.testing.assert_array_equal(got, emb)
    x, image, y = ds[3]
    assert image.shape == (1, 8) and x.shape == jds[3][0].shape


def test_encoders_match_scikit_learn():
    """scikit-learn 1.9.0's ``OrdinalEncoder()`` and ``LabelEncoder`` on bool,
    string (with missing values), integer and float columns."""
    sk = pytest.importorskip("sklearn.preprocessing")
    rng = np.random.default_rng(8)
    df = pd.DataFrame({
        "b": rng.integers(0, 2, 30).astype(bool),
        "bn": pd.Series(rng.integers(0, 2, 30).astype(bool), dtype=object),
        "s": rng.choice(["x", "yy", "a"], 30),
        "sn": rng.choice(["x", "yy", None], 30),
        "i": rng.integers(-3, 3, 30),
        "f": rng.choice([0.5, -1.0, np.nan], 30),
    })
    df.loc[3, "bn"] = np.nan
    got_enc, want_enc = loaders.OrdinalEncoder(), sk.OrdinalEncoder()
    got, want = got_enc.fit_transform(df), want_enc.fit_transform(df)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    _same_categories(got_enc.categories_, want_enc.categories_)
    for y in (df["s"], df["i"], df["b"]):
        got_le, want_le = loaders.LabelEncoder(), sk.LabelEncoder()
        got_y, want_y = got_le.fit_transform(y), want_le.fit_transform(y)
        assert got_y.dtype == want_y.dtype
        np.testing.assert_array_equal(got_y, want_y)
        _same_categories([got_le.classes_], [want_le.classes_])
    with pytest.raises(TypeError, match="uniformly strings or numbers"):
        loaders.OrdinalEncoder().fit_transform(pd.DataFrame({"m": ["a", 1, "b"]}))


# --- PAD-UFES from files to predict_proba ------------------------------------


def _tiny_vit(monkeypatch, tmp_path):
    """A 48-wide float32 ViT (depth 2) in place of the published weights, in
    both packages: their loaders look for the weight file, then load it."""
    jcfg = jdinov2.ViTConfig(embed_dim=48, depth=2, num_heads=4, mlp_ratio=2,
                             compute_dtype="float32")
    tree = jax.device_get(jdinov2.init_vit_params(jax.random.PRNGKey(0), jcfg))
    cfg = dinov2.ViTConfig(embed_dim=48, depth=2, num_heads=4, mlp_ratio=2, compute_dtype="float32")
    params = dinov2.vit_params_from_jax(tree)
    monkeypatch.chdir(tmp_path)
    loaders.DINOV2_WEIGHTS.parent.mkdir()
    loaders.DINOV2_WEIGHTS.write_bytes(b"")
    monkeypatch.setattr(jdinov2, "load_dinov2_vitb14", lambda path: (jax.tree.map(jnp.asarray, tree), jcfg))
    monkeypatch.setattr(dinov2, "load_dinov2_vitb14",
                        lambda path, device: (dinov2.params_from_jax(tree, device), cfg))
    return params, cfg


def test_pad_ufes_files_to_predict_proba_match_jax(tmp_path, monkeypatch):
    from multimodalpfn_tpu import MMPFNClassifier as JMMPFNClassifier
    from multimodalpfn_tpu.models import params as jparams
    from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
    from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
    from multimodalpfn_tpu.models.loading import save_model as jsave_model
    from multimodalpfn_tpu.preprocess.ensemble import PreprocessorConfig as JPreprocessorConfig
    from multimodalpfn_tpu_torch import MMPFNClassifier
    from multimodalpfn_tpu_torch.models.loading import save_npz
    from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig

    _tiny_vit(monkeypatch, tmp_path)
    root = _pad_ufes(tmp_path / "pad", missing=False)
    ds = loaders.PADUFES20Dataset(str(root), embeddings_root=str(tmp_path / "emb"), device="cpu")
    jds = jloaders.PADUFES20Dataset(str(root), embeddings_root=str(tmp_path / "jemb"))
    ds.get_images(IMG), jds.get_images(IMG)
    emb, jemb = ds.get_embeddings(batch_size=8), jds.get_embeddings(batch_size=8)
    assert emb.shape == (24, 1, 48) and emb.dtype == np.float32
    err = np.abs(emb - jemb).max() / np.abs(jemb).max()
    assert err <= 5e-5, err
    # written to the cache, read back on the next load with no encoder
    again = loaders.PADUFES20Dataset(str(root), embeddings_root=str(tmp_path / "emb"))
    np.testing.assert_array_equal(again.get_embeddings(), emb)

    cfg = JModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=10,
                       mixer=JMixerConfig("MGM+CAP", mgm_heads=2, cap_heads=4, in_dim=48))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(jparams.init_params(jax.random.PRNGKey(0), cfg, model_seed=0)))
    jsave_model(tmp_path / "small.ckpt", tree, cfg)

    def kw(preproc_cls):
        return dict(mgm_heads=2, cap_heads=4, n_estimators=2, random_state=0, inference_config={
            "PREPROCESS_TRANSFORMS": [preproc_cls("none", categorical_name="numeric",
                                                  subsample_features=-1)]})

    ntr = 18
    jclf = JMMPFNClassifier(model_path=str(tmp_path / "small.ckpt"), **kw(JPreprocessorConfig))
    want = jclf.fit(jds.x[:ntr], jemb[:ntr], jds.y[:ntr]).predict_proba(jds.x[ntr:], jemb[ntr:])
    save_npz(tmp_path / "small.npz", jax.device_get(jclf.params_), jclf.config_)
    clf = MMPFNClassifier(model_path=str(tmp_path / "small.npz"), device="cpu", **kw(PreprocessorConfig))
    got = clf.fit(ds.x[:ntr], emb[:ntr], ds.y[:ntr]).predict_proba(ds.x[ntr:], emb[ntr:])
    assert got.shape == want.shape == (6, len(np.unique(ds.y[:ntr])))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_loaders_refuse_a_missing_card(tmp_path, monkeypatch):
    """The default device is the card: without one, generating embeddings
    raises (after finding the weights), and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.chdir(tmp_path)
    ds = loaders.PADUFES20Dataset(str(_pad_ufes(tmp_path / "pad")), embeddings_root=str(tmp_path / "e"))
    with pytest.raises(FileNotFoundError, match="dinov2_vitb14_pretrain.pth"):
        ds.get_embeddings()
    loaders.DINOV2_WEIGHTS.parent.mkdir()
    loaders.DINOV2_WEIGHTS.write_bytes(b"")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ds.get_embeddings()


# --- the checkpoint downloader ------------------------------------------------


def test_cache_dir_resolution(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert dl.user_cache_dir("linux") == tmp_path / "xdg" / "tabpfn"
    monkeypatch.delenv("XDG_CACHE_HOME")
    assert dl.user_cache_dir("linux") == Path.home() / ".cache" / "tabpfn"
    assert dl.user_cache_dir("darwin") == Path.home() / "Library" / "Caches" / "tabpfn"
    monkeypatch.setenv("APPDATA", str(tmp_path / "appdata"))
    assert dl.user_cache_dir("win32") == tmp_path / "appdata" / "tabpfn"
    assert dl.user_cache_dir("sunos5", appname="x") == (Path.cwd() / ".x_models").resolve()


def test_resolve_model_path_auto_and_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TABPFN_MODEL_CACHE_DIR", str(tmp_path))
    assert dl.resolve_model_path("auto", "classifier") == (
        tmp_path / "tabpfn-v2-classifier.ckpt", tmp_path, "tabpfn-v2-classifier.ckpt")
    assert dl.resolve_model_path(tmp_path / "x" / "my.ckpt", "regressor") == (
        tmp_path / "x" / "my.ckpt", tmp_path / "x", "my.ckpt")


def test_download_prefers_hf_hub(tmp_path):
    target = tmp_path / "m" / "tabpfn-v2-classifier.ckpt"
    calls = []

    def fake_hf(*, repo_id, filename, local_dir):
        calls.append((repo_id, filename))
        p = Path(local_dir) / "hub" / filename
        p.parent.mkdir()
        p.write_bytes(b"HF")
        return p

    def fail_url(url):
        raise AssertionError("direct URL used although HF succeeded")

    assert dl.download_model(target, which="classifier", hf_download=fake_hf, url_opener=fail_url) == "ok"
    assert target.read_bytes() == b"HF"
    assert calls == [("Prior-Labs/TabPFN-v2-clf", "tabpfn-v2-classifier.ckpt")]


def test_download_falls_back_to_direct_url(tmp_path):
    target = tmp_path / "tabpfn-v2-regressor.ckpt"
    urls = []

    def broken_hf(**kw):
        raise ImportError("no huggingface_hub")

    def fake_url(url):
        urls.append(url)
        return b"DIRECT"

    assert dl.download_model(target, which="regressor", hf_download=broken_hf, url_opener=fake_url) == "ok"
    assert target.read_bytes() == b"DIRECT"
    assert urls == ["https://huggingface.co/Prior-Labs/TabPFN-v2-reg/resolve/main/"
                    "tabpfn-v2-regressor.ckpt?download=true"]


def test_download_accumulates_errors_and_rejects_unknown_names(tmp_path):
    target = tmp_path / "tabpfn-v2-classifier.ckpt"

    def broken_hf(**kw):
        raise ImportError("no huggingface_hub")

    def broken_url(url):
        raise urllib.error.URLError("no egress")

    res = dl.download_model(target, which="classifier", hf_download=broken_hf, url_opener=broken_url)
    assert [type(e) for e in res] == [ImportError, urllib.error.URLError]
    assert not target.exists()
    res = dl.download_model(tmp_path / "x.ckpt", which="classifier", model_name="not-a-model.ckpt",
                            hf_download=broken_hf, url_opener=broken_url)
    assert isinstance(res, list) and isinstance(res[0], ValueError)
    with pytest.raises(ValueError, match="Unsupported model type"):
        dl.get_model_source("ranker")


def test_ensure_model_cached_disabled_and_failing(tmp_path, monkeypatch):
    monkeypatch.setenv("TABPFN_MODEL_CACHE_DIR", str(tmp_path))

    def explode(*a, **kw):
        raise AssertionError("download attempted")

    with pytest.raises(ValueError, match="downloading is disabled"):
        dl.ensure_model("auto", "classifier", download=False)
    with pytest.warns(UserWarning, match="Downloading model"), pytest.raises(RuntimeError) as info:
        dl.ensure_model("auto", "regressor", hf_download=lambda **kw: 1 / 0,
                        url_opener=lambda url: 1 / 0)
    assert isinstance(info.value.__cause__, ZeroDivisionError)
    ckpt = tmp_path / "tabpfn-v2-classifier.ckpt"
    ckpt.write_bytes(b"CACHED")
    assert dl.ensure_model("auto", "classifier", hf_download=explode, url_opener=explode) == ckpt


def _jax_ckpt(path: Path) -> None:
    from multimodalpfn_tpu.models import params as jparams
    from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
    from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
    from multimodalpfn_tpu.models.loading import save_model as jsave_model

    cfg = JModelConfig(emsize=24, nhead=2, nhid_factor=2, nlayers=1, n_out=10,
                       mixer=JMixerConfig(mixer_type="none"))
    jsave_model(path, jax.device_get(jparams.init_params(jax.random.PRNGKey(0), cfg, model_seed=0)), cfg)


def test_auto_downloads_a_missing_checkpoint(tmp_path, monkeypatch):
    """``model_path="auto"`` with the checkpoint nowhere: the hub transport
    fetches it into the cache dir, and the estimator layer loads it, the same
    weights as the JAX package loads from there."""
    from multimodalpfn_tpu.estimator.base import initialize_model as jinitialize_model
    from multimodalpfn_tpu_torch.estimator.base import initialize_model
    from multimodalpfn_tpu_torch.models import params as tparams

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TABPFN_MODEL_CACHE_DIR", str(tmp_path / "models"))
    fetched = []

    def fake_hf(*, repo_id, filename, local_dir):
        fetched.append(filename)
        _jax_ckpt(Path(local_dir) / filename)
        return Path(local_dir) / filename

    def no_url(url):
        raise AssertionError("direct URL used although HF succeeded")

    monkeypatch.setattr(dl, "_default_hf_download", fake_hf)
    monkeypatch.setattr(dl, "_default_url_opener", no_url)
    kw = dict(static_seed=0, mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1)
    with pytest.warns(UserWarning, match="Downloading model"):
        got = initialize_model(model_path="auto", device="cpu", **kw)
    assert fetched == ["tabpfn-v2-classifier.ckpt"]
    assert (tmp_path / "models" / "tabpfn-v2-classifier.ckpt").exists()
    want = jinitialize_model(model_path="auto", which="classifier", **kw)
    flat_got = tparams.flatten_params(tparams.params_to_numpy(got.params))
    flat_want = tparams.flatten_params(jax.device_get(want.params))
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k], err_msg=k)


def test_auto_download_failure_message(tmp_path, monkeypatch):
    from multimodalpfn_tpu_torch.estimator.base import initialize_model

    def broken(*a, **kw):
        raise urllib.error.URLError("no egress")

    monkeypatch.setattr(dl, "_default_hf_download", broken)
    monkeypatch.setattr(dl, "_default_url_opener", broken)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TABPFN_MODEL_CACHE_DIR", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="download failed") as info:
        initialize_model(model_path="auto", which="regressor", static_seed=0, mixer_type="none",
                         mgm_heads=2, cap_heads=2, features_per_group=1, device="cpu")
    assert "tabpfn-v2-regressor.ckpt" in str(info.value) and "random:<seed>" in str(info.value)
    assert isinstance(info.value.__cause__, RuntimeError)
