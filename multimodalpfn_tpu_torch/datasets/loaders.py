"""The six reference dataset loaders (layer 0): the port of the JAX package's
`multimodalpfn_tpu/datasets/loaders.py`.

Contract parity with `mmpfn/datasets/*.py`: each dataset exposes ``.x (N, F)``,
``.y (N,)``, ``.cat_features`` (names), ``get_images()`` and
``get_embeddings()`` with the embeddings cached on disk
(``embeddings/<name>/<name>[_<type>]_dinov2.npz``; the reference's ``.pt``
caches are read too). Embeddings are generated by the port's DINOv2
(`modal/dinov2.py`) and ELECTRA (`modal/text.py`) on the dataset's
``device``, which is resolved only when an encoder runs: a cache hit needs
no card. pandas and PIL are imported where they are used, and scikit-learn's
two encoders are the numpy `OrdinalEncoder` and `LabelEncoder` below.
"""

from __future__ import annotations

import math
import numbers
import os
from pathlib import Path

import numpy as np
import torch

DINOV2_WEIGHTS = Path("parameters/dinov2_vitb14_pretrain.pth")


def _is_nan(v) -> bool:
    return isinstance(v, numbers.Real) and math.isnan(v)


def _unique(values: np.ndarray) -> np.ndarray:
    """scikit-learn's ``_unique`` (1.9.0): the sorted distinct values, None and
    then NaN last; an object column's values must sort against each other."""
    if values.dtype != object:
        return np.unique(values)
    present = {v for v in values if v is not None and not _is_nan(v)}
    try:
        uniq = sorted(present)
    except TypeError:
        types = sorted({type(v).__qualname__ for v in present})
        raise TypeError(
            f"Encoders require their input argument must be uniformly strings or numbers. Got {types}"
        ) from None
    uniq += [None] * any(v is None for v in values) + [np.nan] * any(_is_nan(v) for v in values)
    return np.array(uniq, dtype=object)


def _codes(values: np.ndarray, categories: np.ndarray) -> np.ndarray:
    """Each value's index among ``categories`` (NaN: the index of NaN)."""
    if values.dtype != object:
        return np.searchsorted(categories, values)
    index = {c: i for i, c in enumerate(categories) if not _is_nan(c)}
    nan_at = len(categories) - 1
    return np.array([nan_at if _is_nan(v) else index[v] for v in values], dtype=np.int64)


class OrdinalEncoder:
    """scikit-learn 1.9.0's ``OrdinalEncoder()`` with its defaults, on the
    columns of a DataFrame: a column's codes are the indices of its values
    among its sorted distinct values (``categories_``, NaN last), float64;
    missing values stay NaN."""

    def fit_transform(self, df) -> np.ndarray:
        cols = [df[c].to_numpy() for c in df.columns]
        self.categories_ = [_unique(v) for v in cols]
        out = np.empty((len(df), len(cols)), dtype=np.float64)
        for j, (v, cats) in enumerate(zip(cols, self.categories_)):
            out[:, j] = _codes(v, cats)
            if len(cats) and _is_nan(cats[-1]):
                out[out[:, j] == len(cats) - 1, j] = np.nan
        return out


class LabelEncoder:
    """scikit-learn 1.9.0's ``LabelEncoder``: ``classes_`` the sorted distinct
    labels, the codes their indices."""

    def fit_transform(self, y) -> np.ndarray:
        y = np.asarray(y)
        self.classes_ = _unique(y)
        return _codes(y, self.classes_)


def _load_cache(path: Path) -> np.ndarray | None:
    npz = path.with_suffix(".npz")
    if npz.exists():
        return np.load(npz)["embeddings"]
    pt = path.with_suffix(".pt")
    if pt.exists():  # the reference's torch cache
        return torch.load(pt, map_location="cpu", weights_only=True).numpy()
    return None


def _save_cache(path: Path, emb: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path.with_suffix(".npz"), embeddings=emb)


class TabularImageTextDataset:
    """Shared plumbing: ordinal-encode cats, label-encode target, embedding
    caches. ``device`` runs the encoders (without CUDA pass ``"cpu"``)."""

    name: str
    cat_features: list[str]
    num_features: list[str]
    target_col: str

    def __init__(self, data_path: str, embeddings_root: str = "embeddings",
                 device: str | torch.device = "cuda"):
        self.data_path = data_path
        self.embeddings_root = Path(embeddings_root)
        self.device = device

    def _encode(self, df) -> None:
        import pandas as pd

        self.df = df
        self.encoder = OrdinalEncoder()
        x_cat = self.encoder.fit_transform(df[self.cat_features])
        self.x = pd.concat(
            [pd.DataFrame(x_cat, columns=self.cat_features),
             df[self.num_features].reset_index(drop=True)],
            axis=1,
        ).values
        self.target_encoder = LabelEncoder()
        self.y = self.target_encoder.fit_transform(df[self.target_col])

    # --- images -------------------------------------------------------------
    image_features: list[str] = []

    def _image_path(self, rel: str) -> str:
        raise NotImplementedError

    def get_images(self, img_size: int = 14 * 24) -> np.ndarray:
        """(B, N, C, H, W) float in [0, 1]; the image size must be a multiple
        of 14 (reference `pad_ufes_20.py:41-63`)."""
        from PIL import Image

        images, drop = [], []
        for i, paths in self.df[self.image_features].reset_index(drop=True).iterrows():
            image_set, ok = [], True
            for rel in paths:
                p = self._image_path(rel)
                if not os.path.exists(p):
                    ok = False
                    drop.append(i)
                    continue
                with Image.open(p) as img:
                    img = img.convert("RGB")
                    image_set.append(np.array(img.resize((img_size, img_size), Image.BILINEAR),
                                              dtype=np.float32))
            if ok:
                images.append(image_set)
        if drop:  # re-align x/y when files are missing (reference `cbis_ddsm.py:60-78`)
            self.x = np.delete(self.x, drop, axis=0)
            self.y = np.delete(self.y, drop, axis=0)
        arr = np.stack(images, axis=0)  # (B, N, H, W, C)
        self.images = np.transpose(arr, (0, 1, 4, 2, 3)) / 255.0
        return self.images

    # --- embeddings ----------------------------------------------------------
    def _cache_path(self, tag: str = "") -> Path:
        stem = f"{self.name}{('_' + tag) if tag else ''}_dinov2"
        return self.embeddings_root / self.name / stem

    def _image_embeddings(self, batch_size: int = 16) -> np.ndarray:
        from multimodalpfn_tpu_torch.modal import dinov2

        if not DINOV2_WEIGHTS.exists():
            raise FileNotFoundError(
                f"DINOv2 weights not found at {DINOV2_WEIGHTS}; place the published "
                "dinov2_vitb14_pretrain.pth there or provide cached embeddings."
            )
        params, vit_cfg = dinov2.load_dinov2_vitb14(DINOV2_WEIGHTS, device=self.device)
        if not hasattr(self, "images"):
            self.get_images()
        return dinov2.embed_images(params, vit_cfg, self.images, batch_size=batch_size,
                                   device=self.device)

    def _text_embeddings(self, batch_size: int = 16) -> np.ndarray:
        from multimodalpfn_tpu_torch.modal.text import embed_texts

        return embed_texts(list(self.text), batch_size=batch_size, device=self.device)

    def get_embeddings(self, batch_size: int = 16) -> np.ndarray:
        cache = self._cache_path()
        emb = _load_cache(cache)
        if emb is None:
            emb = self._image_embeddings(batch_size)
            _save_cache(cache, emb)
        self.embeddings = emb
        return emb

    def __len__(self) -> int:
        return len(self.y)

    def __getitem__(self, idx):
        image = self.embeddings[idx] if hasattr(self, "embeddings") else None
        return self.x[idx], image, self.y[idx]


def _read_csv(*parts: str):
    import pandas as pd

    return pd.read_csv(os.path.join(*parts))


class PADUFES20Dataset(TabularImageTextDataset):
    """Skin lesions: 14 bool + 4 string cats, 3 numerics, 6-class target, a
    DINOv2 CLS token per image (reference `datasets/pad_ufes_20.py:17-118`)."""

    name = "pad_ufes_20"

    def __init__(self, data_path: str, **kw):
        super().__init__(data_path, **kw)
        df = _read_csv(data_path, "metadata.csv")
        self.bool_cats = [
            "smoke", "drink", "pesticide", "skin_cancer_history", "cancer_history",
            "has_piped_water", "has_sewage_system", "itch", "grew", "hurt",
            "bleed", "elevation", "biopsed", "changed",
        ]
        self.string_cats = ["background_father", "background_mother", "gender", "region"]
        self.num_features = ["age", "diameter_1", "diameter_2"]
        self.cat_features = self.bool_cats + self.string_cats
        self.target_col = "diagnostic"
        self.image_features = ["img_id"]
        self._encode(df)

    def _image_path(self, rel: str) -> str:
        return os.path.join(self.data_path, "imgs", rel)


class CBISDDSMDataset(TabularImageTextDataset):
    """Mammography mass/calc (reference `datasets/cbis_ddsm.py:17-138`);
    image_type 'all' yields 3 image tokens per case."""

    name = "cbis_ddsm"

    def __init__(self, data_path: str, data_name: str, kind: str, image_type: str, **kw):
        super().__init__(data_path, **kw)
        self.kind = kind
        self.image_type = image_type
        df = _read_csv(data_path, data_name)
        if kind == "mass":
            self.cat_features = [
                "left or right breast", "image view", "abnormality id",
                "mass shape", "mass margins",
            ]
            self.num_features = ["breast_density", "assessment", "subtlety"]
        elif kind == "calc":
            self.cat_features = [
                "left or right breast", "image view", "abnormality id",
                "calc type", "calc distribution",
            ]
            self.num_features = ["breast density", "assessment", "subtlety"]
        else:
            raise ValueError(f"kind must be mass|calc, got {kind}")
        self.image_features = {
            "full": ["image file path"],
            "crop": ["cropped image file path"],
            "ROI": ["ROI mask file path"],
            "all": ["image file path", "cropped image file path", "ROI mask file path"],
        }[image_type]
        self.target_col = "pathology"
        df[self.target_col] = df[self.target_col].replace("BENIGN_WITHOUT_CALLBACK", "BENIGN")
        self._encode(df)

    def _image_path(self, rel: str) -> str:
        # the CSVs point at DICOM paths; the jpegs live under jpeg/<series-uid>/
        d = os.path.join(self.data_path, "jpeg", rel.split("/")[-2])
        if os.path.isdir(d):
            files = os.listdir(d)
            if files:
                return os.path.join(d, files[0])
        return d

    def _cache_path(self, tag: str = "") -> Path:
        return self.embeddings_root / self.name / f"{self.name}_{self.kind}_{self.image_type}_dinov2"


class _TextDataset(TabularImageTextDataset):
    """Shared text-modality plumbing (ELECTRA CLS, reference `cloth.py:49-91`)."""

    def get_embeddings(self, batch_size: int = 16) -> np.ndarray:
        cache = self._cache_path()
        emb = _load_cache(cache)
        if emb is None:
            emb = self._text_embeddings(batch_size)
            _save_cache(cache, emb)
        self.embeddings = emb
        return emb


class ClothDataset(_TextDataset):
    """Clothing reviews: title + review text -> ELECTRA, 5-class rating
    (reference `datasets/cloth.py:18-102`)."""

    name = "cloth"

    def __init__(self, data_path: str, filename: str = "Womens Clothing E-Commerce Reviews.csv", **kw):
        super().__init__(data_path, **kw)
        df = _read_csv(data_path, filename)
        self.cat_features = ["Division Name", "Department Name", "Class Name"]
        self.num_features = ["Age", "Positive Feedback Count"]
        self.target_col = "Rating"
        df = df.dropna(subset=self.cat_features)
        text = (df["Title"].fillna("") + " " + df["Review Text"].fillna("")).astype(str)
        self.text = text.reset_index(drop=True)
        self._encode(df.reset_index(drop=True))


class AirbnbDataset(_TextDataset):
    """Airbnb listings: price decile-binned to 10 classes, name + summary +
    description text (reference `datasets/airbnb.py:18-113`)."""

    name = "airbnb"

    def __init__(self, data_path: str, filename: str = "listings.csv", **kw):
        import pandas as pd

        super().__init__(data_path, **kw)
        df = _read_csv(data_path, filename)
        self.cat_features = [
            "host_location", "host_since_year", "host_is_superhost",
            "host_neighborhood", "host_has_profile_pic", "host_identity_verified",
            "neighborhood", "city", "smart_location", "suburb", "state",
            "is_location_exact", "property_type", "room_type", "bed_type",
            "instant_bookable", "cancellation_policy",
            "require_guest_profile_picture", "require_guest_phone_verification",
            "host_response_time", "calendar_updated", "host_verifications",
            "last_review_year",
        ]
        self.num_features = [
            "host_response_rate", "latitude", "longitude", "accommodates",
            "bathrooms", "bedrooms", "beds", "security_deposit", "cleaning_fee",
            "guests_included", "extra_people", "minimum_nights", "maximum_nights",
            "availability_30", "availability_60", "availability_90",
            "availability_365", "number_of_reviews", "review_scores_rating",
            "review_scores_accuracy", "review_scores_cleanliness",
            "review_scores_checkin", "review_scores_communication",
            "review_scores_location", "review_scores_value",
            "calculated_host_listings_count", "reviews_per_month",
        ]
        self.target_col = "Y"
        df["Y"] = pd.qcut(df["price"], q=10, labels=False, duplicates="drop")
        text = (
            df["name"].fillna("") + " " + df["summary"].fillna("") + " "
            + df["description"].fillna("")
        ).astype(str)
        df = df.dropna(subset=["Y"])
        self.text = text.loc[df.index].reset_index(drop=True)
        self._encode(df.reset_index(drop=True))


class SalaryDataset(_TextDataset):
    """Job postings: salary buckets, description + designation + skills text
    (reference `datasets/salary.py:18-105`)."""

    name = "salary"

    def __init__(self, data_path: str, filename: str = "Final_dataset.csv", **kw):
        import pandas as pd

        super().__init__(data_path, **kw)
        df = _read_csv(data_path, filename)
        self.cat_features = ["location", "company_name_encoded", "job_type"]
        self.num_features = ["experience_int"]
        self.target_col = "Y"
        if "experience_int" not in df.columns and "experience" in df.columns:
            df["experience_int"] = (
                df["experience"].astype(str).str.extract(r"(\d+)").fillna(0).astype(int)
            )
        if "Y" not in df.columns and "salary" in df.columns:
            df["Y"] = LabelEncoder().fit_transform(df["salary"].astype(str))
        empty = pd.Series([""] * len(df))
        text = (
            df.get("job_description", empty).fillna("") + " "
            + df.get("job_desig", empty).fillna("") + " "
            + df.get("key_skills", empty).fillna("")
        ).astype(str)
        df[self.cat_features] = df[self.cat_features].astype(str)
        df["experience_int"] = df["experience_int"].astype(int)
        self.text = text.reset_index(drop=True)
        self._encode(df.reset_index(drop=True))


class PetfinderDataset(TabularImageTextDataset):
    """Pet adoption: the first image per pet (DINOv2) and/or the description
    text (ELECTRA), `multimodal_type` in {'image', 'text', 'all'} (reference
    `datasets/petfinder.py:21-209`); 'all' concatenates tokens -> (B, 2, 768)."""

    name = "petfinder"

    def __init__(self, data_path: str = "data/petfinder_adoption", **kw):
        super().__init__(data_path, **kw)
        df = _read_csv(data_path, "train/train.csv")
        df["PetID"] = df["PetID"].astype(str)
        img_dir = os.path.join(data_path, "train_images")
        if os.path.isdir(img_dir):
            files = [f for f in os.listdir(img_dir) if f.endswith(".jpg")]
            first = {f.split("-")[0] for f in files if f.split("-")[1].split(".")[0] == "1"}
            df = df[df["PetID"].isin(first)]
        df["ImagePath"] = df["PetID"] + "-1.jpg"
        self.cat_features = [
            "Breed1", "Breed2", "Color1", "Color2", "Color3", "Dewormed",
            "FurLength", "Gender", "Health", "MaturitySize", "State",
            "Sterilized", "Type", "Vaccinated",
        ]
        all_feats = self.cat_features + ["Age", "VideoAmt", "Quantity", "PhotoAmt", "Fee"]
        self.num_features = [c for c in all_feats if c not in self.cat_features]
        self.target_col = "AdoptionSpeed"
        self.image_features = ["ImagePath"]
        self.text = df["Description"].fillna("").astype(str).reset_index(drop=True)
        self._encode(df.reset_index(drop=True))

    def _image_path(self, rel: str) -> str:
        return os.path.join(self.data_path, "train_images", rel)

    def get_embeddings(self, batch_size: int = 16, multimodal_type: str = "all") -> np.ndarray:
        cache = self._cache_path(multimodal_type)
        emb = _load_cache(cache)
        if emb is None:
            parts = []
            if multimodal_type in ("image", "all"):
                parts.append(self._image_embeddings(batch_size))
            if multimodal_type in ("text", "all"):
                parts.append(self._text_embeddings(batch_size))
            emb = np.concatenate(parts, axis=1)  # token-axis concat -> (B, n_mod, 768)
            _save_cache(cache, emb)
        self.embeddings = emb
        return emb

    def _cache_path(self, tag: str = "") -> Path:
        return self.embeddings_root / self.name / f"{self.name}_{tag or 'all'}_dinov2"


DATASETS = {
    "pad_ufes_20": PADUFES20Dataset,
    "cbis_ddsm": CBISDDSMDataset,
    "petfinder": PetfinderDataset,
    "cloth": ClothDataset,
    "airbnb": AirbnbDataset,
    "salary": SalaryDataset,
}
