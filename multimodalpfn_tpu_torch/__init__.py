"""multimodalpfn_tpu_torch — the PyTorch/CUDA port of multimodalpfn_tpu.

The TabPFN-v2 dual-axis in-context transformer with multimodal mixers
(MGM / CAP / MoE) and sklearn-style estimators (classifier and regressor),
running on PyTorch. On a CUDA device the encoder layer runs hand-written Hopper kernels (``csrc/``, built
with ``nvcc`` at first use); on the CPU the same functions run as plain
PyTorch. The JAX package ``multimodalpfn_tpu`` is the reference this package
is tested against; this package never imports it, nor jax.
"""

__version__ = "0.1.0"

from multimodalpfn_tpu_torch.estimator.classifier import MMPFNClassifier, TabPFNClassifier
from multimodalpfn_tpu_torch.estimator.regressor import MMPFNRegressor, TabPFNRegressor
from multimodalpfn_tpu_torch.models.config import MixerConfig, ModelConfig
from multimodalpfn_tpu_torch.models.loading import load_model, save_model

__all__ = [
    "MMPFNClassifier",
    "TabPFNClassifier",
    "MMPFNRegressor",
    "TabPFNRegressor",
    "ModelConfig",
    "MixerConfig",
    "load_model",
    "save_model",
]
