"""Text embedding (ELECTRA-base CLS embeddings, layer 0): the port of the JAX
package's `multimodalpfn_tpu/modal/text.py`.

The reference embeds text with the CLS token of HF
``google/electra-base-discriminator`` (`mmpfn/datasets/cloth.py:57-88`,
`datasets/petfinder.py:152-188`), cached to disk; the classifier only ever
reads the cached embeddings. Tokenization stays on the HF tokenizer; the
encoder runs as the port's ELECTRA (`modal/electra.py`). The tokenizer and
the checkpoint are read from the local HF cache only: nothing is downloaded.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodalpfn_tpu_torch.estimator.base import resolve_device

ELECTRA_MODEL = "google/electra-base-discriminator"


def embed_texts(
    texts: list[str],
    *,
    model_name: str = ELECTRA_MODEL,
    max_length: int = 512,
    batch_size: int = 16,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Texts -> ``(B, 1, hidden)`` CLS embeddings (offline cache generation)
    on ``device`` (without CUDA pass ``device="cpu"``).

    Tokenizes with the HF tokenizer, converts the checkpoint once and runs the
    port's ELECTRA forward. Raises a clear error when the model is not
    available locally."""
    device = resolve_device(device)
    try:
        from transformers import AutoModel, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        hf = AutoModel.from_pretrained(model_name, local_files_only=True).eval()
    except (ImportError, OSError) as e:  # transformers or the model is not on this machine
        raise RuntimeError(
            f"Text encoder {model_name!r} unavailable (offline?). Precompute "
            f"embeddings elsewhere and place them in the dataset's embeddings/ "
            f"cache (see datasets/loaders.py cache contract)."
        ) from e

    from multimodalpfn_tpu_torch.modal.electra import (
        ElectraConfig,
        cls_embeddings,
        convert_hf_state_dict,
    )

    hc = hf.config
    cfg = ElectraConfig(
        vocab_size=hc.vocab_size,
        hidden=hc.hidden_size,
        layers=hc.num_hidden_layers,
        heads=hc.num_attention_heads,
        intermediate=hc.intermediate_size,
        max_position=hc.max_position_embeddings,
        type_vocab=hc.type_vocab_size,
        embedding_size=hc.embedding_size,
    )
    params = convert_hf_state_dict(hf.state_dict(), cfg)
    toks = tokenizer(
        [str(t) for t in texts],
        truncation=True,
        padding="max_length",
        max_length=max_length,
        return_tensors="np",
    )
    return cls_embeddings(
        params, cfg, toks["input_ids"], toks["attention_mask"], batch_size=batch_size, device=device
    )
