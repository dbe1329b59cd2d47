"""BLIP ITM scoring from a local checkpoint folder (reference
util/evaluate.py:189-248 uses HF ``BlipForImageTextRetrieval``).

Counterpart of ``load_native_blip_scorer`` and
``calculate_single_blip_score`` in ``emcid_tpu/evals/blip.py``.  The folder
is an HF ``Salesforce/blip-itm-*-coco`` layout: ``config.json``, the
weights (``.safetensors`` when that package imports, else ``.bin`` /
``.pt``) and ``vocab.txt``; the tokenizer is the port's own WordPiece
(``text/wordpiece.py``), so no ``transformers`` is needed.  The JAX
package's ``transformers`` seam ``BlipITMScorer`` has no counterpart: the
native scorer here is already torch.
"""

from __future__ import annotations

import json
from pathlib import Path

from emcid_torch.models.blip import NativeBlipScorer


def calculate_single_blip_score(scorer: NativeBlipScorer, img,
                                txt: str) -> float:
    return float(scorer.itm_score(img, [txt])[0])


def load_native_blip_scorer(checkpoint_dir, prefix: str = "A photo depicts ",
                            device=None) -> NativeBlipScorer:
    """``BlipITM`` in f32 on ``device`` (the card unless the caller asks
    otherwise) from a local HF checkpoint folder; the configs take the JAX
    package's defaults for keys ``config.json`` lacks."""
    import torch

    from emcid_torch.models.blip import (
        BlipITM, BlipTextConfig, BlipVisionConfig, blip_from_torch,
    )
    from emcid_torch.models.loader import _load_torch_state_dict
    from emcid_torch.runtime import resolve_device
    from emcid_torch.text.wordpiece import WordPieceTokenizer

    dev = resolve_device(device)
    ckpt = Path(checkpoint_dir)
    cfg = json.loads((ckpt / "config.json").read_text())
    tc, vc = cfg["text_config"], cfg["vision_config"]
    text_config = BlipTextConfig(
        vocab_size=tc.get("vocab_size", 30524),
        hidden_size=tc.get("hidden_size", 768),
        num_hidden_layers=tc.get("num_hidden_layers", 12),
        num_attention_heads=tc.get("num_attention_heads", 12),
        intermediate_size=tc.get("intermediate_size", 3072),
        max_position_embeddings=tc.get("max_position_embeddings", 512),
        encoder_hidden_size=tc.get("encoder_hidden_size", 768),
    )
    vision_config = BlipVisionConfig(
        hidden_size=vc.get("hidden_size", 768),
        num_hidden_layers=vc.get("num_hidden_layers", 12),
        num_attention_heads=vc.get("num_attention_heads", 12),
        intermediate_size=vc.get("intermediate_size", 3072),
        image_size=vc.get("image_size", 384),
        patch_size=vc.get("patch_size", 16),
    )
    # built without storage, then given the checkpoint's tensors
    with torch.device("meta"):
        model = BlipITM(vision_config, text_config)
    state = blip_from_torch(_load_torch_state_dict(ckpt), model)
    model.load_state_dict(state, strict=True, assign=True)
    model = model.to(dev).float().eval().requires_grad_(False)
    tokenizer = WordPieceTokenizer.from_pretrained_dir(
        ckpt, model_max_length=text_config.max_position_embeddings)
    return NativeBlipScorer(model, tokenizer, prefix=prefix)
