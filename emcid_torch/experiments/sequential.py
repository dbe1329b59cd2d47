"""Sequential editing (reference experiments/sequential_editing.py:27-186):
apply a chain of edits one after another, each round editing the
already-edited pipeline, generating validation images between rounds.

Counterpart of ``emcid_tpu/experiments/sequential.py``: an edit returns
new components (a new text encoder), so each round's pipeline is kept
beside the others; z caches are reused between rounds through the
``cache_name`` codec."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

from emcid_torch.models.pipeline import SDComponents, generate


def sequential_editing(
    components: SDComponents,
    edit_rounds: Sequence[Sequence[Dict]],
    hparams,
    val_prompts: Sequence[str],
    save_dir,
    mom2_weight=None,
    edit_weight=None,
    sample_num: int = 10,
    cache_name: Optional[str] = None,
    gen_kwargs: Optional[dict] = None,
    apply_kwargs: Optional[dict] = None,
    verbose: bool = True,
) -> List[SDComponents]:
    """Run the rounds; saves images as ``{prompt}_{stage}-seed{seed}.png``
    (stage = "pre" or "round{i}"), skipping images already on disk.
    Returns the pipeline after each round (element 0 = original)."""
    from PIL import Image

    from emcid_torch.engine.editor import apply_emcid

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    gk = gen_kwargs or {}

    def snap(comps, stage):
        jobs = [
            (p, s, save_dir / f"{p}_{stage}-seed{s}.png")
            for p in val_prompts for s in range(sample_num)
            if not (save_dir / f"{p}_{stage}-seed{s}.png").exists()
        ]
        if jobs:
            imgs = generate(comps, [j[0] for j in jobs],
                            [j[1] for j in jobs], **gk)
            for (_, _, path), img in zip(jobs, imgs):
                Image.fromarray(img).save(path)

    snap(components, "pre")
    history = [components]
    current = components
    for i, requests in enumerate(edit_rounds):
        current, _ = apply_emcid(
            current, list(requests), hparams,
            mom2_weight=mom2_weight, edit_weight=edit_weight,
            cache_name=cache_name, verbose=verbose, **(apply_kwargs or {}),
        )
        snap(current, f"round{i}")
        history.append(current)
    return history
