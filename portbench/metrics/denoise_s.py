"""Seconds per image in the sampler (sample_latents or
sample_latents_sdxl) of an untraced batch."""


def read(facts):
    s = facts.get("spans", {}).get("sample")
    return None if s is None else s / facts["images"]
