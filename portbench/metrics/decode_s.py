"""Seconds per image in the VAE decode (decode_latents) of an untraced
batch."""


def read(facts):
    s = facts.get("spans", {}).get("decode")
    return None if s is None else s / facts["images"]
