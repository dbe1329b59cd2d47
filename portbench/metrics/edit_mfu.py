"""The whole edit block's share of the bf16 peak: the UNet FLOPs of the
training images (CFG batch over the guided steps), the pool and the Stage-1
steps, over the block's wall time.  Text encoder, VAE and Stage 2 are left
out of the FLOPs."""

from portbench.metrics._read import mfu


def read(facts):
    if facts.get("kind") != "edit":
        return None
    return mfu(facts.get("flops", {}).get("edit"), facts.get("block_s"))
