"""The whole generation batch's share of the bf16 peak: UNet FLOPs of
every sampler evaluation at the CFG batch, over the batch's wall time
(sampler and decode).  The VAE's and text encoders' FLOPs are left out."""

from portbench.metrics._read import mfu


def read(facts):
    if facts.get("kind") != "gen":
        return None
    return mfu(facts.get("flops", {}).get("generate"), facts.get("batch_s"))
