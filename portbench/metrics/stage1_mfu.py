"""Stage 1's share of the bf16 peak: per step run, the edited UNet forward
and its backward into the input (two forwards' worth), plus the K pool
forwards of eps_dest once, at the latent the block trains on, over the
Stage-1 seconds of the block."""

from portbench.metrics._read import mfu, phase_per_block


def read(facts):
    return mfu(facts.get("flops", {}).get("stage1"),
               phase_per_block(facts, "stage1"))
