"""The MMDiT's analytic forward FLOP count (``transformer`` group of an SD3
configuration): useful work, two FLOPs a multiply-add.  Counted: the
patch embedding, the context embedder, every block's modulation, q/k/v
and output projections of both streams, the joint attention's scores and
weighted sum over image + text tokens, the dual blocks' image-only
attention, both MLPs, the output norm's modulation and projection, and
the timestep and pooled-text MLPs.  Norms, activations, the sin-cos
features and elementwise work are left out."""

from __future__ import annotations

from typing import Dict


def _lin(n: float, cin: int, cout: int) -> float:
    return 2.0 * n * cin * cout


def mmdit_fwd_flops(cfg: Dict, batch: int, latent_hw: int,
                    context_len: int) -> float:
    """FLOPs of one forward over ``batch`` latents of side ``latent_hw``
    with ``context_len`` text tokens."""
    D = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    p, L = cfg["patch_size"], cfg["num_layers"]
    dual = set(cfg.get("dual_attention_layers") or ())
    N = (latent_hw // p) ** 2
    T = N + context_len
    f = (_lin(N, cfg["in_channels"] * p * p, D)
         + _lin(context_len, cfg["joint_attention_dim"], D)
         + _lin(1, 256, D) + _lin(1, D, D)
         + _lin(1, cfg["pooled_projection_dim"], D) + _lin(1, D, D))
    for i in range(L):
        last = i == L - 1
        f += _lin(1, D, (9 if i in dual else 6) * D)
        f += _lin(1, D, (2 if last else 6) * D)
        # image stream: q, k, v, out, MLP (4x up and down)
        f += _lin(N, D, 3 * D) + _lin(N, D, D) + 2 * _lin(N, D, 4 * D)
        # text stream: q, k, v; out and MLP unless the last block
        f += _lin(context_len, D, 3 * D)
        if not last:
            f += _lin(context_len, D, D) + 2 * _lin(context_len, D, 4 * D)
        f += 2.0 * 2.0 * T * T * D  # Q K^T and P V
        if i in dual:
            f += _lin(N, D, 4 * D) + 2.0 * 2.0 * N * N * D
    f += _lin(1, D, 2 * D) + _lin(N, D, p * p * cfg["out_channels"])
    return f * batch
