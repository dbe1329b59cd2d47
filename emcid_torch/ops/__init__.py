"""Attention and the fused GroupNorm/LayerNorm (hand-written CUDA kernels with plain PyTorch versions) and the closed-form solve."""

from emcid_torch.ops.solve import solve_adj_k, upd_matrix_match_shape
