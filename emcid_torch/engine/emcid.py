"""Stage 2: the one-pass multi-layer closed-form insert.

Counterpart of ``emcid_tpu/engine/emcid.py``.  For the j-th edited layer
(ascending):

    K   = fc2 inputs at the fact tokens, prompt-averaged      (in, N)
    cur = fc2 outputs at the fact tokens, prompt-averaged     (out, N)
    C  *= (1 - alpha) / 0.5;  K, (zs - cur) *= sqrt(alpha / 0.5)
    adj_k = solve(lam*C + K K^T, K)
    resid = (zs - cur) / (L - j)
    W_j  += resid @ adj_k^T

The request batch walks the layer stack once; at each edited layer the
running hidden state is patched with ``fc2_in @ upd^T`` (the edit's exact
effect on that layer's output), which reproduces a re-forward per edited
layer.  The walk runs under ``precise_matmuls``.  The caller's model is
not modified: the edit returns a copy with new fc2 weights, beside the
``deltas`` dict ``{"{rewrite_module}.weight": (adj_k (in, N), resid
(out, N))}`` of numpy factor pairs (the JAX package's and the reference's
delta format).
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.engine.extract import (
    RequestBatch,
    gather_at_tokens,
    per_request_mean,
    prepare_request_batch,
)
from emcid_torch.models.clip_text import causal_attention_mask
from emcid_torch.ops.solve import solve_adj_k, upd_matrix_match_shape
from emcid_torch.parallel.distributed import is_writer
from emcid_torch.runtime import precise_matmuls


def z_cache_path(cache_name: str, request: Dict, hparams=None,
                 idx: Optional[int] = None) -> Path:
    """Per-concept z cache path (reference emcid_main.py:871-907):
    ``{cache_name}source_{source}_dest_{dest}.npz`` with key "v_star"; the
    esd objective omits the dest; SLD-supervised requests key on
    ``source_{source_cat}_{idx}``."""
    if hparams is not None and "esd" in getattr(hparams, "objective", ""):
        return Path(f"{cache_name}source_{request['source']}.npz")
    if hparams is not None and getattr(hparams, "sld_supervision", False):
        return Path(f"{cache_name}source_{request['source_cat']}_{idx}.npz")
    return Path(
        f"{cache_name}source_{request['source']}_dest_{request['dest']}.npz")


def load_z_list(requests: Sequence[Dict], cache_name: Optional[str],
                hparams=None) -> Tuple[List[Optional[np.ndarray]], List[int]]:
    """Cached per-concept z vectors: (z or None per request, missing idx)."""
    zs: List[Optional[np.ndarray]] = []
    missing: List[int] = []
    for i, request in enumerate(requests):
        z = None
        if cache_name is not None:
            p = z_cache_path(cache_name, request, hparams, idx=i)
            if p.exists():
                try:
                    z = np.load(p)["v_star"]
                except (OSError, ValueError, KeyError) as e:
                    print(f"Error reading cache file due to {e}. "
                          "Recomputing...")
        zs.append(z)
        if z is None:
            missing.append(i)
    return zs, missing


def save_z_cache(cache_name: str, request: Dict, z, hparams=None,
                 idx: Optional[int] = None):
    """Write one z to the cache (under a process group, the first process
    only: every process holds the same z)."""
    if not is_writer():
        return
    p = z_cache_path(cache_name, request, hparams, idx=idx)
    p.parent.mkdir(exist_ok=True, parents=True)
    z = z.detach().cpu().numpy() if torch.is_tensor(z) else np.asarray(z)
    np.savez(p, v_star=z)


@torch.no_grad()
def _one_pass(model, ids, lookup, seg, zs_t, covs, layers, lam, k_scale,
              cov_scale, solve_method):
    """Walk the stack once; solve and patch at each edited layer.  Returns
    per-layer (upd, adj_k, resid, z_err)."""
    h = model.embed(ids)
    mask = causal_attention_mask(ids.shape[1], device=ids.device)
    n_spread = len(layers)
    out = []
    for i in range(max(layers) + 1):
        h, fc2_in, fc2_out = model.layer_forward(h, mask, i)
        if i not in layers:
            continue
        j = layers.index(i)
        ks = per_request_mean(gather_at_tokens(fc2_in, lookup), seg)
        cur = per_request_mean(gather_at_tokens(fc2_out, lookup), seg)
        K = ks.reshape(-1, ks.shape[-1]).T
        cur = cur.reshape(-1, cur.shape[-1]).T
        if solve_method == "f64":
            K64 = K.cpu().numpy().astype(np.float64) * k_scale
            src = (zs_t.cpu().numpy().astype(np.float64)
                   - cur.cpu().numpy().astype(np.float64)) * k_scale
            z_err = float(np.linalg.norm(src, axis=0).mean() / k_scale)
            C = covs[j].cpu().numpy().astype(np.float64) * cov_scale
            adj_k = solve_adj_k(C, K64, lam, method="f64")
            resid = src / (n_spread - j)
            upd = torch.as_tensor(resid @ adj_k.T, dtype=torch.float32,
                                  device=h.device)
            adj_k = torch.as_tensor(adj_k, dtype=torch.float32)
            resid = torch.as_tensor(resid, dtype=torch.float32)
        else:
            K = K * k_scale
            src = (zs_t - cur) * k_scale
            z_err = float(torch.linalg.norm(src, dim=0).mean() / k_scale)
            adj_k = solve_adj_k(covs[j].float() * cov_scale, K, lam,
                                method=solve_method)
            resid = src / (n_spread - j)
            upd = resid @ adj_k.T
        # the fc2 edit adds fc2_in @ upd^T to this layer's output
        h = h + torch.einsum("psi,oi->pso", fc2_in.float(), upd).to(h.dtype)
        out.append((upd, adj_k, resid, z_err))
    return out


def execute_emcid_text_encoder(
    model,
    tokenizer,
    requests: Sequence[Dict],
    hparams,
    *,
    zs,
    covs: Sequence[torch.Tensor],
    mom2_weight: Optional[float] = None,
    edit_weight: Optional[float] = None,
    solve_method: str = "f32_ir",
    batch: Optional[RequestBatch] = None,
    verbose: bool = True,
):
    """The closed-form multi-layer edit.

    ``zs``: (R, T, out) or (R*T, out) Stage-1 targets for the last edited
    layer; ``covs``: per-edited-layer C (in, in) in ``hparams.layers``
    order; ``solve_method``: "f32_ir" (on the model's device) or "f64"
    (host float64, parity).  Returns (deltas, edited model copy)."""
    lam = float(mom2_weight if mom2_weight is not None
                else hparams.mom2_update_weight)
    alpha = float(edit_weight if edit_weight is not None
                  else hparams.edit_weight)
    layers: List[int] = list(hparams.layers)
    if layers != sorted(set(layers)):
        raise ValueError(
            f"hparams.layers must be strictly ascending, got {layers}")
    if solve_method not in ("f32_ir", "f64"):
        raise ValueError(f"unknown solve method {solve_method!r}")
    if batch is None:
        batch = prepare_request_batch(
            tokenizer, requests,
            num_fact_tokens=getattr(hparams, "num_edit_tokens", 1))
    dev = next(model.parameters()).device
    zs = torch.as_tensor(zs, device=dev).float()
    if zs.dim() == 3:
        zs = zs.reshape(-1, zs.shape[-1])  # (R*T, out), request-major
    covs = [torch.as_tensor(c, device=dev).float() for c in covs]
    ids = torch.as_tensor(batch.input_ids, device=dev).long()
    lookup = torch.as_tensor(batch.lookup_indices, device=dev).long()
    seg = torch.as_tensor(batch.seg_matrix, device=dev)
    k_scale = (alpha / 0.5) ** 0.5
    cov_scale = (1.0 - alpha) / 0.5
    with precise_matmuls():
        per_layer = _one_pass(model, ids, lookup, seg, zs.T, covs, layers,
                              lam, k_scale, cov_scale, solve_method)

    deltas: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    new_model = copy.deepcopy(model)
    for layer, (upd, adj_k, resid, z_err) in zip(layers, per_layer):
        mod_name = hparams.rewrite_module_tmp.format(layer)
        w = new_model.get_submodule(mod_name).weight
        upd = upd_matrix_match_shape(upd, tuple(w.shape))
        with torch.no_grad():
            w.copy_((w.float() + upd.to(w.device)).to(w.dtype))
        deltas[f"{mod_name}.weight"] = (adj_k.cpu().numpy(),
                                        resid.cpu().numpy())
        if verbose:
            print(f"LAYER {layer}: wrote {adj_k.shape[1]} key/value pair(s); "
                  f"z error {z_err:.4f}; "
                  f"upd norm {float(torch.linalg.norm(upd)):.4f}")
    return deltas, new_model


def apply_deltas_to_params(model, deltas):
    """A copy of ``model`` with factor-pair deltas applied:
    ``W += key @ val^T`` oriented to W."""
    new_model = copy.deepcopy(model)
    for w_name, (key_mat, val_mat) in deltas.items():
        w = new_model.get_submodule(w_name[: -len(".weight")]).weight
        upd = (torch.as_tensor(key_mat, dtype=torch.float32)
               @ torch.as_tensor(val_mat, dtype=torch.float32).T)
        upd = upd_matrix_match_shape(upd, tuple(w.shape))
        with torch.no_grad():
            w.copy_((w.float() + upd.to(w.device)).to(w.dtype))
    return new_model


def apply_emcid_to_text_encoder(
    model,
    tokenizer,
    requests: Sequence[Dict],
    hparams,
    *,
    zs=None,
    covs: Optional[Sequence[torch.Tensor]] = None,
    compute_z_fn: Optional[Callable] = None,
    cov_fn: Optional[Callable[[int], torch.Tensor]] = None,
    cache_name: Optional[str] = None,
    mom2_weight: Optional[float] = None,
    edit_weight: Optional[float] = None,
    solve_method: str = "f32_ir",
    verbose: bool = True,
    return_orig_params: bool = False,
):
    """The edit of a bare text encoder (reference
    apply_emcid_to_text_encoder, emcid_main.py:769-815): z from the cache,
    else ``compute_z_fn(missing requests)`` (saved to the cache), else
    raises; covariances ``covs``, else ``cov_fn(layer)`` per edit layer;
    then the insert.  Returns (edited model copy, deltas), and with
    ``return_orig_params`` also ``model``, which the edit never writes
    (restore is keeping it)."""
    if zs is None:
        z_list, missing = load_z_list(requests, cache_name, hparams)
        if missing:
            if compute_z_fn is None:
                raise ValueError(
                    f"{len(missing)} request(s) lack cached z vectors and "
                    "no compute_z_fn was provided")
            computed = compute_z_fn([requests[i] for i in missing])
            for k, i in enumerate(missing):
                z = computed[k]
                z_list[i] = (z.detach().cpu().numpy() if torch.is_tensor(z)
                             else np.asarray(z))
                if cache_name is not None:
                    save_z_cache(cache_name, requests[i], z_list[i], hparams,
                                 idx=i)
        zs = np.stack(z_list)
        if zs.ndim == 2:
            zs = zs[:, None, :]
    if covs is None:
        if cov_fn is None:
            raise ValueError("either covs or cov_fn must be provided")
        covs = [cov_fn(layer) for layer in hparams.layers]
    deltas, new_model = execute_emcid_text_encoder(
        model, tokenizer, requests, hparams, zs=zs, covs=covs,
        mom2_weight=mom2_weight, edit_weight=edit_weight,
        solve_method=solve_method, verbose=verbose)
    if verbose:
        print(f"New weights successfully inserted into {list(deltas.keys())}")
    if return_orig_params:
        return new_model, deltas, model
    return new_model, deltas
