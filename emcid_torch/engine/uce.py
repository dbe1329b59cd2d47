"""UCE: closed-form editing of the UNet's cross-attention K/V projections,
and of the text encoder's fc2 layers.

Counterpart of the UCE part of ``emcid_tpu/engine/uce.py``.  For every
cross-attention projection W in {to_v, to_k} of every ``attn2``:

    W_new = (lam*W + eps * sum_i v_i c_i^T + p * sum_r v_r c_r^T)
            @ inv(lam*I + eps * sum_i c_i c_i^T + p * sum_r c_r c_r^T)

with c the text-encoder rows of the old concept (the aligned window after
its last real token) and v = W @ (the new concept's rows); technique
"tensor" removes from v its projection on the old output direction.
``mom2_cov`` replaces the retain-text terms by ``p*lam2*(W C, C)``.

The normal matrix (``mat2``, context x context) is the same for every
projection: it is built once, factored once (an f32 Cholesky refined on
float64 residuals until converged, ``ops.solve.refined_cholesky_solve``),
and all projections of one output width are solved in one batched
product, under ``precise_matmuls``.  Projections are found by the UNet's
module names (``attn2.to_k`` / ``attn2.to_v``), in the
reference's block order (down, up, mid), so integer ``layers_to_edit``
select the same projections as in the JAX package.

``edit_model_debias`` is the iterative UCE debias loop: CLIP-classified
class ratios of images from the current model (``debias_ratios``) set
per-class weights, and every projection is re-solved from its current
weight with value targets ``o + w_j |o|_F u_j / |u_j|_F``.  Its normal
matrices are built under ``precise_matmuls`` and solved as above.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.models.pipeline import SDComponents, encode_prompts, generate
from emcid_torch.ops.solve import refined_cholesky_solve
from emcid_torch.runtime import precise_matmuls

_BLOCK_ORDER = {"down_blocks": 0, "up_blocks": 1, "mid_block": 2}


def cross_attn_kv_layer_names(unet) -> List[str]:
    """Every ``attn2.to_k`` / ``attn2.to_v`` module name of ``unet``, down
    blocks first, then up, then mid (each block's in module order)."""
    names = [n for n, _ in unet.named_modules()
             if n.endswith((".attn2.to_k", ".attn2.to_v"))]
    return sorted(names, key=lambda n: _BLOCK_ORDER[n.split(".")[0]])


def _aligned_context_rows(components: SDComponents, old_text: str,
                          new_text: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Old/new text-encoder rows (f32) over the aligned window from each
    text's final real token (index n_real - 2), cut to equal length."""
    tok = components.tokenizer
    enc = tok([old_text, new_text], padding="max_length", truncation=True,
              max_length=tok.model_max_length)
    emb = encode_prompts(components, [old_text, new_text]).float()
    S = emb.shape[1]
    fi_old = int(np.asarray(enc["attention_mask"][0]).sum()) - 2
    fi_new = int(np.asarray(enc["attention_mask"][1]).sum()) - 2
    far = max(fi_old, fi_new)
    return (emb[0, fi_old: S - max(0, far - fi_old)],
            emb[1, fi_new: S - max(0, far - fi_new)])


def _uce_solve_all(mat2: torch.Tensor, mat1_stack: torch.Tensor
                   ) -> torch.Tensor:
    """Solve ``X mat2 = mat1`` for every (out, in) ``mat1`` of the stack
    (L, out, in) with one refined f32 Cholesky of ``mat2``
    (``ops.solve.refined_cholesky_solve``) -> (L, in, out) = W_new^T."""
    L, out, n = mat1_stack.shape
    # (in, L*out): every projection's right-hand sides side by side
    rhs = mat1_stack.double().transpose(1, 2).transpose(0, 1).reshape(
        n, L * out)
    x = refined_cholesky_solve(mat2.double(), rhs)
    return x.reshape(n, L, out).transpose(0, 1)


@torch.no_grad()
def uce_normal_equations(
    components: SDComponents,
    old_texts: Sequence[str],
    new_texts: Sequence[str],
    retain_texts: Optional[Sequence[str]] = None,
    lamb: float = 0.1,
    erase_scale: float = 0.1,
    preserve_scale: float = 0.1,
    with_to_k: bool = True,
    technique: str = "tensor",
    layers_to_edit: Optional[Sequence[int]] = None,
    mom2_cov=None,
    mom2_lamb2: float = 1.0,
) -> Tuple[List[str], Dict[str, torch.Tensor], torch.Tensor]:
    """(projection names, mat1 (out, in) per projection, the shared mat2
    (in, in)) of ``edit_model_uce``, f32 on the components' device."""
    new_texts = [t if t != "" else " " for t in new_texts]
    kv_names = cross_attn_kv_layer_names(components.unet)
    # the reference's order: every to_v, then every to_k
    proj_names = ([n for n in kv_names if n.endswith(".to_v")]
                  + ([n for n in kv_names if n.endswith(".to_k")]
                     if with_to_k else []))
    if layers_to_edit is not None:
        proj_names = [proj_names[i] for i in layers_to_edit]
    unet = components.unet
    weights = {n: unet.get_submodule(n).weight.float() for n in proj_names}
    ctx_dim = next(iter(weights.values())).shape[1]
    dev = components.device
    with precise_matmuls():
        mat1 = {n: lamb * w for n, w in weights.items()}
        mat2 = lamb * torch.eye(ctx_dim, device=dev)
        for old_text, new_text in zip(old_texts, new_texts):
            c, new_rows = _aligned_context_rows(components, old_text,
                                                new_text)
            mat2 = mat2 + erase_scale * (c.T @ c)
            for n, w in weights.items():
                new_v = new_rows @ w.T  # (rows, out)
                if technique == "tensor":
                    o = (c @ w.T).reshape(-1)
                    u = o / o.norm()
                    v = (new_v.reshape(-1) - (u * new_v.reshape(-1)).sum()
                         * u).reshape(new_v.shape)
                else:  # "replace"
                    v = new_v
                mat1[n] = mat1[n] + erase_scale * (v.T @ c)
        if mom2_cov is not None:
            C = torch.as_tensor(np.asarray(mom2_cov) if not torch.is_tensor(
                mom2_cov) else mom2_cov, device=dev).float()
            mat2 = mat2 + preserve_scale * mom2_lamb2 * C
            for n, w in weights.items():
                mat1[n] = mat1[n] + preserve_scale * mom2_lamb2 * (w @ C)
        else:
            # with no retain texts the reference preserves the empty prompt
            for text in (retain_texts if retain_texts is not None else [""]):
                rows = encode_prompts(components, [text])[0].float()
                mat2 = mat2 + preserve_scale * (rows.T @ rows)
                for n, w in weights.items():
                    v = rows @ w.T
                    mat1[n] = mat1[n] + preserve_scale * (v.T @ rows)
    return proj_names, mat1, mat2


def _with_new_weights(module: torch.nn.Module,
                      new: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """A copy of ``module`` with the weights of the named submodules
    replaced; every other parameter is shared with ``module``."""
    edited = {f"{n}.weight" for n in new}
    memo = {id(p): p for name, p in module.named_parameters()
            if name not in edited}
    out = copy.deepcopy(module, memo)
    with torch.no_grad():
        for n, w in new.items():
            p = out.get_submodule(n).weight
            p.copy_(w.to(p.dtype))
    return out


def edit_model_uce(components: SDComponents, old_texts: Sequence[str],
                   new_texts: Sequence[str], **kwargs) -> SDComponents:
    """Closed-form UCE edit of the UNet's cross-attention projections
    (keyword arguments as ``uce_normal_equations``).  Returns components
    with a new UNet; the given components are unchanged."""
    proj_names, mat1, mat2 = uce_normal_equations(
        components, old_texts, new_texts, **kwargs)
    by_dim: Dict[int, List[str]] = {}
    for n in proj_names:
        by_dim.setdefault(mat1[n].shape[0], []).append(n)
    new = {}
    for names in by_dim.values():
        solved = _uce_solve_all(mat2, torch.stack([mat1[n] for n in names]))
        for i, n in enumerate(names):
            new[n] = solved[i].T
    return components.replace_unet(_with_new_weights(components.unet, new))


@torch.no_grad()
def edit_text_encoder_uce(
    components: SDComponents,
    old_texts: Sequence[str],
    new_texts: Sequence[str],
    hparams,
    retain_texts: Optional[Sequence[str]] = None,
    lamb: float = 0.1,
    erase_scale: float = 0.1,
    preserve_scale: float = 0.1,
) -> SDComponents:
    """UCE on the text encoder's fc2 layers of ``hparams.layers``: contexts
    are fc2 inputs over the aligned window, values the fc2 outputs of the
    new concept's inputs."""
    tok = components.tokenizer
    model = components.text_encoder
    dev = components.device
    new_texts = [t if t != "" else " " for t in new_texts]

    def fc2_in(texts, layer):
        enc = tok(list(texts), padding="max_length", truncation=True,
                  max_length=tok.model_max_length)
        ids = torch.as_tensor(enc["input_ids"], device=dev).long()
        out = model(ids, capture=("fc2_in",), stop_at_layer=layer)
        return out.taps["fc2_in"][layer].float(), enc["attention_mask"]

    new = {}
    with precise_matmuls():
        for layer in hparams.layers:
            name = hparams.rewrite_module_tmp.format(layer)
            w = model.get_submodule(name).weight.float()  # (out, in)
            mat1 = lamb * w
            mat2 = lamb * torch.eye(w.shape[1], device=dev)
            for old_text, new_text in zip(old_texts, new_texts):
                x, mask = fc2_in([old_text, new_text], layer)
                S = x.shape[1]
                fi_old = int(np.asarray(mask[0]).sum()) - 2
                fi_new = int(np.asarray(mask[1]).sum()) - 2
                far = max(fi_old, fi_new)
                c = x[0, fi_old: S - max(0, far - fi_old)]
                k_new = x[1, fi_new: S - max(0, far - fi_new)]
                v = k_new @ w.T
                mat1 = mat1 + erase_scale * (v.T @ c)
                mat2 = mat2 + erase_scale * (c.T @ c)
            # with no retain texts the reference preserves the empty prompt
            for text in (retain_texts if retain_texts else [""]):
                c = fc2_in([text], layer)[0][0]
                v = c @ w.T
                mat1 = mat1 + preserve_scale * (v.T @ c)
                mat2 = mat2 + preserve_scale * (c.T @ c)
            new[name] = torch.linalg.solve(mat2.T, mat1.T).T
    return components.replace_text_encoder(_with_new_weights(model, new))


# ---------------------------------------------------------------------------
# Iterative UCE debias (reference uce_train.py:597-843: get_ratios +
# edit_model_debias)
# ---------------------------------------------------------------------------


def _aligned_rows_multi(
    components: SDComponents, old_text: str, new_texts: Sequence[str]
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Old-context rows + per-class rows (f32) over the shared aligned
    window (reference uce_train.py:784-806): final index = n_real - 2 per
    text, window end trimmed by the farthest final index across old + all
    new."""
    tok = components.tokenizer
    texts = [old_text] + list(new_texts)
    enc = tok(texts, padding="max_length", truncation=True,
              max_length=tok.model_max_length)
    emb = encode_prompts(components, texts).float()
    S = emb.shape[1]
    fis = [int(np.asarray(m).sum()) - 2 for m in enc["attention_mask"]]
    far = max(fis)
    rows = [emb[i, fi: S - max(0, far - fi)] for i, fi in enumerate(fis)]
    return rows[0], rows[1:]


def debias_ratios(
    components: SDComponents,
    scorer,
    concepts: Sequence[str],
    classes: Sequence[Sequence[str]],
    prev_ratio=None,
    ratio_diff=None,
    max_ratio_gap: float = 0.05,
    num_samples: int = 10,
    num_seeds: int = 5,
    seed: int = 0,
    gen_kwargs: Optional[dict] = None,
    mesh=None,
) -> List[np.ndarray]:
    """CLIP-classified class ratios per concept (reference get_ratios,
    uce_train.py:597-629): generate num_seeds x num_samples images of each
    concept with the CURRENT model, argmax CLIP probs over the class texts.
    Concepts whose previous max gap is below ``max_ratio_gap`` are bypassed.
    """
    from emcid_torch.engine.debias import classify_ratio

    rng = np.random.RandomState(seed)
    seeds = rng.randint(5000, size=num_seeds)
    gk = dict(num_inference_steps=20, guidance_scale=7.5)
    gk.update(gen_kwargs or {})
    ratios: List[np.ndarray] = []
    for idx, concept in enumerate(concepts):
        if ratio_diff is not None and ratio_diff[idx] < max_ratio_gap:
            ratios.append(prev_ratio[idx])
            continue
        prompts, im_seeds = [], []
        for s in seeds:
            prompts += [concept] * num_samples
            im_seeds += [int(s) * 1009 + j for j in range(num_samples)]
        imgs = generate(components, prompts, im_seeds, mesh=mesh, **gk)
        ratios.append(np.asarray(
            classify_ratio(scorer, imgs, list(classes[idx]))))
    return ratios


@torch.no_grad()
def debias_normal_equations(
    unet,
    proj_names: Sequence[str],
    concept_rows: Sequence[Tuple[torch.Tensor, List[torch.Tensor]]],
    weights: Sequence[np.ndarray],
    retain_rows: Sequence[torch.Tensor],
    lamb: float = 0.1,
    erase_scale: float = 0.1,
    preserve_scale: float = 0.1,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One iteration's normal equations from ``unet``'s current weights:
    mat1 (out, in) per projection and the shared mat2 (in, in), f32, built
    under ``precise_matmuls``."""
    cur = {n: unet.get_submodule(n).weight.float() for n in proj_names}
    ctx_dim = next(iter(cur.values())).shape[1]
    dev = next(iter(cur.values())).device
    with precise_matmuls():
        mat1 = {n: lamb * w for n, w in cur.items()}
        mat2 = lamb * torch.eye(ctx_dim, device=dev)
        for cnt, (c, class_rows) in enumerate(concept_rows):
            mat2 = mat2 + erase_scale * (c.T @ c)
            for n, w in cur.items():
                o = c @ w.T  # (rows, out)
                o_norm = o.norm()
                v = o
                for j, u_rows in enumerate(class_rows):
                    u = u_rows @ w.T
                    u = u / u.norm()
                    v = v + (float(weights[cnt][j]) * o_norm) * u
                mat1[n] = mat1[n] + erase_scale * (v.T @ c)
        for rows in retain_rows:
            mat2 = mat2 + preserve_scale * (rows.T @ rows)
            for n, w in cur.items():
                v = rows @ w.T
                mat1[n] = mat1[n] + preserve_scale * (v.T @ rows)
    return mat1, mat2


def edit_model_debias(
    components: SDComponents,
    scorer,
    old_texts: Sequence[str],
    new_texts: Sequence[Sequence[str]],
    retain_texts: Optional[Sequence[str]] = None,
    add: bool = True,
    lamb: float = 0.1,
    erase_scale: float = 0.1,
    preserve_scale: float = 0.1,
    with_to_k: bool = True,
    layers_to_edit: Optional[Sequence[int]] = None,
    max_bias_diff: float = 0.05,
    max_iters: int = 30,
    weight_step: float = 0.1,
    num_samples: int = 1,
    num_seeds: int = 5,
    seed: int = 0,
    gen_kwargs: Optional[dict] = None,
    mesh=None,
    verbose: bool = True,
) -> Tuple[SDComponents, List[np.ndarray], List[np.ndarray],
           List[np.ndarray]]:
    """Iterative UCE debias loop (reference edit_model_debias,
    uce_train.py:641-843).

    Per outer iteration: measure per-concept class ratios with CLIP on
    images from the CURRENT model, stop when every concept's max deviation
    from uniform is < ``max_bias_diff``; otherwise set per-class weights
    ``weight_step * (desired - ratio)`` (zeroed + moved to the retain set
    once attained) and re-solve every cross-attn K/V projection from its
    CURRENT weight.  Each iteration's UNet is a copy that shares every
    parameter it does not edit.

    Returns (edited components, final weights, initial ratios, final
    ratios).  The caller's components are never changed.
    """
    # ---- format edits (reference :758-776) -------------------------------
    old_texts = list(old_texts)
    fmt_new: List[List[str]] = []
    for old_text, classes in zip(old_texts, new_texts):
        n_t = []
        for t in classes:
            if add and old_text.lower() not in t.lower():
                n_t.append(t + " " + old_text)
            else:
                n_t.append(t)
        if len(n_t) == 1:
            n_t = n_t * 2
        fmt_new.append(n_t)
    ret_texts = list(retain_texts) if retain_texts else [""]

    desired = [np.ones(len(c)) / len(c) for c in fmt_new]
    weights = [np.zeros(len(c)) for c in fmt_new]

    kv_names = cross_attn_kv_layer_names(components.unet)
    proj_names = ([n for n in kv_names if n.endswith(".to_v")]
                  + ([n for n in kv_names if n.endswith(".to_k")]
                     if with_to_k else []))
    if layers_to_edit is not None:
        proj_names = [proj_names[i] for i in layers_to_edit]

    edited = components
    init_ratios = ratios = None
    prev_ratio = ratio_diff = None
    # UCE never edits the text encoder, so the context rows are loop
    # constants: encode once
    concept_rows = [
        _aligned_rows_multi(components, old_text, classes)
        for old_text, classes in zip(old_texts, fmt_new)
    ]
    retain_rows: Dict[str, torch.Tensor] = {}

    def rows_for(text):
        if text not in retain_rows:
            retain_rows[text] = encode_prompts(components, [text])[0].float()
        return retain_rows[text]

    for it in range(max_iters):
        ratios = debias_ratios(
            edited, scorer, old_texts, fmt_new,
            prev_ratio=prev_ratio, ratio_diff=ratio_diff,
            max_ratio_gap=max_bias_diff, num_samples=num_samples,
            num_seeds=num_seeds, seed=seed, gen_kwargs=gen_kwargs, mesh=mesh,
        )
        if init_ratios is None:
            init_ratios = ratios
        max_change = [float(np.abs(r - d).max())
                      for r, d in zip(ratios, desired)]
        if verbose:
            print(f"debias iter {it}: ratios "
                  f"{[np.round(r, 3).tolist() for r in ratios]}")
        if max(max_change) < max_bias_diff:
            if verbose:
                print(f"all concepts debiased at iteration {it}")
            break
        prev_ratio, ratio_diff = ratios, max_change

        weights = [weight_step * (d - r) for r, d in zip(ratios, desired)]
        weights = [w if mc > max_bias_diff else w * 0.0
                   for w, mc in zip(weights, max_change)]
        attained = [old_texts[i] for i, w in enumerate(weights) if w[0] == 0]
        if attained:
            ret_texts = sorted(set(ret_texts) | set(attained))

        # ---- closed-form re-solve from the CURRENT weights ----------------
        mat1, mat2 = debias_normal_equations(
            edited.unet, proj_names, concept_rows, weights,
            [rows_for(t) for t in ret_texts], lamb=lamb,
            erase_scale=erase_scale, preserve_scale=preserve_scale)
        by_dim: Dict[int, List[str]] = {}
        for n in proj_names:
            by_dim.setdefault(mat1[n].shape[0], []).append(n)
        new = {}
        for names in by_dim.values():
            solved = _uce_solve_all(mat2, torch.stack([mat1[n] for n in names]))
            for i, n in enumerate(names):
                new[n] = solved[i].T
        edited = edited.replace_unet(_with_new_weights(edited.unet, new))
    return edited, weights, init_ratios, ratios
