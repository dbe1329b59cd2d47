"""Stage 1: optimize the target representation z of a block of concepts.

Counterpart of ``emcid_tpu/engine/compute_z.py``.  For each concept, a
delta added to the edit-token hidden state at the last edited layer is
optimized to minimize

    MSE(UNet(noisy, t, edited source text), target)      [noise loss]
  + v_weight_decay * |delta| / |z0|^2                     [or EWC]
  + text_repr_loss_scale * MSE(edited pooler, dest pooler)
  + txt_img_align_scale * tia_weight * TIA                [txt-img-align]

with Adam and an L2-ball projection |delta| <= clamp_norm_factor * |z0|
after every step.  The noise-loss target is UNet(noisy, t, dest text)
(ablate-dest / ablate-source), ``eps_dest - mu * (eps_src - eps_dest)``
with the unedited source text's eps_src (``objective="esd"``), or the true
noise (``use_sampled_noise``); ``no_noise_loss`` drops the term.  EWC
replaces the weight decay by ``sum(ewc_lambda * fim * delta^2) /
(2 |z0|^2)``.  ``align_object_token`` aligns the edited and dest hidden
states at their subject tokens instead of the poolers.  TIA pulls the
CLIP-projected edited pooler toward the dest images' CLIP embedding
(``txt_img_align_loss_metric`` "l2" or "cos").

The JAX package vmaps one concept's loss over the block.  Here the block's
C x P prompts form one UNet batch; the C per-concept losses are summed and
differentiated once.  The concepts share no parameters (the text and UNet
weights are frozen, only ``delta`` has a gradient), so each concept's
gradient in ``delta (C, T, H)`` is exactly its own loss's.  Adam is written
out to match ``optax.scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0, bias-corrected) with the learning rate of each step taken from
the same ``lr_values`` array as the JAX package.

Record/replay: ``run(noise_override=, ts_override=)`` takes the noise
(steps, C, P, h, w, c) and timesteps (steps, C, P) of every step, which
makes the optimization comparable with the JAX package's given the same
training images.  With an override the eps_dest pool and the cosine
schedule do not engage (as in JAX).

The eps_dest pool (``eps_pool`` K > 0).  Its K draws come from the
block's generator first, in order, as the JAX package makes them; their
no-grad UNet evaluations then run as a few stacked calls, not one call a
draw.  ``pool_calls`` plans them from what a call would hold, the rows a
draw (C_s x P on a shard) times the latent area, against one budget of
latent positions (``POOL_CALL_POSITIONS``): a small block stacks several
draws a call and keeps the card busy, a large one keeps one draw a call.
A shard stacks only its own rows.  The pool is one ``stage1.pool`` span
and each UNet call a ``stage1.pool_calls`` count.

CUDA graphs, here and in SDXL's Stage 1 (``engine/sdxl``).  On the card
a step's gradient pass replays captured graphs (``ops/graphs``); here the
text model's forward with the injected delta and its backward into the
delta, and the UNet's eps with its backward into the context.  The K1-K4
attention calls inside them stay eager, between the replays, through
their wrappers (every launch is still one call that ``_build.ROUTES``
counts and a profiler wrapper sees); everything else of the captured
calls replays, one graph per stretch between two such calls.  The draws,
the pool index, the loss terms, Adam, the ball projection and the loss
record stay eager.  The graphs engage only where a step can be seen to be
safe to replay (``graph_blockers``): CUDA models, no mesh, grad on, no
forward or backward hooks on any of the models, the fused norm kernels
off, and a noise loss.  Everywhere else the step is eager.  Each Stage 1
names its captures in a function of its own; ``StepGraphs`` holds them
for one shape, makes them at the first step that wants them and runs the
step eagerly for good where that fails.  One capture serves every later
block of the same models at the same shapes (``stage1_graphs``: keyed
weakly on the modules and by ``graph_key``, not on the hparams, so a
warm-up block captures what later blocks replay; the captures go with
their modules).  Under a ``profiling.recording`` the steps count as
``stage1.graph_steps`` or ``stage1.eager_steps`` (``count_step``), and
each capture is a ``stage1.capture`` span.
"""

from __future__ import annotations

import os
import warnings
import weakref
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from emcid_torch.models.scheduler import Schedule, add_noise
from emcid_torch.models.unet import _fused_gn, _fused_ln
from emcid_torch.ops import graphs as cuda_graphs
from emcid_torch.ops.attention import _flash_min_seq
from emcid_torch.parallel import gather, pad_to_multiple, replicate
from emcid_torch.profiling import count, each, span
from emcid_torch.text.token_range import find_token_range

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_step_(delta, m1, m2, grad, lr: float, n: int) -> None:
    """optax ``adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8), step ``n`` (from
    1), in place on ``delta`` and its moments."""
    m1.mul_(ADAM_B1).add_(grad, alpha=1 - ADAM_B1)
    m2.mul_(ADAM_B2).addcmul_(grad, grad, value=1 - ADAM_B2)
    upd = (m1 / (1 - ADAM_B1 ** n)) / (
        torch.sqrt(m2 / (1 - ADAM_B2 ** n)) + ADAM_EPS)
    delta -= lr * upd


def clamp_to_ball_(delta, max_norm) -> None:
    """In place, the L2-ball projection ``|delta[c]| <= max_norm[c]`` per
    concept (leading axis of ``delta``)."""
    dn = delta.reshape(delta.shape[0], -1).norm(dim=-1)
    delta *= torch.clamp(max_norm / dn.clamp_min(1e-12), max=1.0).reshape(
        (-1,) + (1,) * (delta.ndim - 1))


class ConceptBatch(NamedTuple):
    """Tensors for a block of C concepts, P prompts each, T edit tokens."""

    source_ids: torch.Tensor  # (C, P, S) long
    dest_ids: torch.Tensor  # (C, P, S) long
    inject_mask: torch.Tensor  # (C, T, P, S) f32
    source_lookup: torch.Tensor  # (C, P) long
    dest_lookup: torch.Tensor  # (C, P) long
    latents_mean: torch.Tensor  # (C, Simg, P, h, w, c) scaled posterior mean
    latents_logvar: torch.Tensor  # (C, Simg, P, h, w, c)


def prepare_concept_batch(
    tokenizer,
    requests: Sequence[Dict],
    hparams,
    max_length: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], List[List[str]], List[List[str]]]:
    """Host-side tokenization and edit-token localization for a block."""
    max_length = max_length or tokenizer.model_max_length
    C = len(requests)
    P = len(requests[0]["prompts"])
    T = getattr(hparams, "num_edit_tokens", 1)
    S = max_length

    source_ids = np.zeros((C, P, S), np.int32)
    dest_ids = np.zeros((C, P, S), np.int32)
    inject_mask = np.zeros((C, T, P, S), np.float32)
    source_lookup = np.zeros((C, P), np.int32)
    dest_lookup = np.zeros((C, P), np.int32)
    src_prompts_all, dst_prompts_all = [], []

    for c, request in enumerate(requests):
        if len(request["prompts"]) != P:
            raise ValueError("uniform prompt count per block")
        src_prompts = [p.format(request["source"]) for p in request["prompts"]]
        if hparams.objective == "esd":
            dst_prompts = ["" for _ in request["prompts"]]
        else:
            dst_prompts = [p.format(request["dest"]) for p in request["prompts"]]
        src_prompts_all.append(src_prompts)
        dst_prompts_all.append(dst_prompts)
        s_enc = tokenizer(src_prompts, padding="max_length", truncation=True,
                          max_length=S)
        d_enc = tokenizer(dst_prompts, padding="max_length", truncation=True,
                          max_length=S)
        source_ids[c] = s_enc["input_ids"]
        dest_ids[c] = d_enc["input_ids"]
        for p in range(P):
            n_real = int(s_enc["attention_mask"][p].sum())
            _, end = find_token_range(
                tokenizer, s_enc["input_ids"][p, :n_real], request["source"])
            source_lookup[c, p] = end - 1
            inject_mask[c, 0, p, end - 1] = 1.0
            if T > 1:
                eos = n_real - 1
                for t in range(1, T):
                    inject_mask[c, t, p, min(eos + t - 1, S - 1)] = 1.0
            dn = int(d_enc["attention_mask"][p].sum())
            if hparams.objective == "esd":
                dest_lookup[c, p] = dn - 1
            else:
                _, dend = find_token_range(
                    tokenizer, d_enc["input_ids"][p, :dn], request["dest"])
                dest_lookup[c, p] = dend - 1

    return (
        dict(source_ids=source_ids, dest_ids=dest_ids,
             inject_mask=inject_mask, source_lookup=source_lookup,
             dest_lookup=dest_lookup),
        src_prompts_all,
        dst_prompts_all,
    )


def concept_batch_to_device(arrays: Dict[str, Any], device) -> ConceptBatch:
    """Numpy arrays (``prepare_concept_batch`` output plus latents) ->
    ConceptBatch on ``device``."""
    out = {}
    for k in ConceptBatch._fields:
        t = torch.as_tensor(np.asarray(arrays[k]) if not torch.is_tensor(
            arrays[k]) else arrays[k], device=device)
        out[k] = t.long() if t.dtype in (torch.int32, torch.int64) else t.float()
    return ConceptBatch(**out)


def check_supported(hparams, mesh=None) -> None:
    """What the port refuses: an objective or txt-img-align metric that has
    no loss in the JAX package either.  ``mesh`` is accepted (any
    ``emcid_torch.parallel.DeviceMesh``)."""
    if hparams.objective not in ("ablate-dest", "ablate-source", "esd"):
        raise ValueError(f"objective not supported: {hparams.objective!r}")
    metric = getattr(hparams, "txt_img_align_loss_metric", "l2")
    if (getattr(hparams, "txt_img_align_scale_factor", 0.0)
            and metric not in ("l2", "cos")):
        raise ValueError(f"txt_img_align_loss_metric {metric!r} not "
                         "supported")


def _env(name: str, default, cast):
    """A dataclass default read from the environment at instance time;
    an explicit constructor argument wins."""
    return field(default_factory=lambda: cast(os.environ.get(name, default)))


def _f32(x, dev) -> torch.Tensor:
    """An array or tensor as an f32 tensor on ``dev``."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x)).to(
        dev, torch.float32)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with ``n`` copies of its last row appended (leading axis)."""
    return torch.cat([x, x[-1:].expand((n,) + tuple(x.shape[1:]))])


def _mse(a, b, C: int) -> torch.Tensor:
    """Per-concept mean squared difference (C,) of (C*..., ...) tensors."""
    return (a - b).pow(2).reshape(C, -1).mean(dim=1)


def _hooked(module: torch.nn.Module) -> bool:
    """Whether a forward or backward hook would run in ``module``'s
    calls."""
    glob = torch.nn.modules.module
    if any(getattr(glob, name, None) for name in (
            "_global_forward_hooks", "_global_forward_pre_hooks",
            "_global_backward_hooks", "_global_backward_pre_hooks")):
        return True
    return any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
               or m._backward_pre_hooks for m in module.modules())


def graph_blockers(*models, mesh=None) -> List[str]:
    """Why a Stage-1 step of these models cannot replay CUDA graphs here:
    ``"device"`` (not all on one CUDA device), ``"mesh"``, ``"no grad"``,
    ``"hooks"`` (forward or backward hooks on any model, as ``unet_taps``
    and ``unet_inject`` register), ``"fused norms"`` (the K5/K6 knobs:
    those kernels count their launches in Python, which a replay would
    skip).  Empty where it can."""
    why = []
    devs = {next(m.parameters()).device for m in models}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        why.append("device")
    if mesh is not None:
        why.append("mesh")
    if not torch.is_grad_enabled():
        why.append("no grad")
    if any(_hooked(m) for m in models):
        why.append("hooks")
    if _fused_gn() != "0" or _fused_ln():
        why.append("fused norms")
    return why


class StepGraphs:
    """A Stage-1 step's captured calls at one shape (``captured``: a
    ``cuda_graphs.Captured`` by name), made at the first step that wants
    them.  A failed capture leaves ``failed`` set, and the steps of this
    shape run eagerly."""

    def __init__(self, device: torch.device):
        self.device = device
        self.captured: Dict[str, cuda_graphs.Captured] = {}
        self.failed = False

    def ready(self, capture: Callable[[], Dict[str, cuda_graphs.Captured]],
              label: str) -> Optional[Dict[str, cuda_graphs.Captured]]:
        """The captures, made by ``capture()`` on the first call; None
        where they failed (``label`` names the Stage 1 in the warning), and
        the step runs eagerly."""
        if not self.captured and not self.failed:
            with span("stage1.capture"):
                try:
                    self.captured = capture()
                except RuntimeError as e:
                    warnings.warn(f"{label} runs eagerly at this shape: its "
                                  f"CUDA-graph capture failed ({e})")
                    self.failed = True
                torch.cuda.synchronize(self.device)
                # the warm-up's blocks, cached for the capture's side stream
                torch.cuda.empty_cache()
        return None if self.failed else self.captured


def count_step(graphs: Optional[StepGraphs]) -> None:
    """Count a Stage-1 step as replayed from ``graphs`` or as eager (no
    graphs, or a failed capture)."""
    count("stage1.eager_steps" if graphs is None or graphs.failed
          else "stage1.graph_steps")


# captured steps: per number of modules, one weak level per module, then
# the key.  SD's (text, unet) and SDXL's (text1, text2, unet) are apart
# even where they share modules (``SDXLComponents.sd_view``); weakly
# keyed, so that a module's captures go with it
_STEP_GRAPHS: Dict[int, "weakref.WeakKeyDictionary"] = {}


def held_graphs(models: Sequence[torch.nn.Module]) -> Dict[Tuple,
                                                          StepGraphs]:
    """The ``StepGraphs`` cached for these modules, by key: the cache's own
    dict, so clearing it drops their captures."""
    node = _STEP_GRAPHS.setdefault(len(models), weakref.WeakKeyDictionary())
    for m in models[:-1]:
        node = node.setdefault(m, weakref.WeakKeyDictionary())
    return node.setdefault(models[-1], {})


def graph_key(models: Sequence[torch.nn.Module], shapes: Tuple) -> Tuple:
    """What a capture over these modules is specific to: the caller's
    ``shapes``, each module's dtype, their device and the attention
    routing; not the hparams, so that a warm-up block captures what later
    blocks replay."""
    params = [next(m.parameters()) for m in models]
    return (tuple(shapes), *(p.dtype for p in params), params[0].device,
            _flash_min_seq(), os.environ.get("EMCID_TPU_NO_FLASH"))


def stage1_graphs(models: Sequence[torch.nn.Module], shapes: Tuple,
                  mesh=None) -> Optional[StepGraphs]:
    """The ``StepGraphs`` of these modules at ``shapes``, new or cached;
    None where ``graph_blockers`` finds a reason against them."""
    if graph_blockers(*models, mesh=mesh):
        return None
    return held_graphs(models).setdefault(
        graph_key(models, shapes),
        StepGraphs(next(models[0].parameters()).device))


# latent positions (rows x h x w) that one stacked no-grad UNet call of
# the eps_dest pool may take: the fewest rows at 48 x 48 whose device time
# a row came within 5% of its plateau on an H100 80GB HBM3 at 700 W (36
# rows: 2.14 ms a row against 2.06 at 72, 2.24 at 24 and 9.73 at 3;
# ``chip_smoke.py --stage1-pool``); it also bounds what such a call holds
# in memory at one time
POOL_CALL_POSITIONS = 36 * 48 * 48


def pool_calls(K: int, rows: int, h: int, w: int) -> List[int]:
    """Draws per UNet call of a K-draw eps_dest pool of ``rows`` rows a
    draw at h x w latents, in draw order: the fewest calls whose rows x h
    x w stay within ``POOL_CALL_POSITIONS`` (one draw a call where a draw
    alone passes it), the draws split as evenly as possible, the larger
    calls first."""
    if K <= 0:
        return []
    n = -(-K // max(1, POOL_CALL_POSITIONS // (rows * h * w)))
    base, extra = divmod(K, n)
    return [base + 1] * extra + [base] * (n - extra)


class _Shard(NamedTuple):
    """One mesh entry's concept rows and the models it runs."""

    rows: slice
    text: Any
    unet: Any
    device: torch.device


@dataclass
class ZOptimizer:
    """Stage-1 optimizer of one edit layer for concept blocks."""

    text_model: Any  # CLIPTextEncoder
    unet: Any  # UNet2DCondition
    schedule: Schedule
    hparams: Any
    layer: int
    # eps_dest pool of K (noisy, t, eps_dest[, eps_src]) draws made once
    # with no-grad forwards and re-drawn from every step (0 = fresh
    # forwards every step, the reference protocol)
    eps_pool: int = _env("EMCID_TPU_EPS_POOL", 0, int)
    # "const": Adam at v_lr for v_num_grad_steps (reference protocol);
    # "cosine": cosine decay from z_peak * v_lr over z_frac of the steps,
    # only for runs of >= 50 steps
    lr_sched: str = _env("EMCID_TPU_Z_SCHED", "const", str)
    z_frac: float = _env("EMCID_TPU_Z_FRAC", 0.6, float)
    z_peak: float = _env("EMCID_TPU_Z_PEAK", 2.0, float)
    # EWC Fisher diagonal (hidden,), required by hparams.use_ewc
    fim: Optional[Any] = None
    # (hidden, embed) CLIP text projection, required by run(dest_img_emb=)
    text_projection: Optional[Any] = None

    def __post_init__(self):
        check_supported(self.hparams)
        self.text_model.requires_grad_(False)
        self.unet.requires_grad_(False)

    def lr_values(self, replay: bool) -> np.ndarray:
        total = self.hparams.v_num_grad_steps
        v_lr = self.hparams.v_lr
        if self.lr_sched == "cosine" and total >= 50 and not replay:
            peak = v_lr * float(self.z_peak)
            total = max(1, int(round(float(self.z_frac) * total)))
            return (0.5 * peak * (1.0 + np.cos(
                np.pi * np.arange(total) / total))).astype(np.float32)
        return np.full(max(total, 1), v_lr, np.float32)

    # -- pieces ------------------------------------------------------------
    def _draw(self, batch: ConceptBatch, gen: torch.Generator):
        """One (noisy, t) draw per (concept, prompt): image index, posterior
        sample, noise, timestep.  Returns the latents and noise
        (C, P, h, w, c) and t (C, P)."""
        mean, logvar = batch.latents_mean, batch.latents_logvar
        C, Simg, P = mean.shape[:3]
        dev = mean.device
        ci = torch.arange(C, device=dev)[:, None]
        pi = torch.arange(P, device=dev)[None, :]
        img = torch.randint(0, Simg, (C, P), generator=gen, device=dev)
        m, lv = mean[ci, img, pi], logvar[ci, img, pi]  # (C, P, h, w, c)
        lat = m + torch.exp(0.5 * lv) * torch.randn(
            m.shape, generator=gen, device=dev)
        noise = torch.randn(lat.shape, generator=gen, device=dev)
        t = torch.randint(0, self.schedule.num_train_timesteps, (C, P),
                          generator=gen, device=dev)
        return lat, noise, t

    def _noisy(self, lat, noise, t):
        x = add_noise(self.schedule, lat.flatten(0, 1), noise.flatten(0, 1),
                      t.flatten())
        return x.permute(0, 3, 1, 2), t.flatten()

    @staticmethod
    def _eps(unet, noisy, t, ctx):
        dtype = next(unet.parameters()).dtype
        return unet(noisy.to(dtype), t, ctx).sample.float()

    def _shards(self, C: int, mesh) -> List[_Shard]:
        """The concept slices of a block of C and the models each runs:
        the whole block on the optimizer's own models without a mesh, else
        C / mesh.size concepts per mesh entry of this process on its
        replicas (the global slices from ``mesh.first`` on)."""
        if mesh is None:
            dev = next(self.unet.parameters()).device
            return [_Shard(slice(0, C), self.text_model, self.unet, dev)]
        if C % mesh.size:
            raise ValueError(f"block of {C} concepts does not divide the "
                             f"mesh ({mesh.size} entries); pad it first")
        n = C // mesh.size
        return [_Shard(slice(k * n, (k + 1) * n), text, unet, d)
                for k, (text, unet, d) in enumerate(zip(
                    replicate(self.text_model, mesh),
                    replicate(self.unet, mesh), mesh.devices),
                    start=mesh.first)]

    @torch.no_grad()
    def _prepare(self, sh: _Shard, batch: ConceptBatch, is_esd: bool,
                 tia) -> Dict[str, Any]:
        """A shard's frozen tensors: its rows of the batch, the dest (and
        for esd the source) text states, and z0."""
        sub = ConceptBatch(*(x[sh.rows].to(sh.device) for x in batch))
        C, P, S = sub.source_ids.shape
        H = self.text_model.config.hidden_size
        dest = sh.text(sub.dest_ids.reshape(C * P, S))
        src_ids = sub.source_ids.reshape(C * P, S)
        out0 = sh.text(sub.source_ids[:, 0], capture=("layer_out",),
                       stop_at_layer=self.layer)
        layer_out0 = out0.taps["layer_out"][self.layer].float()
        z0 = torch.einsum("cts,csh->cth", sub.inject_mask[:, :, 0, :],
                          layer_out0)
        st = dict(batch=sub, C=C, src_ids=src_ids,
                  dest_hidden=dest.last_hidden_state,
                  dest_pooled=dest.pooled_output.float().reshape(C, P, H),
                  source_hidden=(sh.text(src_ids).last_hidden_state
                                 if is_esd else None),
                  z0=z0, z0_norm=z0.reshape(C, -1).norm(dim=-1),
                  ci=torch.arange(C, device=sh.device)[:, None],
                  pi=torch.arange(P, device=sh.device)[None, :])
        if self.hparams.use_ewc:
            st["fim"] = _f32(self.fim, sh.device)
        if tia is not None:  # (dest image embeddings, weights), padded
            st["text_proj"] = _f32(self.text_projection, sh.device)
            st["emb"], st["tia_w"] = (x[sh.rows].to(sh.device) for x in tia)
        return st

    @torch.no_grad()
    def _build_pool(self, shards, states, batch: ConceptBatch, K: int,
                    gen: torch.Generator, padded
                    ) -> List[Dict[str, torch.Tensor]]:
        """K (noisy, t, eps_dest[, eps_src]) draws per shard, (K, C_s*P,
        ...): the draws come from ``gen`` for the whole block in order,
        then are padded and split by concept.  Each shard evaluates its
        draws in the stacked UNet calls that ``pool_calls`` plans for its
        rows and latent area: a call takes several consecutive draws as one
        batch, each row at its own timestep, against the text states
        repeated once per draw, and its output is split back per draw.
        Each call counts as ``stage1.pool_calls``."""
        draws = [tuple(padded(a) for a in self._draw(batch, gen))
                 for _ in range(K)]
        h, w = batch.latents_mean.shape[3:5]
        pools = []
        for sh, st in zip(shards, states):
            ctxs = {"eps_dest": st["dest_hidden"]}
            if st["source_hidden"] is not None:
                ctxs["eps_src"] = st["source_hidden"]
            rows = st["C"] * batch.source_ids.shape[1]
            pool: Dict[str, List[torch.Tensor]] = {
                k: [] for k in ("noisy", "t", *ctxs)}
            k0 = 0
            for n in pool_calls(K, rows, h, w):
                x, t = self._noisy(*(
                    torch.cat([d[j][sh.rows] for d in draws[k0:k0 + n]]
                              ).to(sh.device) for j in range(3)))
                k0 += n
                pool["noisy"] += x.split(rows)
                pool["t"] += t.split(rows)
                for key, ctx in ctxs.items():
                    count("stage1.pool_calls")
                    pool[key] += self._eps(sh.unet, x, t,
                                           ctx.repeat(n, 1, 1)).split(rows)
            pools.append({k: torch.stack(v) for k, v in pool.items()})
        return pools

    def graph_shapes(self, batch: ConceptBatch) -> Tuple:
        """What a captured step is specific to, besides its modules
        (``graph_key``)."""
        C, P, S = batch.source_ids.shape
        h, w = batch.latents_mean.shape[3:5]
        return (self.layer, C * P, S, self.text_model.config.hidden_size,
                h, w)

    def _capture(self, sh: _Shard, ids, inj, noisy, t
                 ) -> Dict[str, cuda_graphs.Captured]:
        """The step's gradient pass at these inputs, captured:
        ``text(ids, inj)`` -> (hidden, pooled) with the delta injected at
        the optimizer's layer, backward into ``inj``; ``eps(noisy, t,
        ctx)`` -> (eps,), backward into ``ctx``."""
        text, unet, layer = sh.text, sh.unet, self.layer
        cap = {"text": cuda_graphs.capture(
            lambda i, d: tuple(text(i, inject_layer=layer,
                                    inject_delta=d)[:2]), (ids, inj))}
        ctx = cap["text"](ids, inj)[0].detach().requires_grad_()
        cap["eps"] = cuda_graphs.capture(
            lambda x, s, c: ZOptimizer._eps(unet, x, s, c), (noisy, t, ctx))
        return cap

    def _loss(self, sh: _Shard, st, delta, noisy, t, noise, eps_dest,
              eps_src, graphs: Optional[StepGraphs] = None) -> torch.Tensor:
        """Per-concept Stage-1 loss (C_s,) of one shard at ``delta`` (its
        rows, on its device); the text model and the UNet replay
        ``graphs`` where given and ready."""
        hp = self.hparams
        b, C = st["batch"], st["C"]
        P, S = b.source_ids.shape[1:]
        H = delta.shape[-1]
        inj = torch.einsum("ctps,cth->cpsh", b.inject_mask, delta)
        inj = inj.reshape(C * P, S, H)
        ids = st["src_ids"]
        cap = None if graphs is None else graphs.ready(
            lambda: self._capture(sh, ids, inj, noisy, t), "Stage 1")
        if cap is not None:
            hidden, pooled = cap["text"](ids, inj)
        else:
            edited = sh.text(ids, inject_layer=self.layer, inject_delta=inj)
            hidden, pooled = edited.last_hidden_state, edited.pooled_output
        if hp.no_noise_loss:
            loss = torch.zeros(C, device=sh.device)
        else:
            # eagerly contiguous, as a captured graph holds it: the UNet's
            # first convolution takes another path on channel-last strides
            eps_edit = (self._eps(sh.unet, noisy.contiguous(), t, hidden)
                        if cap is None else cap["eps"](noisy, t, hidden)[0])
            if hp.objective == "esd":
                mu = (float(hp.esd_mu) if hp.esd_mu not in (None, "None")
                      else 1.0)
                loss = _mse(eps_edit, eps_dest - mu * (eps_src - eps_dest), C)
            elif hp.use_sampled_noise:
                loss = _mse(noise.flatten(0, 1).permute(0, 3, 1, 2),
                            eps_edit, C)
            else:  # ablate-dest / ablate-source
                loss = _mse(eps_edit, eps_dest, C)
        z0_norm = st["z0_norm"]
        if hp.use_ewc:
            loss = loss + (float(hp.ewc_lambda) * st["fim"] * delta.pow(2)
                           ).reshape(C, -1).sum(dim=1) / (2.0 * z0_norm ** 2)
        else:
            # safe norm: its gradient at delta = 0 is 0, not NaN
            d_norm = torch.sqrt(delta.pow(2).reshape(C, -1).sum(dim=1)
                                + 1e-12)
            loss = loss + hp.v_weight_decay * d_norm / z0_norm ** 2
        if hp.cal_text_repr_loss:
            if hp.align_object_token:
                ci, pi = st["ci"], st["pi"]
                e_h = hidden.float().reshape(C, P, S, H)
                d_h = st["dest_hidden"].float().reshape(C, P, S, H)
                talign = _mse(e_h[ci, pi, b.source_lookup],
                              d_h[ci, pi, b.dest_lookup], C)
            else:  # pooler alignment (the shipped default)
                talign = _mse(pooled.float().reshape(C, P, H),
                              st["dest_pooled"], C)
            loss = loss + hp.text_repr_loss_scale_factor * talign
        if "emb" in st:
            emb = st["emb"]
            e_txt = pooled.float().reshape(C, P, H) @ st["text_proj"]
            if hp.txt_img_align_loss_metric == "cos":
                cos = (e_txt / e_txt.norm(dim=-1, keepdim=True)
                       * emb / emb.norm(dim=-1, keepdim=True)).sum(-1)
                term = -(cos.mean(dim=1) - 1.0)
            else:  # "l2"
                term = _mse(e_txt, emb, C)
            loss = loss + hp.txt_img_align_scale_factor * st["tia_w"] * term
        return loss

    # -- main --------------------------------------------------------------
    def run(self, batch: ConceptBatch, gen: Optional[torch.Generator] = None,
            noise_override=None, ts_override=None, dest_img_emb=None,
            tia_weight=None, mesh=None):
        """Optimize a block -> (zs (C, T, H), delta, z0, losses (steps,)),
        f32 tensors on the batch's device.  ``dest_img_emb`` (C, P, E) with
        the per-concept ``tia_weight`` (C,) (default ones) turns on the
        txt-img-align term.

        With ``mesh`` (``emcid_torch.parallel``) the concept axis shards
        over the mesh entries, C / mesh.size concepts each, on replicas of
        the text model and the UNet.  A block that does not divide the
        mesh is padded with copies of its last concept.  Every draw is made
        for the block's own concepts from ``gen`` in the unsharded order,
        then padded (a copy gets its original's draws) and split, and the
        per-shard losses are gathered before one backward, so Adam and the
        ball projection run on the whole delta as without a mesh: sharded
        equals unsharded up to the summation order of the smaller UNet
        batches.  On a mesh across processes each process runs its own
        shards and takes the gradient of their losses, whose rows (and the
        losses) are then gathered from every process in shard order: every
        process steps the same delta.  The padding is dropped from every
        output.  Each step is a ``stage1.step`` span, the pool's forwards
        one ``stage1.pool`` span (``emcid_torch.profiling``)."""
        hp = self.hparams
        dev = batch.source_ids.device
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)
        C = batch.source_ids.shape[0]
        pad = 0 if mesh is None else pad_to_multiple(C, mesh.size) - C
        padded = (lambda x: x) if not pad else (lambda x: _pad_rows(x, pad))
        T = batch.inject_mask.shape[1]
        H = self.text_model.config.hidden_size
        replay = noise_override is not None
        lrs = self.lr_values(replay)
        total = len(lrs) if hp.v_num_grad_steps else 0
        is_esd = hp.objective == "esd"
        noise_loss = not hp.no_noise_loss
        fresh_dest = noise_loss and not hp.use_sampled_noise
        if hp.use_ewc and self.fim is None:
            raise ValueError("use_ewc=True requires a FIM array")
        tia = None
        if dest_img_emb is not None:
            if self.text_projection is None:
                raise ValueError(
                    "txt_img_align requires a text_projection matrix "
                    "(hidden, embed) on the ZOptimizer")
            tia = (padded(_f32(dest_img_emb, dev)),
                   padded(torch.ones(C, device=dev) if tia_weight is None
                          else _f32(tia_weight, dev)))

        shards = self._shards(C + pad, mesh)
        rows = slice(shards[0].rows.start, shards[-1].rows.stop)
        full = ConceptBatch(*(padded(x) for x in batch))
        states = [self._prepare(sh, full, is_esd, tia) for sh in shards]
        z0 = gather([st["z0"] for st in states], dev, mesh)
        z0_norm = gather([st["z0_norm"] for st in states], dev, mesh)

        graphs = (stage1_graphs((self.text_model, self.unet),
                                self.graph_shapes(batch), mesh)
                  if noise_loss else None)
        pools = None
        if (self.eps_pool and total and not replay and noise_loss
                and not hp.use_sampled_noise):
            with span("stage1.pool"):
                pools = self._build_pool(shards, states, batch,
                                         int(self.eps_pool), gen, padded)
        if replay:
            noise_override = torch.as_tensor(noise_override, device=dev).float()
            ts_override = torch.as_tensor(ts_override, device=dev).long()

        delta = torch.zeros((C + pad, T, H), device=dev, requires_grad=True)
        m1 = torch.zeros_like(delta)
        m2 = torch.zeros_like(delta)
        max_norm = hp.clamp_norm_factor * z0_norm
        losses = []
        for step in each("stage1.step", range(total)):
            if pools is not None:
                P = batch.source_ids.shape[1]
                idx = padded(torch.randint(0, pools[0]["noisy"].shape[0],
                                           (C, P), generator=gen, device=dev))
            else:
                lat, noise, t = self._draw(batch, gen)
                if replay:
                    noise, t = noise_override[step], ts_override[step]
                lat, noise, t = padded(lat), padded(noise), padded(t)
            parts = []
            for k, (sh, st) in enumerate(zip(shards, states)):
                eps_dest = eps_src = noise_s = None
                if pools is not None:
                    pool = pools[k]
                    i = (idx[sh.rows].to(sh.device).flatten(),
                         torch.arange(st["C"] * idx.shape[1],
                                      device=sh.device))
                    noisy, t_s = pool["noisy"][i], pool["t"][i]
                    eps_dest = pool["eps_dest"][i]
                    if is_esd:
                        eps_src = pool["eps_src"][i]
                else:
                    noise_s = noise[sh.rows].to(sh.device)
                    noisy, t_s = self._noisy(lat[sh.rows].to(sh.device),
                                             noise_s, t[sh.rows].to(sh.device))
                    with torch.no_grad():
                        if fresh_dest:
                            eps_dest = self._eps(sh.unet, noisy, t_s,
                                                 st["dest_hidden"])
                        if noise_loss and is_esd:
                            eps_src = self._eps(sh.unet, noisy, t_s,
                                                st["source_hidden"])
                parts.append(self._loss(sh, st, delta[sh.rows].to(sh.device),
                                        noisy, t_s, noise_s, eps_dest,
                                        eps_src, graphs))
            count_step(graphs)
            loss = gather(parts, dev)
            grad, = torch.autograd.grad(loss.sum(), delta)
            # this process's rows of the gradient (no other row depends on
            # its shards), then every process's, in shard order
            grad = gather([grad[rows]], dev, mesh)
            loss = gather([loss.detach()], dev, mesh)
            with torch.no_grad():
                adam_step_(delta, m1, m2, grad, float(lrs[step]), step + 1)
                clamp_to_ball_(delta, max_norm)
            losses.append(loss.detach()[:C].mean())
        delta, z0 = delta.detach()[:C], z0[:C]
        losses = torch.stack(losses) if losses else torch.zeros(0, device=dev)
        return z0 + delta, delta, z0, losses


def compute_z_text_encoder_batch(
    text_model,
    unet,
    schedule: Schedule,
    tokenizer,
    requests: Sequence[Dict],
    hparams,
    layer: int,
    latents_mean: np.ndarray,
    latents_logvar: np.ndarray,
    gen: Optional[torch.Generator] = None,
    fim: Optional[np.ndarray] = None,
    verbose: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Prepare and run one concept block (the JAX package's convenience
    wrapper).  latents_mean/logvar: (C, Simg, P, h, w, c) scaled VAE
    posterior of the training images (``engine/training_images``); ``gen``
    seeds the draws on the text model's device (default seed 0).

    Returns (zs (C, T, H), loss curve (steps,)) as numpy."""
    arrays, _, _ = prepare_concept_batch(tokenizer, requests, hparams)
    arrays.update(latents_mean=latents_mean, latents_logvar=latents_logvar)
    dev = next(text_model.parameters()).device
    batch = concept_batch_to_device(arrays, dev)
    optz = ZOptimizer(text_model, unet, schedule, hparams, layer, fim=fim)
    zs, delta, z0, losses = optz.run(batch, gen)
    if verbose:
        C = zs.shape[0]
        final = (f"{float(losses[-1]):.6f}" if len(losses)
                 else "n/a (0 steps)")
        print(f"Init norm {float(z0.reshape(C, -1).norm(dim=-1).mean()):.3f}"
              f" | Delta norm "
              f"{float(delta.reshape(C, -1).norm(dim=-1).mean()):.3f} | "
              f"final loss {final}")
    return zs.cpu().numpy(), losses.cpu().numpy()
