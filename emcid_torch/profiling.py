"""Program spans, step-time and MFU accounting: ``span``/``phase`` and
their ``recording``, analytic FLOP counts of the UNet forward and of one
Stage-1 step, and ``StepReport``.

Spans.  ``span(name)`` marks a stretch of host code where the work of one
thing happens (``stage1.pool``; ``stage1.dest``, the no-grad dest forward
of one concept inside an SDXL Stage-1 step), ``each(name, items)`` each
iteration of a loop (``stage1.step``, ``sampler.step``), ``phase`` the
``edit.*`` phases of ``apply_emcid`` and ``apply_emcid_sdxl``; ``count``
adds to a named counter.  With
neither ``recording()`` nor a ``torch.profiler`` active ``span`` returns
one shared no-op object.  Under ``recording()`` a span keeps its host
edges (``perf_counter_ns``) and, on a CUDA device, a pair of timing
events at its edges, never synchronizing:
``Recorder.summary()`` reads the events after the caller's own
synchronize.  Under a ``torch.profiler`` it also opens
``record_function(name)``, so that the span lands in the profiler's trace
on its own clock, beside the device operations it launched.
``phase(name, timings, key)`` is a span that is always timed on the host
and adds its seconds to ``timings[key]``.

Counts (counterpart of ``emcid_tpu/profiling.py``).  The counts are useful
work: attention scores unpadded, GroupNorm, SiLU and the time/added-
condition MLPs (<1%) ignored.  A run divides them by its measured seconds
for TFLOP/s, and ``StepReport.mfu`` by the card's peak, ``PEAK_TFLOPS``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, TypeVar

import torch
import torch.autograd.profiler as _autograd_profiler

T = TypeVar("T")


class Recorder:
    """The spans closed and the counts made inside a ``recording()``
    scope."""

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available()
            else torch.device("cpu"))
        self.device = dev if dev.type == "cuda" else None
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}

    def summary(self) -> Dict[str, Dict]:
        """Per span name: ``n``, ``host_s`` (each span's host-clock
        seconds, in closing order) and ``device_s`` (the same spans on the
        device clock, between their events; None without a CUDA device).
        Per counter name (``count``): ``n``, its total, with ``host_s`` []
        and ``device_s`` None.  Call it after synchronizing the device."""
        out: Dict[str, Dict] = {}
        for s in self.spans:
            d = out.setdefault(s.name, {
                "n": 0, "host_s": [],
                "device_s": None if self.device is None else []})
            d["n"] += 1
            d["host_s"].append(s.seconds)
            if d["device_s"] is not None:
                d["device_s"].append(s.ev0.elapsed_time(s.ev1) * 1e-3)
        for name, n in self.counts.items():
            out[name] = {"n": n, "host_s": [], "device_s": None}
        return out


_RECORDER: Optional[Recorder] = None


@contextlib.contextmanager
def recording(device=None) -> Iterator[Recorder]:
    """Record every span closed in the scope; yields the ``Recorder``.
    Events are taken on ``device`` (default: the CUDA device when there is
    one).  A recording opened inside another hands its spans to the outer
    one when it closes."""
    global _RECORDER
    outer, rec = _RECORDER, Recorder(device)
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = outer
        if outer is not None:
            outer.spans.extend(rec.spans)
            for name, n in rec.counts.items():
                outer.counts[name] = outer.counts.get(name, 0) + n


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the recording in scope (none:
    nothing).  Stage 1 (``engine/compute_z``) counts its steps that
    replayed CUDA graphs, ``stage1.graph_steps``, and its eager ones,
    ``stage1.eager_steps``, and the eps_dest pool's UNet calls,
    ``stage1.pool_calls``; each capture is a ``stage1.capture`` span."""
    if _RECORDER is not None:
        _RECORDER.counts[name] = _RECORDER.counts.get(name, 0) + n


class _Off:
    """The span of a scope with neither a recording nor a profiler."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One span: host edges always, device events under a recording on a
    CUDA device, a profiler range under a profiler."""

    __slots__ = ("name", "rec", "t0", "t1", "ev0", "ev1", "fn")

    def __init__(self, name: str, rec: Optional[Recorder]):
        self.name, self.rec = name, rec
        self.ev0 = self.ev1 = self.fn = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.fn = _autograd_profiler.record_function(self.name)
            self.fn.__enter__()
        if self.rec is not None and self.rec.device is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(self.rec.device))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(torch.cuda.current_stream(self.rec.device))
        if self.fn is not None:
            self.fn.__exit__(*exc)
        if self.rec is not None:
            self.rec.spans.append(self)
        return False

    @property
    def seconds(self) -> float:
        """Host-clock seconds between the edges."""
        return (self.t1 - self.t0) * 1e-9


def span(name: str):
    """A context object for the work of ``name``: ``OFF`` unless a
    recording or a profiler is on."""
    rec = _RECORDER
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return OFF
    return Span(name, rec)


def each(name: str, items: Iterable[T]) -> Iterator[T]:
    """``items``, each iteration of the loop that consumes them inside the
    span ``name``: ``for step in each("stage1.step", range(n)):``."""
    for x in items:
        with span(name):
            yield x


class _Phase(Span):
    __slots__ = ("timings", "key")

    def __init__(self, name, timings, key):
        super().__init__(name, _RECORDER)
        self.timings, self.key = timings, key

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self.timings is not None:
            self.timings[self.key] = (self.timings.get(self.key, 0.0)
                                      + self.seconds)
        return False


def phase(name: str, timings: Optional[Dict[str, float]], key: str) -> Span:
    """The span ``name``, always timed on the host: on exit its seconds are
    added to ``timings[key]`` (when ``timings`` is given)."""
    return _Phase(name, timings, key)


# dense bf16 tensor-core peak of one NVIDIA H100 SXM (data sheet)
PEAK_TFLOPS = 989.0


def _conv(cin: int, cout: int, hw: int, k: int = 3) -> float:
    return 2.0 * k * k * cin * cout * hw * hw


def _lin(n: int, cin: int, cout: int) -> float:
    return 2.0 * n * cin * cout


def _resnet(cin: int, cout: int, hw: int, temb_dim: int) -> float:
    f = _conv(cin, cout, hw) + _conv(cout, cout, hw) + 2.0 * temb_dim * cout
    if cin != cout:
        f += _conv(cin, cout, hw, k=1)  # conv_shortcut
    return f


def _transformer(c: int, hw: int, depth: int, ctx_len: int,
                 ctx_dim: int) -> float:
    """Transformer2D: proj in/out + depth x (self-attention,
    cross-attention, GEGLU feed-forward)."""
    N = hw * hw
    f = 2.0 * _lin(N, c, c)  # proj_in + proj_out
    per = (
        4.0 * _lin(N, c, c) + 2.0 * 2.0 * N * N * c              # self
        + 2.0 * _lin(N, c, c) + 2.0 * _lin(ctx_len, ctx_dim, c)  # cross qo/kv
        + 2.0 * 2.0 * N * ctx_len * c                            # cross scores
        + _lin(N, c, 8 * c) + _lin(N, 4 * c, c)                  # GEGLU FF
    )
    return f + depth * per


def unet_fwd_flops(config, batch: int, latent_hw: Optional[int] = None,
                   context_len: int = 77) -> float:
    """FLOPs of one UNet forward over ``batch`` latents of side
    ``latent_hw`` (default the config's ``sample_size``), walked from the
    config's levels as ``models/unet.py`` builds them."""
    s = latent_hw or config.sample_size
    ch = config.block_out_channels
    L = config.layers_per_block
    n_levels = len(ch)
    temb_dim = 4 * ch[0]
    ctx_dim = config.cross_attention_dim
    tdepth = config.transformer_layers_per_block

    f = _conv(config.in_channels, ch[0], s)  # conv_in
    skips = [ch[0]]
    hw = s
    cur = ch[0]
    for lvl, block_type in enumerate(config.down_block_types):
        out_ch = ch[lvl]
        has_attn = block_type == "CrossAttnDownBlock2D"
        for _ in range(L):
            f += _resnet(cur, out_ch, hw, temb_dim)
            cur = out_ch
            if has_attn:
                f += _transformer(out_ch, hw, tdepth[lvl], context_len,
                                  ctx_dim)
            skips.append(out_ch)
        if lvl < n_levels - 1:
            hw //= 2
            f += _conv(out_ch, out_ch, hw)  # strided downsample
            skips.append(out_ch)

    mid_ch = ch[-1]
    f += 2.0 * _resnet(mid_ch, mid_ch, hw, temb_dim)
    f += _transformer(mid_ch, hw, tdepth[-1], context_len, ctx_dim)

    rev_ch = list(reversed(ch))
    for lvl, block_type in enumerate(config.up_block_types):
        out_ch = rev_ch[lvl]
        has_attn = block_type == "CrossAttnUpBlock2D"
        for _ in range(L + 1):
            skip = skips.pop()
            f += _resnet(cur + skip, out_ch, hw, temb_dim)
            cur = out_ch
            if has_attn:
                f += _transformer(out_ch, hw, tdepth[n_levels - 1 - lvl],
                                  context_len, ctx_dim)
        if lvl < n_levels - 1:
            hw *= 2
            f += _conv(out_ch, out_ch, hw)  # post-upsample conv
    f += _conv(ch[0], config.out_channels, s)  # conv_out
    return f * batch


def stage1_step_flops(config, n_concepts: int, n_prompts: int,
                      latent_hw: Optional[int] = None,
                      eps_dest_pooled: bool = False) -> float:
    """FLOPs of one Stage-1 step for a block: three UNet forwards' worth
    (the edited forward, its backward into the input only, ~1 forward, and
    the eps_dest forward; two with ``eps_dest_pooled``, where the eps_dest
    forwards were made once over a pool).  Text-encoder work (<2%) is
    ignored."""
    fwd_equiv = 2.0 if eps_dest_pooled else 3.0
    return fwd_equiv * unet_fwd_flops(config, n_concepts * n_prompts,
                                      latent_hw)


@dataclass
class StepReport:
    """ms per step, TFLOP/s and MFU of ``steps`` steps of
    ``flops_per_step`` in ``seconds``."""

    seconds: float
    steps: int
    flops_per_step: float

    @property
    def ms_per_step(self) -> float:
        return self.seconds / max(self.steps, 1) * 1e3

    @property
    def tflops(self) -> float:
        return self.flops_per_step * self.steps / self.seconds / 1e12

    @property
    def mfu(self) -> float:
        return self.tflops / PEAK_TFLOPS

    def __str__(self) -> str:
        return (f"{self.ms_per_step:.0f} ms/step, "
                f"{self.tflops:.1f} TFLOP/s ({self.mfu * 100:.0f}% MFU)")
