"""What every driver shares: the run's context, the program's models built
from the benchmark's weights, scoped wrappers around module attributes,
and the per-layer readers."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import weights

ROOT = Path(__file__).resolve().parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Context:
    """One run of one cell."""

    cell: str
    cfg: Dict  # the configuration file
    traffic: Dict  # the traffic file
    limits: Dict[str, float]  # the cell's limits file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tmp: Path  # under TMPDIR, this run's scratch
    t_start: float  # process start, host clock
    dtype: torch.dtype = torch.bfloat16
    facts: Dict[str, Any] = field(default_factory=dict)

    def rng(self, *stream: int) -> np.random.Generator:
        """An independent stream of this run's seed."""
        return np.random.default_rng([self.seed, *stream])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def text_config(c: Dict):
    from emcid_torch.models.configs import CLIPTextConfig

    return CLIPTextConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        max_position_embeddings=c["max_position_embeddings"],
        layer_norm_eps=c.get("layer_norm_eps", 1e-5),
        hidden_act=c["hidden_act"], projection_dim=c.get("projection_dim"),
        eos_token_id=c["eos_token_id"])


def port_modules(ctx: Context) -> Dict[str, torch.nn.Module]:
    """The program's modules, built without storage from the configuration
    and given the benchmark's weights (a copy of each tensor)."""
    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.configs import (
        unet_config_from_diffusers,
        vae_config_from_diffusers,
    )
    from emcid_torch.models.unet import UNet2DCondition
    from emcid_torch.models.vae import AutoencoderKL

    builders = {
        "text_encoder": lambda c: CLIPTextEncoder(text_config(c)),
        "text_encoder_2": lambda c: CLIPTextEncoder(text_config(c)),
        "unet": lambda c: UNet2DCondition(unet_config_from_diffusers(c)),
        "vae": lambda c: AutoencoderKL(vae_config_from_diffusers(c)),
    }
    state = weights.make(ctx.cfg, ctx.seed, ctx.device, ctx.dtype)
    out = {}
    for key, sd in state.items():
        with torch.device("meta"):
            m = builders[key](ctx.cfg[key])
        m.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True,
                          assign=True)
        out[key] = m.eval().requires_grad_(False)
    del state
    return out


def reference_params(ctx: Context) -> Dict[str, torch.Tensor]:
    """The same weights, drawn again, for the reference."""
    return weights.reference_params(
        weights.make(ctx.cfg, ctx.seed, ctx.device, ctx.dtype), ctx.cfg)


@contextlib.contextmanager
def wrapped(target, name: str, make: Callable[[Callable], Callable]):
    """``target.name`` replaced by ``make(original)`` inside the scope."""
    orig = getattr(target, name)
    setattr(target, name, make(orig))
    try:
        yield
    finally:
        setattr(target, name, orig)


@contextlib.contextmanager
def host_spans(ctx: Context, sites: List[tuple], spans: Dict[str, float],
               annotate: bool = False):
    """Seconds spent in each (target, attribute) of ``sites``, summed into
    ``spans`` under the attribute's name, each call ended by a device
    synchronize; with ``annotate`` also a profiler range of that name."""
    from torch.profiler import record_function

    def make(name):
        def wrap(orig):
            def f(*a, **k):
                t = time.perf_counter()
                if annotate:
                    with record_function(name):
                        out = orig(*a, **k)
                        ctx.sync()
                else:
                    out = orig(*a, **k)
                    ctx.sync()
                spans[name] = spans.get(name, 0.0) + time.perf_counter() - t
                return out
            return f
        return wrap

    with contextlib.ExitStack() as stack:
        for target, attr in sites:
            stack.enter_context(wrapped(target, attr, make(attr)))
        yield spans


def per_layer(ctx: Context, metrics: List[Dict]) -> Dict[str, Dict]:
    """The values of ``metrics`` (BENCHMARK.json entries) that their
    readers find in this run's facts."""
    out = {}
    for m in metrics:
        path = ROOT / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx.facts)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def fma_launches() -> int:
    """K1-K4 launches on a float-FMA route since the last reset: a bf16
    run must take the tensor-core routes."""
    from emcid_torch.ops import _build

    return sum(_build.ROUTES[k].get("fma", 0) for k in (
        "K1 flash_v2_fwd", "K2 flash_v2_dq", "K3 flash_v2_dkv",
        "K4 short_kv_fwd"))


def free_cuda(ctx: Context) -> None:
    import gc

    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(ctx: Context) -> Optional[int]:
    if ctx.device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(ctx.device))
