#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python3 scripts/torch_prof_main_path.py [--out results/prof_main_path.json]
    EMCID_TPU_FUSED_GN=1 EMCID_TPU_FUSED_LN=1 python3 scripts/torch_prof_main_path.py

Runs ``apply_emcid`` on the full-width SD-v1.4 pipeline (random bf16
weights) with the configuration ``chip_smoke.py`` drives (4 concepts x 3
prompts, 50 Stage-1 steps, DPM++ at 10 steps, 384 px, synthetic-corpus
covariances) three times: once to build the kernels and warm the allocator
and cuDNN, once timed on the host clock, and once under ``torch.profiler``.
Prints one JSON object: the phase times of the timed and the profiled run,
the device time of each hand-written kernel and of the other kernels
grouped by name, and the device's busy share of the timed run's wall time
(busy = the sum of the device time of every kernel in the profiled run;
they run one at a time on the one stream).  The norm knobs come from the
environment and are printed with the result; beside the hand-written
kernels it sums PyTorch's own GroupNorm/LayerNorm kernels and the SiLU
kernels, which the fused norms (K5/K6) replace at the UNet's sites.  The
top kernels go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# substrings of the demangled names of the kernels of emcid_torch/csrc
# (they live in an anonymous namespace): the tensor-core and the float-FMA
# kernel of each wrapper
OWN_KERNELS = {
    "K1 flash_v2_fwd": ("namespace)::fwd_tc_kernel", "namespace)::fwd_kernel"),
    "K2 flash_v2_dq": ("namespace)::dq_tc_kernel", "namespace)::dq_kernel"),
    "K3 flash_v2_dkv": ("namespace)::dkv_tc_kernel", "namespace)::dkv_kernel"),
    "K4 short_kv_fwd": ("namespace)::short_kv_kernel",),
    "K5f groupnorm_fwd": ("namespace)::gn_fwd_kernel",),
    "K5b groupnorm_bwd": ("namespace)::gn_bwd_kernel",),
    "K6f layernorm_fwd": ("namespace)::ln_fwd_kernel",),
    "K6b layernorm_bwd": ("namespace)::ln_bwd_kernel",),
}
# substrings of PyTorch's native GroupNorm/LayerNorm kernels (statistics,
# fused parameters, the normalise pass, the gradients) and of its SiLU
STOCK = {
    "stock GroupNorm/LayerNorm": (
        "RowwiseMoments", "ComputeFusedParams", "GroupNorm", "group_norm",
        "LayerNorm", "layer_norm", "ComputeInternalGradients",
        "ComputeBackwardFusedParams", "GammaBeta", "ComputeGradOutput"),
    "stock SiLU": ("silu",),
}
KNOBS = ("EMCID_TPU_FUSED_GN", "EMCID_TPU_FUSED_LN")


def run_once(torch, comps, hp, requests, stats_dir):
    from emcid_torch.engine.editor import apply_emcid

    timings = {}
    torch.cuda.synchronize()
    t0 = time.time()
    apply_emcid(comps, requests, hp, stats_dir=stats_dir,
                num_inference_steps=10, timings=timings, verbose=False)
    torch.cuda.synchronize()
    return time.time() - t0, timings


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/prof_main_path.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import bench_hparams, nvidia_smi_line
    from emcid_torch.models.loader import build_random_pipeline

    comps = build_random_pipeline("sd-v1.4", dtype=torch.bfloat16, seed=0,
                                  device="cuda")
    hp = bench_hparams(50)
    requests = [{"prompts": ["a photo of a {}", "an image of a {}", "{}"],
                 "source": f"w{i}", "dest": f"w{i + 1}", "seed_train": i}
                for i in range(4)]
    with tempfile.TemporaryDirectory() as tmp:
        warm_s, _ = run_once(torch, comps, hp, requests,
                             os.path.join(tmp, "warm"))
        timed_s, timed = run_once(torch, comps, hp, requests,
                                  os.path.join(tmp, "timed"))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_s, timings = run_once(torch, comps, hp, requests,
                                       os.path.join(tmp, "prof"))
    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[evt.key][0] += dev_us / 1e3
        by_name[evt.key][1] += evt.count
    busy_ms = sum(ms for ms, _ in by_name.values())
    def group(table):
        out = {}
        for label, subs in table.items():
            hits = [v for k, v in by_name.items()
                    if any(x in k for x in subs)]
            out[label] = dict(ms=sum(v[0] for v in hits),
                              calls=sum(v[1] for v in hits))
        return out

    own = group(OWN_KERNELS)
    own_ms = sum(v["ms"] for v in own.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    result = dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi_line(),
        knobs={k: os.environ.get(k, "0") for k in KNOBS},
        warm_run_s=warm_s, timed_wall_s=timed_s, timed_phases_s=timed,
        profiled_wall_s=wall_s, profiled_phases_s=timings,
        device_busy_ms=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / (timed_s * 1e3)),
        own_kernels=own, own_kernels_ms=own_ms,
        own_kernels_share_of_busy=own_ms / busy_ms if busy_ms else None,
        stock_kernels=group(STOCK),
        top_kernels=[dict(name=k[:120], ms=v[0], calls=v[1])
                     for k, v in top])
    out = REPO / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items()
                      if k != "top_kernels"}))
    for row in result["top_kernels"][:12]:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
