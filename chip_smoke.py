#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``emcid_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card, its power limit, the kernel build time;
2. one phase per hand-written kernel (K1-K4) at the shapes the main path
   gives it: the kernel against its plain PyTorch version on the same
   inputs (bf16 at the product shapes, f32 at one small shape), and the
   kernel's, the plain version's and one library call's time beside the
   least time the card could take (``bound_ms``);
3. the main path: ``apply_emcid`` on the full-width SD-v1.4 pipeline
   (random weights from a seed) in bf16, 4 concepts in one block, with the
   launch count of every kernel during that run, the phase times, and
   checks of what comes out (finite z and deltas, only the fc2 weights of
   the edited layers changed, the on-card Stage-2 solve against the host
   float64 one);
4. a model check: that pipeline's UNet in f32 at the Stage-1 shape, with
   its attention through the kernels against the plain attention path,
   for eps and for the gradient into the text context.

Then the kernel table line and, last, the device line the harness reads.
Exits non-zero, and prints no result, when there is no CUDA device, when
the port cannot be imported, or when any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data-sheet peaks (dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its flops over the rate of
# its input type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

SOURCES = {
    "K1 flash_v2_fwd": ("emcid_torch/csrc/flash_v2.cu",
                        "emcid_tpu/ops/flash_v2.py:104"),
    "K2 flash_v2_dq": ("emcid_torch/csrc/flash_v2.cu",
                       "emcid_tpu/ops/flash_v2.py:200"),
    "K3 flash_v2_dkv": ("emcid_torch/csrc/flash_v2.cu",
                        "emcid_tpu/ops/flash_v2.py:232"),
    "K4 short_kv_fwd": ("emcid_torch/csrc/short_kv.cu",
                        "emcid_tpu/ops/attention.py:82"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, ref) -> tuple:
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, err / max(scale, 1e-30)


def qkv(B, N, M, H, D, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda L: torch.randn(B, L, H, D, generator=g, device="cuda",
                               dtype=torch.float32).to(dtype)
    return mk(N), mk(M), mk(M)


# tolerances, relative to the largest reference magnitude: bf16 outputs are
# rounded to 8 mantissa bits (2^-9 relative) after f32 accumulation in both
# versions, which sum in different orders; f32 differs only by order
TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}


def product_shape(N, dtype) -> bool:
    """Timed rows: bf16 at the main path's sequence lengths (the small
    shapes check the ragged edges only)."""
    import torch

    return dtype == torch.bfloat16 and N >= 1024


def check(name, got, ref, dtype, shape, failures):
    err, rel = rel_err(got, ref)
    ok = rel <= TOL[str(dtype)]
    if not ok:
        failures.append(f"{name} at {shape} {dtype}: rel err {rel:.3g}")
    return err, rel, ok


def phase_flash_fwd(torch, shapes, failures):
    from emcid_torch.ops import flash_v2 as fv2
    import torch.nn.functional as F

    rows = []
    for (B, N, H, D), dtype in shapes:
        q, k, v = qkv(B, N, N, H, D, dtype, seed=1)
        s = D ** -0.5
        o, lse = fv2.flash_fwd(q, k, v, s)
        o_ref, lse_ref = fv2.flash_fwd_plain(q, k, v, s)
        err, rel, ok = check("K1", o, o_ref, dtype, (B, N, H, D), failures)
        lse_err, lse_rel, lse_ok = check("K1 lse", lse, lse_ref,
                                         torch.float32 if dtype == torch.float32
                                         else dtype, (B, N, H, D), failures)
        row = dict(phase="kernel", kernel="K1 flash_v2_fwd",
                   shape=[B, N, H, D], dtype=str(dtype), max_abs_err=err,
                   rel_err=rel, lse_rel_err=lse_rel,
                   tolerance=TOL[str(dtype)], ok=ok and lse_ok)
        if product_shape(N, dtype):
            elem = q.element_size()
            flops = 4.0 * B * H * N * N * D
            nbytes = 4.0 * B * N * H * D * elem + B * H * N * 4
            row["bound_ms"], row["bound_by"] = bound(flops, nbytes, dtype)
            row["kernel_ms"] = cuda_ms(lambda: fv2.flash_fwd(q, k, v, s), 5)
            row["plain_ms"] = cuda_ms(lambda: fv2.flash_fwd_plain(q, k, v, s), 2, 1)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=s), 5)
        emit(row)
        rows.append(row)
        del q, k, v, o, o_ref, lse, lse_ref
        torch.cuda.empty_cache()
    return rows


def phase_flash_bwd(torch, shapes, failures):
    from emcid_torch.ops import flash_v2 as fv2
    import torch.nn.functional as F

    rows = []
    for (B, N, H, D), dtype in shapes:
        q, k, v = qkv(B, N, N, H, D, dtype, seed=2)
        g = torch.Generator(device="cuda").manual_seed(3)
        dout = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        s = D ** -0.5
        o, lse = fv2.flash_fwd(q, k, v, s)
        delta = fv2.row_delta(o, dout)
        dq = fv2.flash_dq(q, k, v, dout, lse, delta, s)
        dk, dv = fv2.flash_dkv(q, k, v, dout, lse, delta, s)
        dq_ref = fv2.flash_dq_plain(q, k, v, dout, lse, delta, s)
        dk_ref, dv_ref = fv2.flash_dkv_plain(q, k, v, dout, lse, delta, s)
        # through the autograd.Function against plain autograd of the
        # einsum/softmax attention, in f32 from the same inputs
        qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
        fv2.flash_attention_v2(qa, ka, va, s).backward(dout)
        qr, kr, vr = (t.detach().float().requires_grad_() for t in (q, k, v))
        p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qr, kr) * s, -1)
        torch.einsum("bhnm,bmhd->bnhd", p, vr).backward(dout.float())
        del p
        shape = (B, N, H, D)
        res = {}
        for label, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                                ("dv", dv, dv_ref),
                                ("autograd_dq", qa.grad, qr.grad),
                                ("autograd_dk", ka.grad, kr.grad),
                                ("autograd_dv", va.grad, vr.grad)):
            res[label] = check(label, got, ref, dtype, shape, failures)
        common = dict(phase="kernel", shape=[B, N, H, D], dtype=str(dtype),
                      tolerance=TOL[str(dtype)])
        k2 = dict(common, kernel="K2 flash_v2_dq", max_abs_err=res["dq"][0],
                  rel_err=res["dq"][1], autograd_rel_err=res["autograd_dq"][1],
                  ok=res["dq"][2] and res["autograd_dq"][2])
        k3 = dict(common, kernel="K3 flash_v2_dkv",
                  max_abs_err=max(res["dk"][0], res["dv"][0]),
                  rel_err=max(res["dk"][1], res["dv"][1]),
                  autograd_rel_err=max(res["autograd_dk"][1],
                                       res["autograd_dv"][1]),
                  ok=all(res[x][2] for x in ("dk", "dv", "autograd_dk",
                                             "autograd_dv")))
        if product_shape(N, dtype):
            elem = q.element_size()
            nm = float(B) * H * N * N * D
            row_b = 2.0 * B * H * N * 4  # lse, delta
            k2["bound_ms"], k2["bound_by"] = bound(
                6 * nm, 5.0 * B * N * H * D * elem + row_b, dtype)
            k3["bound_ms"], k3["bound_by"] = bound(
                8 * nm, 6.0 * B * N * H * D * elem + row_b, dtype)
            k2["kernel_ms"] = cuda_ms(
                lambda: fv2.flash_dq(q, k, v, dout, lse, delta, s), 5)
            k3["kernel_ms"] = cuda_ms(
                lambda: fv2.flash_dkv(q, k, v, dout, lse, delta, s), 5)
            k2["plain_ms"] = cuda_ms(
                lambda: fv2.flash_dq_plain(q, k, v, dout, lse, delta, s), 2, 1)
            k3["plain_ms"] = cuda_ms(
                lambda: fv2.flash_dkv_plain(q, k, v, dout, lse, delta, s), 2, 1)
            # library yardstick: one backward of SDPA (dq, dk and dv together)
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, scale=s)
            gt = dout.transpose(1, 2).contiguous()
            lib = cuda_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), gt, retain_graph=True), 5)
            k2["library_ms"] = k3["library_ms"] = lib
            k2["library_note"] = k3["library_note"] = "SDPA backward (dq, dk, dv)"
        emit(k2)
        emit(k3)
        rows += [k2, k3]
        torch.cuda.empty_cache()
    return rows


def phase_short_kv(torch, shapes, failures):
    from emcid_torch.ops import attention as att
    import torch.nn.functional as F

    rows = []
    for (B, N, M, H, D), dtype in shapes:
        q, k, v = qkv(B, N, M, H, D, dtype, seed=4)
        s = D ** -0.5
        o = att.short_kv_fwd(q, k, v, s)
        ref = att.short_kv_fwd_plain(q, k, v, s)
        err, rel, ok = check("K4", o, ref, dtype, (B, N, M, H, D), failures)
        row = dict(phase="kernel", kernel="K4 short_kv_fwd",
                   shape=[B, N, M, H, D], dtype=str(dtype), max_abs_err=err,
                   rel_err=rel, tolerance=TOL[str(dtype)], ok=ok)
        if product_shape(N, dtype):
            elem = q.element_size()
            row["bound_ms"], row["bound_by"] = bound(
                4.0 * B * H * N * M * D,
                (2.0 * B * N + 2.0 * B * M) * H * D * elem, dtype)
            row["kernel_ms"] = cuda_ms(lambda: att.short_kv_fwd(q, k, v, s), 10)
            row["plain_ms"] = cuda_ms(
                lambda: att.short_kv_fwd_plain(q, k, v, s), 5)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=s), 10)
        emit(row)
        rows.append(row)
    return rows


def kernel_phases(torch, failures):
    bf, f32 = torch.bfloat16, torch.float32
    rows = []
    rows += phase_flash_fwd(torch, [
        ((2, 300, 2, 40), f32), ((2, 300, 2, 80), f32),
        ((1, 300, 1, 512), f32), ((2, 300, 2, 40), bf), ((2, 300, 2, 80), bf),
        ((24, 2304, 8, 40), bf), ((4, 2304, 1, 512), bf),
        ((24, 4096, 8, 40), bf)], failures)
    rows += phase_flash_bwd(torch, [((2, 300, 2, 40), f32),
                                    ((2, 300, 2, 80), f32),
                                    ((2, 300, 2, 40), bf), ((2, 300, 2, 80), bf),
                                    ((12, 2304, 8, 40), bf)], failures)
    rows += phase_short_kv(torch, [((2, 300, 77, 2, 40), f32),
                                   ((24, 2304, 77, 8, 40), bf)], failures)
    return rows


def bench_hparams(grad_steps: int):
    """The product hparams the JAX package's bench times (bench.py)."""
    from emcid_torch.hparams import EMCIDHyperParams

    return EMCIDHyperParams.from_dict({
        "layers": [7, 8, 9, 10], "clamp_norm_factor": 1.5,
        "layer_selection": "all", "fact_token": "subject_last",
        "v_num_grad_steps": grad_steps, "v_lr": 0.2,
        "v_weight_decay": 5e-4, "mom2_adjustment": True,
        "mom2_update_weight": 4000,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 100000,
        "mom2_dtype": "float32", "objective": "ablate-dest",
        "esd_mu": "None", "cal_text_repr_loss": True,
        "text_repr_loss_scale_factor": 0.01,
    })


def main_path(torch, failures):
    """apply_emcid on the full-width SD-v1.4 pipeline: 4 concepts in one
    block, 50 Stage-1 steps (cosine schedule: 30 run; the K=25 eps_dest
    pool engages), DPM++ training images at 10 steps (CFG interval 0.6) at
    384 px, covariances over the 2000-caption synthetic corpus."""
    import numpy as np

    from emcid_torch.engine.editor import apply_emcid
    from emcid_torch.engine.emcid import execute_emcid_text_encoder, load_z_list
    from emcid_torch.models.loader import build_random_pipeline
    from emcid_torch.ops import _build

    t0 = time.time()
    comps = build_random_pipeline("sd-v1.4", dtype=torch.bfloat16, seed=0,
                                  device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    hp = bench_hparams(50)
    requests = [{"prompts": ["a photo of a {}", "an image of a {}", "{}"],
                 "source": f"w{i}", "dest": f"w{i + 1}", "seed_train": i}
                for i in range(4)]
    with tempfile.TemporaryDirectory() as tmp:
        cache_name = os.path.join(tmp, "z", "")
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.time()
        edited, deltas = apply_emcid(
            comps, requests, hp, stats_dir=os.path.join(tmp, "stats"),
            cache_name=cache_name, num_inference_steps=10, timings=timings,
            verbose=False)
        torch.cuda.synchronize()
        total_s = time.time() - t0
        launches = dict(_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        z_list, missing = load_z_list(requests, cache_name, hp)
    zs = np.stack(z_list)
    # reference on the same inputs: Stage 2 on the card (f32 Cholesky +
    # refinement) against the host float64 solve, with well-conditioned
    # seeded covariances (as the JAX package's bench uses); the first edited
    # layer sees identical keys in both modes, so its update differs only by
    # the solve
    g = torch.Generator(device="cuda").manual_seed(5)
    inter = comps.text_encoder.config.intermediate_size
    covs = []
    for _ in hp.layers:
        a = torch.randn(2 * inter, inter, generator=g, device="cuda")
        covs.append(a.T @ a / a.shape[0])
    stage2 = {}
    for method in ("f32_ir", "f64"):
        d, _ = execute_emcid_text_encoder(
            comps.text_encoder, comps.tokenizer, requests, hp, zs=zs,
            covs=covs, solve_method=method, verbose=False)
        stage2[method] = {k: a @ r.T for k, (a, r) in d.items()}
    rel = {k: float(np.linalg.norm(stage2["f32_ir"][k] - v)
                    / np.linalg.norm(v)) for k, v in stage2["f64"].items()}
    first = f"{hp.rewrite_module_tmp.format(hp.layers[0])}.weight"
    before = dict(comps.text_encoder.named_parameters())
    changed = sorted(k for k, v in edited.text_encoder.named_parameters()
                     if not torch.equal(v, before[k]))
    expect = sorted(f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                    for i in hp.layers)
    row = dict(
        phase="main_path", model="sd-v1.4 (full width, random weights, bf16)",
        concepts=len(requests), prompts=3, grad_steps=hp.v_num_grad_steps,
        gen_steps=10, train_res=384, build_pipeline_s=build_s,
        total_s=total_s, **{f"{k}_s": v for k, v in timings.items()},
        peak_mem_gb=peak_gb, launches=launches, z_shape=list(zs.shape),
        z_finite=bool(np.isfinite(zs).all() and not missing),
        deltas_finite=all(np.isfinite(a).all() and np.isfinite(r).all()
                          for a, r in deltas.values()),
        changed_params=changed, only_fc2_of_edit_layers=changed == expect,
        stage2_f32_ir_vs_f64_rel=rel, stage2_rel_tolerance=1e-3)
    row["ok"] = (row["z_finite"] and row["deltas_finite"]
                 and row["only_fc2_of_edit_layers"] and rel[first] < 1e-3
                 and all(n > 0 for n in launches.values()))
    emit(row)
    if not row["ok"]:
        failures.append(f"main path: {row}")
    return launches, comps


# f32 on both sides under precise_matmuls (no TF32); the two differ only in
# the order of their sums, through some thirty attention and conv layers
MODEL_TOL = 1e-3


def model_check(torch, comps, failures):
    """The main path's UNet at the Stage-1 shape (48x48 latents, 77-token
    context), in f32: attention through the kernels (K1-K4) against the
    same UNet with every attention on the plain einsum/softmax path, for
    eps and for the gradient of a loss with respect to the text context
    (Stage 1's gradient path: K2/K3 and K4's chunked backward)."""
    import copy

    from emcid_torch.ops import _build
    from emcid_torch.runtime import precise_matmuls

    unet = copy.deepcopy(comps.unet).float()
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(2, 4, 48, 48, generator=g, device="cuda")
    t = torch.tensor([500, 20], device="cuda")
    ctx0 = torch.randn(2, 77, unet.config.cross_attention_dim, generator=g,
                       device="cuda")
    w = torch.randn(2, 4, 48, 48, generator=g, device="cuda")

    def eps_and_grad():
        ctx = ctx0.clone().requires_grad_()
        eps = unet(x, t, ctx).sample
        grad, = torch.autograd.grad((eps * w).sum(), ctx)
        return eps.detach(), grad

    key = "EMCID_TPU_FLASH_MIN_SEQ"
    prev = os.environ.get(key)
    with precise_matmuls():
        _build.reset_launches()
        eps_k, grad_k = eps_and_grad()
        launches = dict(_build.LAUNCHES)
        os.environ[key] = str(10 ** 9)  # every attention on the plain path
        try:
            eps_p, grad_p = eps_and_grad()
        finally:
            if prev is None:
                del os.environ[key]
            else:
                os.environ[key] = prev
    _, eps_rel = rel_err(eps_k, eps_p)
    _, grad_rel = rel_err(grad_k, grad_p)
    row = dict(phase="model_check", what="sd-v1.4 UNet f32, B=2, 48x48, "
               "kernels vs plain attention", eps_rel_err=eps_rel,
               ctx_grad_rel_err=grad_rel, tolerance=MODEL_TOL,
               launches=launches)
    row["ok"] = (eps_rel <= MODEL_TOL and grad_rel <= MODEL_TOL
                 and all(n > 0 for n in launches.values())
                 and bool(torch.isfinite(eps_k).all()))
    emit(row)
    if not row["ok"]:
        failures.append(f"model check: {row}")
    del unet
    torch.cuda.empty_cache()


def kernel_table(rows, launches):
    """One entry per kernel: the product-shape bf16 measurement of the
    shape the main path gives it first."""
    table = []
    for name, (source, replaces) in SOURCES.items():
        timed = [r for r in rows if r["kernel"] == name and "kernel_ms" in r]
        r = timed[0]
        table.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches.get(name, 0),
            max_abs_err=max(x["max_abs_err"] for x in rows
                            if x["kernel"] == name),
            ms=r["kernel_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"]))
    return table


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from emcid_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    t0 = time.time()
    _build.lib()
    emit(dict(phase="device", name=torch.cuda.get_device_name(0),
              nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, kernel_build_s=time.time() - t0))
    failures = []
    rows = kernel_phases(torch, failures)
    launches, comps = main_path(torch, failures)
    model_check(torch, comps, failures)
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    emit({"kernels": kernel_table(rows, launches)})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
