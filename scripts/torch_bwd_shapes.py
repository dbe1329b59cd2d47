#!/usr/bin/env python3
"""Time K2/K3's ``mma`` route at other block shapes, on one NVIDIA GPU.

    python3 scripts/torch_bwd_shapes.py [--out chiprun_out/bwd_shapes.json]

Each variant below overrides members of the block-shape struct ``BwdMma``
in ``emcid_torch/csrc/flash_v2.cu`` (C++ expressions of ``D``, ``DKV`` and
``kNarrow``).  The variants are built with nvcc into
``build/bwd_shapes/<name>/`` (one nvcc each, all started together), then
each one's ``emcid_flash_dq_mma`` and ``emcid_flash_dkv_mma`` run at the
main path's Stage-1 shape (12, 2304, 8, 40) in bf16: checked against the
plain versions (1e-2 of the largest value) and timed with CUDA events as
``chip_smoke.py`` times the kernels.  Prints one JSON line per variant:
ms of K2 and K3, their registers and spill bytes at D = 40 (``ptxas -v``),
and the SDPA backward's ms in the same run, and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# name -> {member of BwdMma: new initializer}
VARIANTS = {
    "shipped": {},
    # one m16 row tile per warp (each B fragment serves 16 rows): K2 as two
    # blocks of 8 warps (128 registers), K3 as three blocks of 4 warps (168)
    "mt1": {"kMt": "1", "kWarps": "kNarrow && !DKV ? 8 : 4",
            "kMinBlocks": "DKV ? (kNarrow ? 3 : 2) : (kNarrow ? 2 : 3)",
            "kSub": "kNarrow || DKV ? 32 : 16"},
    # K2 with 32-column score tiles, K3 with 32 at every head dim
    "k2_sub32": {"kSub": "DKV ? (kNarrow ? 16 : 32) : (kNarrow ? 32 : 16)"},
    "k3_sub32": {"kSub": "DKV ? 32 : 16"},
    "stages2": {"kStages": "2"},
    "stages4": {"kStages": "kNarrow ? 4 : DKV ? 3 : 2"},
}
SHAPE = (12, 2304, 8, 40)


def patch(src: str, overrides: dict) -> str:
    """The source with BwdMma's members given new initializers."""
    head, rest = src.split("struct BwdMma {", 1)
    body, tail = rest.split("};", 1)
    for name, expr in overrides.items():
        body, n = re.subn(rf"(static constexpr \w+ {name} = )[^;]+;",
                          lambda m: f"{m.group(1)}{expr};", body)
        if n != 1:
            raise ValueError(f"BwdMma has no member {name}")
    return head + "struct BwdMma {" + body + "};" + tail


def build_all(out_dir: Path) -> dict:
    """Build every variant's library; returns name -> (path, ptxas text)."""
    from emcid_torch.ops import _build

    src = (_build.CSRC / "flash_v2.cu").read_text()
    procs = {}
    for name, overrides in VARIANTS.items():
        d = out_dir / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d / "csrc")
        (d / "csrc" / "flash_v2.cu").write_text(patch(src, overrides))
        lib = d / "lib.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
               str(d / "csrc"), "-o", str(lib), str(d / "csrc" / "flash_v2.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        built[name] = (lib, text)
    return built


def reg_report(ptxas: str, kernel: str) -> dict:
    """Registers and spill-store bytes of ``kernel`` at D = 40."""
    blocks = ptxas.split("Compiling entry function")
    for b in blocks:
        if f"{kernel}ILi40E" in b.split("\n")[0]:
            regs = re.search(r"Used (\d+) registers", b)
            spill = re.search(r"(\d+) bytes spill stores", b)
            return dict(registers=int(regs.group(1)) if regs else None,
                        spill_bytes=int(spill.group(1)) if spill else None)
    return {}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/bwd_shapes.json")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import cuda_ms, nvidia_smi_line, qkv, rel_err
    from emcid_torch.ops import _build
    from emcid_torch.ops import flash_v2 as fv2

    built = build_all(REPO / "build" / "bwd_shapes")
    B, N, H, D = SHAPE
    bf = torch.bfloat16
    q, k, v = qkv(B, N, N, H, D, bf, seed=2)
    g = torch.Generator(device="cuda").manual_seed(3)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(bf)
    s = D ** -0.5
    o, lse = fv2.flash_fwd(q, k, v, s)
    delta = fv2.row_delta(o, dout)
    dq_ref = fv2.flash_dq_plain(q, k, v, dout, lse, delta, s)
    dk_ref, dv_ref = fv2.flash_dkv_plain(q, k, v, dout, lse, delta, s)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, scale=s)
    gt = dout.transpose(1, 2).contiguous()
    sdpa_ms = cuda_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), gt, retain_graph=True), 10)
    stream = _build.stream_ptr(q)
    rows = []
    for name, (path, ptxas) in built.items():
        lib = ctypes.CDLL(str(path))
        fdq, fdkv = lib.emcid_flash_dq_mma, lib.emcid_flash_dkv_mma
        fdq.argtypes = _build._SIGNATURES["emcid_flash_dq_mma"]
        fdkv.argtypes = _build._SIGNATURES["emcid_flash_dkv_mma"]
        fdq.restype = fdkv.restype = ctypes.c_int
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), delta.data_ptr())
        tail = (B, H, N, N, D, ctypes.c_float(s), 1, stream)

        def run_dq():
            if fdq(*common, dq.data_ptr(), *tail):
                raise RuntimeError(f"{name}: K2 launch failed")

        def run_dkv():
            if fdkv(*common, dk.data_ptr(), dv.data_ptr(), *tail):
                raise RuntimeError(f"{name}: K3 launch failed")

        run_dq()
        run_dkv()
        torch.cuda.synchronize()
        errs = [rel_err(a, b)[1] for a, b in ((dq, dq_ref), (dk, dk_ref),
                                              (dv, dv_ref))]
        row = dict(variant=name, overrides=VARIANTS[name],
                   shape=list(SHAPE), rel_err=max(errs),
                   ok=max(errs) <= 1e-2,
                   k2_ms=cuda_ms(run_dq, 20), k3_ms=cuda_ms(run_dkv, 20),
                   sdpa_bwd_ms=sdpa_ms,
                   k2_regs=reg_report(ptxas, "dq_mma_kernel"),
                   k3_regs=reg_report(ptxas, "dkv_mma_kernel"))
        print(json.dumps(row), flush=True)
        rows.append(row)
    out = REPO / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(device=torch.cuda.get_device_name(0),
                                   nvidia_smi=nvidia_smi_line(), rows=rows),
                              indent=1))
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
