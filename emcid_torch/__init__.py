"""emcid_torch — the EMCID two-stage text-encoder edit on PyTorch and CUDA.

A port of ``emcid_tpu`` (the JAX/TPU package, kept beside it as the
reference) for one NVIDIA H100.  Module layout and names mirror the JAX
package so each module's counterpart is easy to find; the attention kernels
the JAX package wrote in Pallas are hand-written CUDA for ``sm_90a`` under
``emcid_torch/csrc`` (see ``emcid_torch/ops``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
