"""The single-process device mesh and its sharding helpers.

Counterpart of ``emcid_tpu/parallel/mesh.py``.  The JAX package shards
three scale axes over a 1-D ``data`` mesh with ``jax.sharding`` and lets
XLA insert the collectives: the concept axis of Stage 1, the image axis of
generation and the caption axis of the covariance sweep.  Here the mesh is
a tuple of ``torch.device`` entries and the consumers split their batch
with ``shard_batch``, run each shard on its entry's replica of the models
(``replicate``), and ``gather`` the results on the first entry.  Reductions
across shards (the covariance accumulate, the K/V edit's shared gradient)
sum in the fixed order shard 0, 1, ... on the first entry.

An entry may repeat a device: ``get_mesh(["cuda:0"] * 4)`` runs four
shards one after another on one card (and ``["cpu"] * 3`` on the CPU),
which exercises the sharded code where only one device exists.  Shards
are issued one after another from one host thread; CUDA launches are
asynchronous, so shards on different cards overlap as long as nothing in
the per-shard loop waits for the device.

The multi-process ``dcn`` axis (``multi_slice_mesh``) has no counterpart
yet: it needs a ``torch.distributed`` process group (ROADMAP M14b).
"""

from __future__ import annotations

import copy
import weakref
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class DeviceMesh:
    """A 1-D ``data`` mesh: one shard per entry of ``devices``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)


def get_mesh(devices: Optional[Sequence] = None,
             axis_name: str = "data") -> DeviceMesh:
    """1-D data mesh over all visible CUDA devices, or the given ones (an
    entry may repeat)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    # "cuda" names the current card: give it its index, as a module's
    # parameters report it, so that replicate() finds the module there
    devices = tuple(
        torch.device("cuda", torch.cuda.current_device())
        if torch.device(d).type == "cuda" and torch.device(d).index is None
        else torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return DeviceMesh(devices, (axis_name,))


def multi_slice_mesh(num_slices: Optional[int] = None,
                     axis_names: Sequence[str] = ("dcn", "data")):
    """The JAX package's hierarchical (``dcn``, ``data``) mesh across
    processes; not ported."""
    raise NotImplementedError(
        "multi_slice_mesh: the multi-process dcn axis over torch.distributed "
        "(ROADMAP M14b)")


def default_mesh(disable: bool = False) -> Optional[DeviceMesh]:
    """The product default: a data mesh over every visible card when two or
    more are attached, else None (one card stays mesh-free).  ``--no-mesh``
    flags map to ``disable``."""
    if disable or torch.cuda.device_count() < 2:
        return None
    return get_mesh()


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> List[torch.Tensor]:
    """Split the leading axis of ``x`` into ``mesh.size`` equal chunks, each
    on its entry's device.  Raises when the axis does not divide (callers
    pad first, with ``pad_to_multiple``)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} does not divide the mesh "
                         f"({mesh.size} entries); pad it first")
    return [c.to(d) for c, d in zip(torch.chunk(x, mesh.size), mesh.devices)]


# module -> {device: (fingerprint, replica)}; an entry lives as long as its
# module and is rebuilt when the module's weights change
_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _named_tensors(module) -> dict:
    out = dict(module.named_parameters(remove_duplicate=False))
    out.update(module.named_buffers(remove_duplicate=False))
    return out


def _fingerprint(module) -> tuple:
    """The storage and in-place version of every parameter and buffer: a
    weight swapped or edited in place changes it."""
    return tuple((t.data_ptr(), t._version)
                 for t in _named_tensors(module).values())


def _copy_to(module, device):
    """``module`` on ``device``: its structure deep-copied around meta
    tensors, then each weight copied from the source, so that no second
    copy is made on the source's device."""
    memo = {id(t): torch.empty_like(t, device="meta")
            for t in module.buffers()}
    memo.update({id(p): torch.nn.Parameter(
        torch.empty_like(p, device="meta"), requires_grad=p.requires_grad)
        for p in module.parameters()})
    clone = copy.deepcopy(module, memo).to_empty(device=device)
    src = _named_tensors(module)
    with torch.no_grad():
        for name, t in _named_tensors(clone).items():
            t.copy_(src[name])
    return clone


def replicate(module, mesh: DeviceMesh) -> list:
    """One module per mesh entry: ``module`` itself on its own device, one
    copy per other device, shared by every entry on that device.  The
    copies are kept for the next call while ``module``'s weights are
    unchanged (an edit in place or a swapped tensor makes new ones)."""
    own = next(module.parameters()).device
    cache = _REPLICAS.setdefault(module, {})
    fingerprint = None
    out = []
    for d in mesh.devices:
        if d == own:
            out.append(module)
            continue
        if fingerprint is None:
            fingerprint = _fingerprint(module)
        hit = cache.get(d)
        if hit is None or hit[0] != fingerprint:
            hit = cache[d] = (fingerprint, _copy_to(module, d))
        out.append(hit[1])
    return out


def gather(chunks: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Concatenate per-shard chunks on ``device``, in shard order."""
    return torch.cat([c.to(device) for c in chunks])


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m >= n (batch padding so shards divide
    evenly)."""
    return ((n + m - 1) // m) * m
