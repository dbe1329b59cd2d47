"""The device mesh and its sharding helpers.

Counterpart of ``emcid_tpu/parallel/mesh.py``.  The JAX package shards
three scale axes over its mesh with ``jax.sharding`` and lets XLA insert
the collectives: the concept axis of Stage 1, the image axis of
generation and the caption axis of the covariance sweep.  Here the mesh
holds this process's entries, a tuple of ``torch.device``, and the
consumers split their batch with ``shard_batch``, run each local shard on
its entry's replica of the models (``replicate``), and ``gather`` the
results in global shard order.  Reductions across shards (the covariance
accumulate, the K/V edit's shared gradient) sum in the fixed order shard
0, 1, ... on every process.

An entry may repeat a device: ``get_mesh(["cuda:0"] * 4)`` runs four
shards one after another on one card (and ``["cpu"] * 3`` on the CPU),
which exercises the sharded code where only one device exists.  Shards
are issued one after another from one host thread; CUDA launches are
asynchronous, so shards on different cards overlap as long as nothing in
the per-shard loop waits for the device.

Across processes (``multi_slice_mesh``, one process per card under
``torchrun``; ``parallel/distributed.py``) the mesh gains the outer
``dcn`` axis: shape (processes, entries per process), process-major, so
process r holds the global shards ``r * L`` to ``r * L + L - 1``.
``mesh.size`` counts every shard of every process, ``mesh.devices`` are
this process's entries and ``mesh.first`` its first global shard; every
process holds the whole batch, ``shard_batch`` hands it its own shards
and ``gather`` returns every shard on every process
(``distributed.all_gather``).  So a consumer's loop over
``zip(replicate(m, mesh), shard_batch(x, mesh), mesh.devices)`` keeps its
shape on either layout.
"""

from __future__ import annotations

import copy
import math
import weakref
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from emcid_torch.parallel import distributed


@dataclass(frozen=True)
class DeviceMesh:
    """A mesh of ``size`` shards: ``devices`` are this process's entries,
    the global shards ``first`` to ``first + len(devices) - 1``.  The 1-D
    ``data`` mesh of one process has ``shape`` (len(devices),)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)
    shape: Optional[Tuple[int, ...]] = None
    first: int = 0

    @property
    def size(self) -> int:
        return math.prod(self.shape) if self.shape else len(self.devices)

    @property
    def spans_processes(self) -> bool:
        return self.size > len(self.devices)


def _device(d) -> torch.device:
    # "cuda" names the current card: give it its index, as a module's
    # parameters report it, so that replicate() finds the module there
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def get_mesh(devices: Optional[Sequence] = None,
             axis_name: str = "data") -> DeviceMesh:
    """1-D data mesh over all visible CUDA devices, or the given ones (an
    entry may repeat), in this process."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return DeviceMesh(devices, (axis_name,))


def multi_slice_mesh(num_slices: Optional[int] = None,
                     axis_names: Sequence[str] = ("dcn", "data"),
                     devices: Optional[Sequence] = None) -> DeviceMesh:
    """The hierarchical mesh across processes: shape (num_slices, shards /
    num_slices), one slice per process by default, the shards
    process-major.  ``devices`` are this process's entries (default: its
    ``distributed.local_device()``; an entry may repeat); every process
    must hold as many.  Every process of the group calls it together (it
    checks the counts with one collective).  Raises when the shards do not
    divide into ``num_slices``."""
    local = tuple(_device(d) for d in (
        devices if devices is not None else [distributed.local_device()]))
    if not local:
        raise ValueError("a mesh needs at least one device")
    procs = distributed.process_count()
    counts = distributed.all_gather(torch.tensor([len(local)]))
    if (counts != len(local)).any():
        raise ValueError(f"every process must hold as many mesh entries: "
                         f"{counts.tolist()}")
    total = procs * len(local)
    num_slices = num_slices or procs
    if total % num_slices:
        raise ValueError(
            f"{total} devices do not divide into {num_slices} slices")
    return DeviceMesh(local, tuple(axis_names),
                      (num_slices, total // num_slices),
                      distributed.process_index() * len(local))


def default_mesh(disable: bool = False) -> Optional[DeviceMesh]:
    """The product default.  Under a process group of two or more
    processes, the (``dcn``, ``data``) mesh over every process's entries;
    else a data mesh over every visible card when two or more are
    attached, else None (one card stays mesh-free).  ``--no-mesh`` flags
    map to ``disable``."""
    if disable:
        return None
    if distributed.process_count() > 1:
        return multi_slice_mesh()
    if torch.cuda.device_count() < 2:
        return None
    return get_mesh()


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> List[torch.Tensor]:
    """Split the leading axis of ``x`` (the whole batch) into ``mesh.size``
    equal chunks over every axis of the mesh and return this process's,
    each on its entry's device.  Raises when the axis does not divide
    (callers pad first, with ``pad_to_multiple``)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} does not divide the mesh "
                         f"({mesh.size} entries); pad it first")
    chunks = torch.chunk(x, mesh.size)[mesh.first:]
    return [c.to(d) for c, d in zip(chunks, mesh.devices)]


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


def gather(chunks: Sequence[torch.Tensor], device,
           mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Concatenate this process's per-shard chunks on ``device``, in shard
    order; on a mesh that spans processes, every process's, in global
    shard order, on every process (each process's chunks alike in
    shape)."""
    local = torch.cat([c.to(device) for c in chunks])
    if mesh is None or not mesh.spans_processes:
        return local
    return distributed.all_gather(local)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m >= n (batch padding so shards divide
    evenly)."""
    return ((n + m - 1) // m) * m
