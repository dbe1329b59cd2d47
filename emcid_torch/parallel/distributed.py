"""The process group behind the mesh's ``dcn`` axis.

Counterpart of ``jax.distributed.initialize`` and
``jax.process_index``/``jax.process_count``.  One process per card is how
PyTorch runs several cards: ``torchrun --nproc-per-node N -m ...`` starts
the processes and describes them in the environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``); ``init_from_env`` joins them into one
``torch.distributed`` process group.

The backend follows from the layout and is printed: ``nccl`` when every
rank has a card of its own, ``gloo`` when ranks share a card (NCCL takes
one rank per device) or run on the CPU.  It is chosen before the group is
made, never by catching a failure of the other.

Every transfer between processes goes through ``all_gather``: each rank's
tensor, concatenated in rank order on every rank.  Under ``gloo`` it
stages through host memory (the computing stays on the card); under
``nccl`` it runs on this rank's card.

Every process holds the same results, so only the first writes files
(``is_writer``; ``shared_writes`` where the others read them after) and
prints a command's results (``quiet_unless_writer``).
"""

from __future__ import annotations

import contextlib
import io
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# the platform given to init_from_env: where local_device() puts this rank
_platform: Optional[str] = None


def is_up() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_up() else 0


def process_count() -> int:
    return dist.get_world_size() if is_up() else 1


def is_writer() -> bool:
    """Whether this process writes files and prints results: rank 0, or
    the only process."""
    return process_index() == 0


def _local_world() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", "1")))


def local_device(platform: Optional[str] = None) -> torch.device:
    """This rank's device: the CPU, or ``cuda:LOCAL_RANK`` while the ranks
    of this host do not outnumber its cards, else ``cuda:0``.  The
    platform defaults to the one given to ``init_from_env``, else the
    card."""
    platform = platform or _platform or "cuda"
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "cuda":
        raise ValueError(f"platform {platform!r}: cpu or cuda")
    if _local_world() <= torch.cuda.device_count():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cuda", 0)


def backend_for(platform: str) -> Tuple[str, str]:
    """(backend, reason) for this host's layout."""
    if platform == "cpu":
        return "gloo", "ranks on the CPU"
    n, ranks = torch.cuda.device_count(), _local_world()
    if ranks > n:
        return "gloo", (f"{ranks} ranks share {n} card(s); NCCL takes one "
                        "rank per device")
    return "nccl", f"{ranks} ranks, one card each"


def init_from_env(platform: str = "cuda") -> str:
    """Join the process group that torchrun's environment describes (a
    no-op when this process already belongs to one); returns the
    backend.  On the card, raises when no card is present."""
    global _platform
    if is_up():
        return dist.get_backend()
    from emcid_torch.runtime import resolve_device

    need = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    missing = [k for k in need if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_from_env: {missing} not set; start the "
                           "processes with torchrun")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend, why = backend_for(platform)
    dev = resolve_device(local_device(platform))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, world_size=world, rank=rank,
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"))
    _platform = platform
    print(f"[distributed] rank {rank} of {world} on {dev}: backend "
          f"{backend} ({why})", flush=True)
    return backend


def setup_process(platform: str) -> torch.device:
    """The device an entry point runs on: under torchrun with two or more
    processes (``WORLD_SIZE`` > 1) this rank's ``local_device``, after
    joining the process group; else ``platform``'s device.  Raises when
    the card is wanted and absent."""
    from emcid_torch.runtime import resolve_device

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_from_env(platform)
        return resolve_device(local_device(platform))
    return resolve_device(platform)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all of them) concatenated along
    the leading axis in rank order, on ``t``'s device, on every rank;
    ``t`` itself without a process group.  Not differentiable."""
    if not is_up():
        return t
    via = (torch.device("cpu") if dist.get_backend() == "gloo"
           else torch.device("cuda", torch.cuda.current_device()))
    src = t.detach().to(via).contiguous()
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if not is_up():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


@contextlib.contextmanager
def shared_writes():
    """A scope in which the first process writes the files that every
    process may read after it; yields whether this process writes.  Every
    process enters it together (each has looked at what exists before any
    is written) and leaves it together (after the writes).  Without a
    process group it yields True and waits for nothing."""
    barrier()
    yield is_writer()
    barrier()


def shutdown() -> None:
    """Leave the process group (nothing without one)."""
    if is_up():
        dist.destroy_process_group()


@contextlib.contextmanager
def quiet_unless_writer():
    """Standard output of every rank but the writer is dropped inside the
    scope, so a command's result lines are printed once; errors still go
    to standard error on every rank."""
    if is_writer():
        yield
        return
    with contextlib.redirect_stdout(io.StringIO()):
        yield
