"""Streaming statistics over datasets, with npz caching.

Counterpart of ``emcid_tpu/stats/running.py``: ``SecondMoment``,
``Mean``, ``NormMean``, ``Variance``, ``Covariance``, ``CombinedStat``,
``tally``, ``cache_load_enabled`` and the npz codec (the JAX package's
``stats/extras.py`` is ``emcid_torch/stats/extras.py``).  The second-moment accumulate is a
torch f32 matmul on the tensor's device, under ``precise_matmuls`` (no
TF32); the mean, variance and covariance statistics run on the host in
numpy, in the dtype of what is added (Chan's parallel update).  The
``.npz`` state schema is the JAX package's and the reference's: keys
``count`` and ``mom2`` (prefixed ``mom2.`` inside a ``CombinedStat``),
``constructor``, the ``sample_size`` check argument, and None stored
NaN-boxed, so a cache written by either package loads in the other.
``Mean`` and ``NormMean`` keep the keys ``count``, ``batchcount``,
``mean`` and ``data_shape``; ``Variance`` adds ``cmom2`` (the centered
second moment per feature), ``Covariance`` keeps ``count``, ``mean``,
``cmom2`` (the full centered matrix) and ``data_shape``.
"""

from __future__ import annotations

import os
import random
import struct
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from emcid_torch.parallel.distributed import is_writer
from emcid_torch.runtime import precise_matmuls


def _to_np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Stat:
    """Abstract streaming statistic."""

    def __init__(self, state=None):
        if state is not None:
            self.load_state_dict(resolve_state_dict(state))

    def add(self, a):
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        raise NotImplementedError

    def load_state_dict(self, state: Dict[str, Any]):
        raise NotImplementedError

    def to_(self, device=None):
        pass

    def save(self, filename):
        save_cached_state(filename, self, {})

    def load(self, filename):
        self.load_state_dict(resolve_state_dict(filename))

    def _constructor_name(self) -> str:
        # the reference module path, so reference-side loads recognize it
        return f"util.runningstats.{self.__class__.__name__}()"


class SecondMoment(Stat):
    """Running non-centered second moment ``sum a^T a`` and its count."""

    def __init__(self, split_batch=True, state=None):
        self.count = 0
        self.mom2 = None
        self.split_batch = split_batch
        super().__init__(state)

    def add(self, a: torch.Tensor, n_valid: Optional[int] = None):
        """Accumulate ``a^T a`` over the rows of ``a`` (N, features).
        ``n_valid`` overrides the row count for batches padded with zero
        rows (they add nothing to the moment)."""
        a = torch.as_tensor(a)
        if a.dim() == 1:
            a = a[:, None]
        elif a.dim() != 2:
            a = a.reshape(a.shape[0], -1)
        if a.shape[0] == 0:
            return
        if self.count == 0:
            self.mom2 = torch.zeros((a.shape[1], a.shape[1]),
                                    dtype=torch.float32, device=a.device)
        self.count += int(n_valid) if n_valid is not None else a.shape[0]
        a32 = a.float()
        with precise_matmuls():
            self.mom2 += a32.T @ a32

    def moment(self):
        return self.mom2 / self.count

    def to_(self, device=None):
        if self.mom2 is not None:
            self.mom2 = torch.as_tensor(self.mom2).to(device or "cpu")

    def state_dict(self):
        return dict(constructor=self._constructor_name(), count=self.count,
                    mom2=_to_np(self.mom2))

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.mom2 = torch.as_tensor(np.asarray(state["mom2"]))


def _load_data_shape(ds):
    """None, a NaN-boxed null or an array -> a tuple or None."""
    if ds is None:
        return None
    arr = np.atleast_1d(np.asarray(ds))
    if arr.dtype.kind == "f" and np.isnan(arr).any():
        return None
    return tuple(int(d) for d in arr)


def _rows(data_shape, a):
    """Host array of (N, features) rows, and the trailing feature shape
    of an N-D input (kept to restore the result's shape)."""
    a = _to_np(a)
    if a.ndim == 1:
        a = a[:, None]
    elif a.ndim != 2:
        if data_shape is None:
            data_shape = tuple(a.shape[1:])
        a = a.reshape(a.shape[0], -1)
    return data_shape, a


def _restore_shape(data_shape, a):
    if data_shape is None or a is None:
        return a
    return a.reshape(a.shape[:-1] + tuple(data_shape))


class Mean(Stat):
    """Running mean over the rows of (N, ...) batches (Chan's update), kept
    on the host in the type of what is added."""

    def __init__(self, state=None):
        self.count = 0
        self.batchcount = 0
        self._mean = None
        self.data_shape = None
        super().__init__(state)

    def add(self, a):
        self.data_shape, a = _rows(self.data_shape, a)
        if a.shape[0] == 0:
            return
        batch_count = a.shape[0]
        batch_mean = a.sum(0) / batch_count
        self.batchcount += 1
        if self._mean is None:
            self.count = batch_count
            self._mean = batch_mean
            return
        self.count += batch_count
        frac = float(batch_count) / self.count
        self._mean = self._mean + (batch_mean - self._mean) * frac

    def size(self):
        return self.count

    def mean(self):
        return _restore_shape(self.data_shape, self._mean)

    def state_dict(self):
        return dict(constructor=self._constructor_name(), count=self.count,
                    data_shape=self.data_shape and tuple(self.data_shape),
                    batchcount=self.batchcount, mean=_to_np(self._mean))

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.batchcount = int(state["batchcount"])
        self._mean = np.asarray(state["mean"])
        self.data_shape = _load_data_shape(state.get("data_shape"))


class NormMean(Mean):
    """Running mean of the rows' L2 norms (over the last axis)."""

    def add(self, a):
        super().add(np.linalg.norm(_to_np(a), axis=-1))


class Variance(Stat):
    """Running mean and per-feature variance (Chan's parallel update)."""

    def __init__(self, state=None):
        self.count = 0
        self.batchcount = 0
        self._mean = None
        self.v_cmom2 = None
        self.data_shape = None
        super().__init__(state)

    def add(self, a):
        self.data_shape, a = _rows(self.data_shape, a)
        if a.shape[0] == 0:
            return
        batch_count = a.shape[0]
        batch_mean = a.sum(0) / batch_count
        centered = a - batch_mean
        batch_cmom2 = (centered * centered).sum(0)
        self.batchcount += 1
        if self._mean is None:
            self.count = batch_count
            self._mean, self.v_cmom2 = batch_mean, batch_cmom2
            return
        old_count = self.count
        self.count += batch_count
        frac = float(batch_count) / self.count
        delta = batch_mean - self._mean
        self._mean = self._mean + delta * frac
        self.v_cmom2 = (self.v_cmom2 + batch_cmom2
                        + delta * delta * (frac * old_count))

    def size(self):
        return self.count

    def mean(self):
        return _restore_shape(self.data_shape, self._mean)

    def variance(self, unbiased=True):
        return _restore_shape(self.data_shape, self.v_cmom2 / (
            self.count - (1 if unbiased else 0)))

    def stdev(self, unbiased=True):
        return np.sqrt(self.variance(unbiased=unbiased))

    def state_dict(self):
        return dict(constructor=self._constructor_name(), count=self.count,
                    data_shape=self.data_shape and tuple(self.data_shape),
                    batchcount=self.batchcount, mean=_to_np(self._mean),
                    cmom2=_to_np(self.v_cmom2))

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.batchcount = int(state["batchcount"])
        self._mean = np.asarray(state["mean"])
        self.v_cmom2 = np.asarray(state["cmom2"])
        self.data_shape = _load_data_shape(state.get("data_shape"))


class Covariance(Stat):
    """Running mean and full covariance (Chan's parallel update)."""

    def __init__(self, state=None):
        self.count = 0
        self._mean = None
        self.cmom2 = None
        self.data_shape = None
        super().__init__(state)

    def add(self, a):
        self.data_shape, a = _rows(self.data_shape, a)
        if a.shape[0] == 0:
            return
        batch_count = a.shape[0]
        if self._mean is None:
            self.count = batch_count
            self._mean = a.sum(0) / batch_count
            centered = a - self._mean
            self.cmom2 = centered.T @ centered
            return
        self.count += batch_count
        delta = a - self._mean
        self._mean = self._mean + delta.sum(0) / self.count
        self.cmom2 = self.cmom2 + delta.T @ (a - self._mean)

    def mean(self):
        return _restore_shape(self.data_shape, self._mean)

    def covariance(self, unbiased=True):
        return self.cmom2 / (self.count - (1 if unbiased else 0))

    def correlation(self, unbiased=True):
        cov = self.covariance(unbiased=unbiased)
        rstdev = 1.0 / np.sqrt(np.diagonal(cov))
        return rstdev[:, None] * cov * rstdev[None, :]

    def variance(self, unbiased=True):
        return _restore_shape(self.data_shape, np.diagonal(self.cmom2) / (
            self.count - (1 if unbiased else 0)))

    def stdev(self, unbiased=True):
        return np.sqrt(self.variance(unbiased=unbiased))

    def state_dict(self):
        return dict(constructor=self._constructor_name(), count=self.count,
                    data_shape=self.data_shape and tuple(self.data_shape),
                    mean=_to_np(self._mean), cmom2=_to_np(self.cmom2))

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self._mean = np.asarray(state["mean"])
        self.cmom2 = np.asarray(state["cmom2"])
        self.data_shape = _load_data_shape(state.get("data_shape"))


class CombinedStat(Stat):
    """Named stats sharing one add/save."""

    def __init__(self, state=None, **kwargs):
        self._objs = kwargs
        super().__init__(state)

    def __getattr__(self, k):
        objs = self.__dict__.get("_objs", {})
        if k in objs:
            return objs[k]
        raise AttributeError(k)

    def add(self, d, *args, **kwargs):
        for obj in self._objs.values():
            obj.add(d, *args, **kwargs)

    def load_state_dict(self, state):
        for prefix, obj in self._objs.items():
            obj.load_state_dict(pull_key_prefix(prefix, state))

    def state_dict(self):
        result = {}
        for prefix, obj in self._objs.items():
            result.update(push_key_prefix(prefix, obj.state_dict()))
        return result

    def to_(self, device=None):
        for v in self._objs.values():
            v.to_(device)


def push_key_prefix(prefix: str, d: Dict[str, Any]) -> Dict[str, Any]:
    return {prefix + "." + k: v for k, v in d.items()}


def pull_key_prefix(prefix: str, d: Dict[str, Any]) -> Dict[str, Any]:
    pd = prefix + "."
    return {k[len(pd):]: v for k, v in d.items() if k.startswith(pd)}


# None is stored as the NaN bit pattern 0xfff8000000000002, so npz files
# never need allow_pickle.
null_numpy_value = np.array(
    struct.unpack(">d", struct.pack(">Q", 0xFFF8000000000002))[0],
    dtype=np.float64)


def is_null_numpy_value(v) -> bool:
    return (isinstance(v, np.ndarray) and np.ndim(v) == 0
            and v.dtype == np.float64 and np.isnan(v)
            and 0xFFF8000000000002 == struct.unpack(
                ">Q", struct.pack(">d", v))[0])


def box_numpy_null(d):
    if isinstance(d, dict):
        return {k: box_numpy_null(v) for k, v in d.items()}
    return null_numpy_value if d is None else d


def unbox_numpy_null(d):
    if isinstance(d, dict):
        return {k: unbox_numpy_null(v) for k, v in d.items()}
    return None if is_null_numpy_value(d) else d


def resolve_state_dict(s):
    if isinstance(s, (str, os.PathLike)):
        return unbox_numpy_null(dict(np.load(s)))
    return s


_load_cache_enabled = True


class cache_load_enabled:
    """``with cache_load_enabled(False):`` makes ``load_cached_state`` (and
    so ``tally``) ignore every cache file inside the scope: the statistic
    is recomputed (and the file written anew)."""

    def __init__(self, enabled=True):
        self.enabled = enabled
        self.prev = True

    def __enter__(self):
        global _load_cache_enabled
        self.prev = _load_cache_enabled
        _load_cache_enabled = self.enabled
        return self

    def __exit__(self, *exc):
        global _load_cache_enabled
        _load_cache_enabled = self.prev


def load_cached_state(cachefile, args: Dict[str, Any], quiet=False):
    """The npz state at ``cachefile`` if present and its check-args match,
    else None (always None inside ``cache_load_enabled(False)``)."""
    if not _load_cache_enabled or cachefile is None:
        return None
    try:
        dat = unbox_numpy_null(dict(np.load(cachefile)))
    except (FileNotFoundError, ValueError):
        return None
    for a, v in args.items():
        if a not in dat or dat[a] != v:
            if not quiet:
                print(f"{cachefile} {a} changed from {dat.get(a)} to {v}")
            return None
    if not quiet:
        print(f"Loading cached {cachefile}")
    return dat


def save_cached_state(cachefile, obj, args: Dict[str, Any]):
    if cachefile is None:
        return
    dat = obj.state_dict()
    for a, v in args.items():
        if a in dat and dat[a] != v:
            raise ValueError(f"check arg {a} is {dat[a]}, expected {v}")
        dat[a] = v
    dirname = os.path.dirname(str(cachefile))
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    np.savez(cachefile, **box_numpy_null(dat))


class FixedRandomSubsetSampler:
    """Shuffle range(n) with a fixed seed, keep the first ``sample_size``."""

    def __init__(self, data_source_len: int,
                 sample_size: Optional[int] = None, seed: int = 1):
        indices = list(range(data_source_len))
        random.Random(seed).shuffle(indices)
        if sample_size is not None:
            indices = indices[:sample_size]
        self.indices = indices

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices)

    def __len__(self) -> int:
        return len(self.indices)


def make_loader(dataset: Sequence, sample_size=None, random_sample=None,
                batch_size=1, collate_fn=None) -> Iterable:
    """Batches of ``dataset`` items (lists, or ``collate_fn`` of them);
    ``random_sample`` is the shuffle seed."""
    n = len(dataset)
    if random_sample is not None:
        indices = FixedRandomSubsetSampler(n, sample_size,
                                           seed=random_sample).indices
    else:
        indices = list(range(n if sample_size is None
                             else min(n, sample_size)))

    def batches():
        for i in range(0, len(indices), batch_size):
            items = [dataset[j] for j in indices[i:i + batch_size]]
            yield collate_fn(items) if collate_fn else items

    return batches()


def tally(stat: Stat, dataset, cache=None, quiet=False, on_end=None,
          **kwargs):
    """Stream a dataset through a Stat with npz caching.  Returns an
    iterable of batches: iterate it fully and the stat is moved to the host
    and saved (after ``on_end()``, when given, which may fill it from
    per-shard accumulators; under a process group by the first process
    only).  On a cache hit the stat is filled and the iterable is
    empty."""
    args = {k: kwargs[k] for k in ("sample_size",) if k in kwargs}
    cached_state = load_cached_state(cache, args, quiet=quiet)
    if cached_state is not None:
        stat.load_state_dict(cached_state)
        return iter(())
    loader = make_loader(dataset, **kwargs)

    def wrapped_loader():
        yield from loader
        if on_end is not None:
            on_end()
        stat.to_("cpu")
        if cache is not None and is_writer():
            save_cached_state(cache, stat, args)

    return wrapped_loader()
