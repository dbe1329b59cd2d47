"""Additional streaming statistics (reference util/runningstats.py:787-1345):
``Quantile``, ``TopK``, ``Bincount``, ``History`` and ``IoU``.

Counterpart of ``emcid_tpu/stats/extras.py``.  These run on the host in
numpy: a torch tensor passed to ``add`` is moved to the host first, as the
JAX package moves a ``jax.Array``.  The npz state schemas are the JAX
package's and the reference's, so a state written by either package loads
in the other.  ``Quantile``'s subsampling draws from its own
``np.random.RandomState(seed)``, in the JAX package's call order: two
instances seeded the same, one per package, keep the same samples."""

from __future__ import annotations

from typing import Optional

import numpy as np

from emcid_torch.stats.running import Stat, _to_np


class Quantile(Stat):
    """Streaming randomized quantile sketch with the reference's layered
    sorted-sample structure AND npz state schema (runningstats.py:787-1160,
    KLL-style: each level keeps a buffer of samples weighted 2^level; a full
    level sorts itself and promotes every other sample up one level; once
    capacities bottom out, the input stream itself is Bernoulli-subsampled
    via ``samplerate``).  State keys — ``resolution/depth/buffersize/
    samplerate/sizes/extremes/size/batchcount/data.{i}`` — match the
    reference byte-for-byte, so a reference-written Quantile cache loads
    here and vice versa (held against the JAX package's class in
    tests/test_torch_extras.py)."""

    def __init__(self, r: int = 3 * 1024, buffersize: Optional[int] = None,
                 seed: Optional[int] = None, state=None):
        if state is not None:
            super().__init__(state)
            return
        resolution = 2 * r  # buffer at least half full before any discard
        self.resolution = resolution
        self.buffersize = (min(128, (resolution + 7) // 8)
                           if buffersize is None else buffersize)
        self.samplerate = 1.0
        self.depth: Optional[int] = None
        self.data: Optional[list] = None  # per level: (depth, cap) array
        self.firstfree = [0]
        self.extremes: Optional[np.ndarray] = None  # (depth, 2) min/max
        self.count = 0
        self.batchcount = 0
        self._rng = np.random.RandomState(seed)

    # -- accumulation ------------------------------------------------------

    def _lazy_init(self, incoming: np.ndarray):
        self.depth = incoming.shape[1]
        self.data = [np.zeros((self.depth, self.resolution), incoming.dtype)]
        self.extremes = np.empty((self.depth, 2), incoming.dtype)
        self.extremes[:, 0] = np.inf
        self.extremes[:, 1] = -np.inf

    def add(self, a):
        a = _to_np(a)
        if a.ndim == 1:
            a = a[:, None]
        a = a.reshape(a.shape[0], -1)  # (n, depth)
        if self.depth is None:
            self._lazy_init(a)
        assert a.shape[1] == self.depth, (a.shape[1], self.depth)
        self.count += a.shape[0]
        self.batchcount += 1
        if self.samplerate >= 1.0:
            self._add_every(a)
            return
        # subsampling regime: extremes must still see every sample
        self._update_extremes(a.min(axis=0), a.max(axis=0))
        chunk = int(np.ceil(self.buffersize / self.samplerate))
        for start in range(0, len(a), chunk):
            part = a[start:start + chunk]
            keep = self._rng.rand(len(part)) < self.samplerate
            if keep.any():
                self._add_every(part[keep])

    def _add_every(self, incoming: np.ndarray):
        index = 0
        while index < len(incoming):
            ff = self.firstfree[0]
            room = self.data[0].shape[1] - ff
            if room == 0:
                if not self._shift():
                    # capacities exhausted → the stream gets subsampled
                    incoming = incoming[index:]
                    if self.samplerate >= 0.5:
                        self._update_extremes(incoming.min(axis=0),
                                              incoming.max(axis=0))
                    keep = self._rng.rand(len(incoming)) < self.samplerate
                    incoming = incoming[keep]
                    index = 0
                ff = self.firstfree[0]
                room = self.data[0].shape[1] - ff
                if len(incoming) == 0:
                    break
            n = min(room, len(incoming) - index)
            self.data[0][:, ff:ff + n] = incoming[index:index + n].T
            self.firstfree[0] += n
            index += n

    def _level_quota(self, index: int) -> int:
        # room each level must keep: half the previous level's capacity
        # (rounded up); level 0 just needs one slot
        return (-(-self.data[index - 1].shape[1] // 2)) if index else 1

    def _shift(self) -> bool:
        index = 0
        while (self.data[index].shape[1] - self.firstfree[index]
               < self._level_quota(index)):
            if index + 1 >= len(self.data):
                return self._expand()
            level = np.sort(self.data[index][:, :self.firstfree[index]],
                            axis=1)
            if index == 0 and self.samplerate >= 1.0:
                self._update_extremes(level[:, 0], level[:, -1])
            kept = level[:, int(self._rng.randint(2))::2]
            pos = self.firstfree[index + 1]
            self.data[index + 1][:, pos:pos + kept.shape[1]] = kept
            self.firstfree[index + 1] += kept.shape[1]
            self.firstfree[index] = 0
            index += 1
        return True

    def _expand(self) -> bool:
        cap = int(np.ceil(self.resolution * (0.67 ** len(self.data))))
        if cap >= 2:
            cap = max(self.buffersize, -8 * (-cap // 8))  # 8-align
            self.data.insert(0, np.zeros((self.depth, cap),
                                         self.data[0].dtype))
            self.firstfree.insert(0, 0)
        else:
            assert self.firstfree[0] == 0
            self.samplerate *= 0.5
        # settle existing data downward into any space the insert opened
        for index in range(1, len(self.data)):
            amount = self.firstfree[index]
            if amount == 0:
                continue
            pos = self.firstfree[index - 1]
            if (self.data[index - 1].shape[1] - (amount + pos)
                    >= self._level_quota(index - 1)):
                self.data[index - 1][:, pos:pos + amount] = \
                    self.data[index][:, :amount]
                self.firstfree[index - 1] += amount
                self.firstfree[index] = 0
            else:
                level = np.sort(self.data[index][:, :amount], axis=1)
                if index == 1:
                    self._update_extremes(level[:, 0], level[:, -1])
                kept = level[:, int(self._rng.randint(2))::2]
                self.data[index][:, :kept.shape[1]] = kept
                self.firstfree[index] = kept.shape[1]
        return cap >= 2

    def _update_extremes(self, lo, hi):
        np.minimum(self.extremes[:, 0], lo, out=self.extremes[:, 0])
        np.maximum(self.extremes[:, 1], hi, out=self.extremes[:, 1])

    # -- readout -----------------------------------------------------------

    def _weighted_summary(self):
        if self.firstfree[0]:
            head = self.data[0][:, :self.firstfree[0]]
            self._update_extremes(head.min(axis=1), head.max(axis=1))
        size = sum(self.firstfree)
        summary = np.empty((self.depth, size), self.data[0].dtype)
        weights = np.empty(size, np.float64)
        at = 0
        for level, ff in enumerate(self.firstfree):
            if ff:
                summary[:, at:at + ff] = self.data[level][:, :ff]
                weights[at:at + ff] = 2.0 ** level
                at += ff
        order = np.argsort(summary, axis=-1, kind="stable")
        summary = np.take_along_axis(summary, order, axis=-1)
        weights = weights[order]  # (depth, size)
        zeros = np.zeros((self.depth, 1))
        summary = np.concatenate(
            [self.extremes[:, :1], summary, self.extremes[:, 1:]], axis=-1)
        weights = np.concatenate([zeros, weights, zeros], axis=-1)
        return summary, weights

    def quantiles(self, q) -> np.ndarray:
        q = np.asarray(q, np.float64)
        qshape = q.shape
        if self.count == 0:
            return np.full((self.depth,) + qshape, np.nan)
        summary, weights = self._weighted_summary()
        cumw = np.cumsum(weights, axis=-1) - weights / 2
        cumw /= np.sum(weights, axis=-1, keepdims=True)
        out = np.stack([np.interp(q.ravel(), cumw[d], summary[d])
                        for d in range(self.depth)])
        return out.reshape((self.depth,) + qshape).astype(
            self.data[0].dtype, copy=False)

    def quantile(self, q):
        return self.quantiles(q)

    def median(self):
        return self.quantiles(0.5)

    def minmax(self):
        if self.firstfree[0]:
            head = self.data[0][:, :self.firstfree[0]]
            self._update_extremes(head.min(axis=1), head.max(axis=1))
        return self.extremes.copy()

    def min(self):
        return self.minmax()[:, 0]

    def max(self):
        return self.minmax()[:, 1]

    def integrate(self, fun):
        total = None
        for level, ff in enumerate(self.firstfree):
            if ff == 0:
                continue
            term = np.sum(fun(self.data[level][:, :ff]) * (2.0 ** level),
                          axis=-1)
            total = term if total is None else total + term
        return None if total is None else total / self.samplerate

    def mean(self):
        return self.integrate(lambda x: x) / self.count

    def variance(self, unbiased: bool = True):
        mu = self.mean()[:, None]
        return (self.integrate(lambda x: (x - mu) ** 2)
                / (self.count - (1 if unbiased else 0)))

    def stdev(self, unbiased: bool = True):
        return np.sqrt(self.variance(unbiased=unbiased))

    def readout(self, count: int = 1001):
        return self.quantiles(np.linspace(0.0, 1.0, count))

    def normalize(self, a):
        """Map data from the training distribution to its quantile position
        in [0, 1] per channel (reference runningstats.py:1127-1152)."""
        assert self.count > 0
        a = _to_np(a)
        assert a.shape[0] == self.depth
        summary, weights = self._weighted_summary()
        cumw = np.cumsum(weights, axis=-1) - weights / 2
        cumw /= np.sum(weights, axis=-1, keepdims=True)
        flat = a.reshape(self.depth, -1)
        out = np.stack([
            np.clip(np.interp(flat[d], summary[d], cumw[d]), 0.0, 1.0)
            for d in range(self.depth)
        ]).astype(np.float32)
        return out.reshape(a.shape)

    def size(self):
        return self.count

    # -- persistence (reference schema, runningstats.py:946-984) -----------

    def state_dict(self):
        state = dict(
            constructor=self._constructor_name(),
            resolution=self.resolution,
            depth=self.depth,
            buffersize=self.buffersize,
            samplerate=self.samplerate,
            sizes=np.array([d.shape[1] for d in self.data]),
            extremes=np.asarray(self.extremes),
            size=self.count,
            batchcount=self.batchcount,
        )
        for i, (d, ff) in enumerate(zip(self.data, self.firstfree)):
            state[f"data.{i}"] = np.asarray(d)[:, :ff].T
        return state

    def load_state_dict(self, state):
        self.resolution = int(state["resolution"])
        self.depth = int(state["depth"])
        self.buffersize = int(state["buffersize"])
        self.samplerate = float(state["samplerate"])
        self.firstfree, self.data = [], []
        for i, cap in enumerate(np.asarray(state["sizes"]).ravel()):
            d = np.asarray(state[f"data.{i}"])  # (ff, depth)
            buf = np.zeros((d.shape[1], int(cap)), d.dtype)
            buf[:, :d.shape[0]] = d.T
            self.firstfree.append(d.shape[0])
            self.data.append(buf)
        self.extremes = np.array(state["extremes"])
        self.count = int(state["size"])
        self.batchcount = int(state.get("batchcount", 0))
        self._rng = np.random.RandomState(None)


class TopK(Stat):
    """Running top-k values (+ stream indexes) per feature component
    (reference runningstats.py:1164-1260)."""

    def __init__(self, k: int = 100, largest: bool = True, state=None):
        self.k = k
        self.largest = largest
        self.count = 0
        self._values: Optional[np.ndarray] = None  # (depth, k)
        self._indexes: Optional[np.ndarray] = None
        super().__init__(state)

    def add(self, a, index=None):
        a = _to_np(a)
        if a.ndim == 1:
            a = a[:, None]
        a = a.reshape(a.shape[0], -1).T  # (depth, n)
        depth, n = a.shape
        idx = (np.arange(self.count, self.count + n) if index is None
               else _to_np(index))
        idx = np.broadcast_to(idx, (depth, n))
        self.count += n
        if self._values is None:
            self._values = np.empty((depth, 0), a.dtype)
            self._indexes = np.empty((depth, 0), np.int64)
        vals = np.concatenate([self._values, a], axis=1)
        idxs = np.concatenate([self._indexes, idx], axis=1)
        order = np.argsort(-vals if self.largest else vals, axis=1)[:, :self.k]
        self._values = np.take_along_axis(vals, order, axis=1)
        self._indexes = np.take_along_axis(idxs, order, axis=1)

    def result(self):
        return self._values, self._indexes

    def topk(self):
        return self.result()

    def state_dict(self):
        return dict(
            constructor=self._constructor_name(),
            k=self.k, largest=self.largest, count=self.count,
            values=np.asarray(self._values),
            indexes=np.asarray(self._indexes),
        )

    def load_state_dict(self, state):
        self.k = int(state["k"])
        self.largest = bool(state["largest"])
        self.count = int(state["count"])
        self._values = np.asarray(state["values"])
        self._indexes = np.asarray(state["indexes"])


class Bincount(Stat):
    """Running bincount over non-negative integer data
    (reference runningstats.py:514-560)."""

    def __init__(self, state=None):
        self.count = 0
        self._bincount: Optional[np.ndarray] = None
        super().__init__(state)

    def add(self, a, size=None):
        a = _to_np(a).reshape(-1)
        bc = np.bincount(a)
        if self._bincount is None:
            self._bincount = bc.astype(np.int64)
        elif len(self._bincount) < len(bc):
            bc = bc.astype(np.int64)
            bc[: len(self._bincount)] += self._bincount
            self._bincount = bc
        else:
            self._bincount[: len(bc)] += bc
        self.count += len(a) if size is None else size

    def bincount(self):
        return self._bincount

    def size(self):
        return self.count

    def state_dict(self):
        return dict(constructor=self._constructor_name(), count=self.count,
                    bincount=np.asarray(self._bincount))

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self._bincount = np.asarray(state["bincount"])


class History(Stat):
    """Concatenated history of added batches (reference runningstats.py:1278-1345)."""

    def __init__(self, state=None):
        self._data = []
        super().__init__(state)

    def add(self, a):
        self._data.append(_to_np(a))

    def history(self):
        return np.concatenate(self._data) if self._data else np.empty((0,))

    def state_dict(self):
        return dict(constructor=self._constructor_name(),
                    data=self.history())

    def load_state_dict(self, state):
        self._data = [np.asarray(state["data"])]


class IoU(Stat):
    """Running intersection-over-union of boolean feature columns
    (reference runningstats.py:675-720): accumulates ``a^T a`` over 0/1
    batches; iou = intersection / (union + eps)."""

    def __init__(self, state=None):
        self.count = 0
        self._intersection = None
        super().__init__(state)

    def add(self, a):
        a = _to_np(a)
        assert a.ndim == 2
        a = a.astype(np.float32)
        if self._intersection is None:
            self._intersection = a.T @ a
        else:
            self._intersection += a.T @ a
        self.count += len(a)

    def size(self):
        return self.count

    def intersection(self):
        return self._intersection

    def union(self):
        total = np.diagonal(self._intersection)
        return total[:, None] + total[None, :] - self._intersection

    def iou(self):
        return self.intersection() / (self.union() + 1e-20)

    def state_dict(self):
        return dict(constructor=self._constructor_name(),
                    count=self.count,
                    intersection=np.asarray(self._intersection))

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self._intersection = np.asarray(state["intersection"])
