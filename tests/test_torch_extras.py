"""PyTorch port, ``stats/extras`` against the JAX package: the readouts of
``Quantile``, ``TopK``, ``Bincount``, ``History`` and ``IoU`` on the same
data (torch tensors into the port, numpy into the JAX package), and each
statistic's npz state written by one package and loaded by the other.

``Quantile`` draws its subsamples from ``np.random.RandomState(seed)`` in
both packages in the same order, so two sketches seeded the same keep the
same samples: their readouts are held equal, bit for bit.  Its accuracy is
held separately, as the rank error of its 0.1-0.9 quantiles in the full
stream (the share of rows at or below the estimate, minus q): at most 0.02
with r = 256 over 4000 rows (no subsampling; 0.005 at worst over ten
seeds), at most 0.2 with r = 8 over 20000 rows (the sample rate down to
1/32; 0.15 at worst over ten seeds).  The other statistics are exact
(equal arrays).
"""

import numpy as np
import pytest
import torch

from emcid_tpu.stats import extras as jx

from emcid_torch.stats import extras as tx

from torch_parity import one_torch_thread  # noqa: F401

QS = [0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99]


def _quantile_pair(r, rows, seed=0):
    data = np.random.RandomState(1).randn(rows, 3).astype(np.float32)
    j, t = jx.Quantile(r=r, seed=seed), tx.Quantile(r=r, seed=seed)
    for chunk in np.array_split(data, 10):
        j.add(chunk)
        t.add(torch.from_numpy(chunk))
    return j, t, data


def _quantile_readouts(q):
    probe = np.linspace(-2, 2, 9, dtype=np.float32)[None].repeat(q.depth, 0)
    return dict(quantiles=q.quantiles(QS), median=q.median(),
                minmax=q.minmax(), mean=q.mean(), variance=q.variance(),
                stdev=q.stdev(unbiased=False), readout=q.readout(11),
                normalize=q.normalize(probe),
                cube=q.integrate(lambda x: x ** 3), size=q.size())


@pytest.mark.parametrize("r,rows", [(64, 4000), (8, 20000)],
                         ids=["kept", "subsampled"])
def test_quantile_readouts_match_jax(r, rows):
    """Seeded the same, both keep the same samples: every readout equal,
    the extremes those of the whole stream."""
    j, t, data = _quantile_pair(r, rows)
    assert (t.samplerate < 1.0) == (rows == 20000)
    assert t.samplerate == j.samplerate and t.firstfree == j.firstfree
    jr, tr = _quantile_readouts(j), _quantile_readouts(t)
    for k in jr:
        np.testing.assert_array_equal(np.asarray(jr[k]), np.asarray(tr[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tr["minmax"][:, 0], data.min(0))
    np.testing.assert_array_equal(tr["minmax"][:, 1], data.max(0))


@pytest.mark.parametrize("r,rows,tol", [(256, 4000, 0.02), (8, 20000, 0.2)],
                         ids=["kept", "subsampled"])
def test_quantile_rank_error(r, rows, tol):
    """The port's 0.1-0.9 quantiles, over three seeds of data and draws:
    the rank of each estimate in the stream within ``tol`` of q."""
    qs = np.array([0.1, 0.25, 0.5, 0.75, 0.9])
    for seed in (3, 4, 5):
        data = np.random.RandomState(seed).randn(rows, 3).astype(np.float32)
        q = tx.Quantile(r=r, seed=seed)
        for chunk in np.array_split(data, 10):
            q.add(torch.from_numpy(chunk))
        est = q.quantiles(qs)  # (3, 5)
        rank = np.stack([(data[:, d][None] <= est[d][:, None]).mean(1)
                         for d in range(3)])
        assert np.abs(rank - qs).max() <= tol, (seed, rank)


def _topk(pkg, host):
    s = pkg.TopK(k=5)
    r = np.random.RandomState(6)
    for _ in range(3):
        s.add(host(r.randn(7, 4).astype(np.float32)))
    s.add(host(r.randn(2, 4).astype(np.float32)),
          index=host(np.array([100, 101])))
    return s


def _topk_smallest(pkg, host):
    s = pkg.TopK(k=3, largest=False)
    s.add(host(np.random.RandomState(7).randn(9, 2).astype(np.float32)))
    return s


def _bincount(pkg, host):
    s = pkg.Bincount()
    s.add(host(np.array([0, 2, 2, 5])))
    s.add(host(np.array([1, 9, 9, 9])))  # grows the counts
    s.add(host(np.array([3])), size=10)
    return s


def _history(pkg, host):
    s = pkg.History()
    r = np.random.RandomState(8)
    for n in (2, 3):
        s.add(host(r.randn(n, 3).astype(np.float32)))
    return s


def _iou(pkg, host):
    s = pkg.IoU()
    r = np.random.RandomState(9)
    for _ in range(2):
        s.add(host((r.rand(6, 4) > 0.5).astype(np.float32)))
    return s


def _quantile(pkg, host):
    s = pkg.Quantile(r=8, seed=10)
    for chunk in np.array_split(
            np.random.RandomState(11).randn(3000, 2).astype(np.float32), 5):
        s.add(host(chunk))
    return s


READOUTS = {
    "topk": (_topk, lambda s: (*s.result(), s.count)),
    "topk_smallest": (_topk_smallest, lambda s: (*s.topk(), s.count)),
    "bincount": (_bincount, lambda s: (s.bincount(), s.size())),
    "history": (_history, lambda s: (s.history(),)),
    "iou": (_iou, lambda s: (s.intersection(), s.union(), s.iou(),
                             s.size())),
    "quantile": (_quantile, lambda s: tuple(_quantile_readouts(s).values())),
}


@pytest.mark.parametrize("name", sorted(READOUTS))
def test_readouts_match_jax(name):
    """Every readout equal; the port takes torch tensors, the JAX package
    numpy arrays."""
    build, read = READOUTS[name]
    ref = read(build(jx, np.asarray))
    got = read(build(tx, torch.from_numpy))
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("name", sorted(READOUTS))
def test_npz_state_loads_across_packages(name, direction, tmp_path):
    """A statistic saved to npz by one package loads in the other (through
    ``Stat(state=path)``) with the same readouts."""
    build, read = READOUTS[name]
    src, dst = (jx, tx) if direction == "jax_to_torch" else (tx, jx)
    host = np.asarray if src is jx else torch.from_numpy
    stat = build(src, host)
    path = tmp_path / f"{name}.npz"
    stat.save(path)
    loaded = getattr(dst, type(stat).__name__)(state=str(path))
    for a, b in zip(read(stat), read(loaded)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_exports():
    import emcid_torch.stats as ts

    for name in ("Quantile", "TopK", "Bincount", "History", "IoU"):
        assert getattr(ts, name) is getattr(tx, name)
        assert issubclass(getattr(tx, name), ts.Stat)
