"""PyTorch port, the streaming statistics (``NormMean``, ``Variance``,
``Covariance``, ``cache_load_enabled``) and the text pre-cache's ``mean``
and ``norm_mean`` statistics against the JAX package.

Tolerances: the same f32 rows on both sides, summed in other orders: 1e-6
of the largest reference value for the running statistics, 1e-5 for the
text encoder's statistics (a forward of the tiny CLIP first); the npz
states must load into the other package's class and give the same values.
"""

import numpy as np
import pytest

from emcid_tpu.models.loader import build_tiny_pipeline
from emcid_tpu.stats import running as jrun

from emcid_torch.stats import running as trun
from torch_parity import TINY_WORDS, one_torch_thread, port_components, rel_diff  # noqa: F401

STATS = {
    "NormMean": ("mean",),
    "Variance": ("mean", "variance", "stdev"),
    "Covariance": ("mean", "covariance", "correlation", "variance"),
}


def _batches(seed=0):
    """Three batches of (N, 4, 3) rows, the last one empty-free and
    short, so the Chan updates and the data shape both run."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, 4, 3) * 2 + 1).astype(np.float32)
            for n in (7, 5, 2)]


def _filled(pkg, name, seed=0):
    stat = getattr(pkg, name)()
    for b in _batches(seed):
        stat.add(b if name != "Covariance" else b.reshape(len(b), -1))
    return stat


@pytest.mark.parametrize("name", sorted(STATS))
def test_running_stat_matches_jax(name):
    js, ts = _filled(jrun, name), _filled(trun, name)
    assert ts.count == js.count
    for method in STATS[name]:
        a, b = np.asarray(getattr(js, method)()), getattr(ts, method)()
        assert a.shape == b.shape, method
        assert rel_diff(a, b) <= 1e-6, method


@pytest.mark.parametrize("name", sorted(STATS))
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_running_stat_npz_both_ways(name, direction, tmp_path):
    """A state saved by one package loads in the other (the reference
    npz schema) and gives the same values."""
    src, dst = (jrun, trun) if direction == "jax_to_torch" else (trun, jrun)
    stat = _filled(src, name)
    path = tmp_path / "state.npz"
    src.save_cached_state(str(path), stat, {"sample_size": 14})
    keys = set(np.load(path).keys())
    assert {"count", "mean", "constructor", "sample_size"} <= keys
    loaded = getattr(dst, name)(state=str(path))
    assert loaded.count == stat.count
    for method in STATS[name]:
        assert rel_diff(np.asarray(getattr(stat, method)()),
                        np.asarray(getattr(loaded, method)())) <= 1e-7


@pytest.mark.parametrize("pkg", [jrun, trun], ids=["jax", "torch"])
def test_cache_load_enabled(pkg, tmp_path):
    """``load_cached_state`` reads the file, except inside
    ``cache_load_enabled(False)``; the flag is restored after the scope."""
    stat = _filled(pkg, "Variance")
    path = str(tmp_path / "v.npz")
    pkg.save_cached_state(path, stat, {})
    assert pkg.load_cached_state(path, {}, quiet=True) is not None
    with pkg.cache_load_enabled(False):
        assert pkg.load_cached_state(path, {}, quiet=True) is None
        fresh = pkg.Variance()
        n = 0
        for b in pkg.tally(fresh, _batches(1), cache=path, quiet=True,
                           collate_fn=lambda items: items[0]):
            fresh.add(b)
            n += 1
        assert n == 3  # recomputed, not read from the cache
    # the recomputed state was written; it loads again after the scope
    again = pkg.load_cached_state(path, {}, quiet=True)
    assert again is not None and int(again["count"]) == 14


def test_stats_exports_match_jax():
    import emcid_tpu.stats as jstats

    import emcid_torch.stats as tstats

    running = {n for n in dir(jstats)
               if getattr(getattr(jstats, n), "__module__", "")
               == "emcid_tpu.stats.running"}
    assert running <= set(dir(tstats))


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline(seed=0, words=TINY_WORDS)
    return comps, port_components(comps)


def test_text_encoder_stats_mean_norm_mean(pair, tmp_path):
    """``layer_stats_text_encoder(to_collect=("mom2", "mean",
    "norm_mean"))`` over the same captions: each statistic and its count
    against the JAX package's, over the real tokens only, and the two
    packages' cache files load in each other."""
    from emcid_tpu.dsets.stat_dataset import make_synthetic_captions
    from emcid_tpu.engine.layer_stats import layer_stats_text_encoder as jls

    from emcid_torch.engine.layer_stats import STAT_TYPES
    from emcid_torch.engine.layer_stats import layer_stats_text_encoder as tls

    assert set(STAT_TYPES) == {"mom2", "mean", "norm_mean"}
    comps, pc = pair
    caps = make_synthetic_captions(37)
    collect = ("mom2", "mean", "norm_mean")
    name = "text_model.encoder.layers.2.mlp.fc2"
    kw = dict(to_collect=collect, sample_size=37, batch_size=16,
              captions=caps)
    js = jls(comps.text_encoder, comps.text_params, comps.tokenizer, name,
             stats_dir=tmp_path / "jax", **kw)
    ts = tls(pc.text_encoder, pc.tokenizer, name,
             stats_dir=tmp_path / "torch", **kw)
    assert ts.mom2.count == js.mom2.count == ts.mean.count == js.mean.count
    assert ts.norm_mean.count == js.norm_mean.count
    assert rel_diff(np.asarray(js.mom2.moment()), ts.mom2.moment()) <= 1e-5
    assert rel_diff(np.asarray(js.mean.mean()), ts.mean.mean()) <= 1e-5
    assert rel_diff(np.asarray(js.norm_mean.mean()),
                    ts.norm_mean.mean()) <= 1e-5
    # the cache files are named alike and read across packages
    jfile = sorted((tmp_path / "jax").rglob("*.npz"))
    tfile = sorted((tmp_path / "torch").rglob("*.npz"))
    assert [p.name for p in jfile] == [p.name for p in tfile] != []
    assert "mean-mom2-norm_mean" in tfile[0].name
    cross = tls(pc.text_encoder, pc.tokenizer, name,
                stats_dir=tmp_path / "jax", **dict(kw, captions=None))
    assert rel_diff(np.asarray(js.mean.mean()), cross.mean.mean()) <= 1e-7
    back = jls(comps.text_encoder, comps.text_params, comps.tokenizer, name,
               stats_dir=tmp_path / "torch", **dict(kw, captions=None))
    assert rel_diff(ts.norm_mean.mean(),
                    np.asarray(back.norm_mean.mean())) <= 1e-7
