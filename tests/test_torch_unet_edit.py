"""PyTorch port, the UNet seams (``unet_taps``, ``unet_inject``) and the UNet
region edit (``emcid_torch.engine.unet_edit``) and UNet-layer covariances
(``emcid_torch.engine.unet_stats``) against the JAX package on the tiny
pipeline, with the JAX package's draws replayed from its own key schedule.

Tolerances: f32 on both sides, differing in summation order only: 1e-5 of
the largest reference value for the taps, eps under injects and the
gradients into the injects; equality for the layer walk, the conv-matrix
round trip, ``dilate`` and the nearest resize, 1e-6 for the pre-fold
delta; 1e-4 for the block outputs, the module inputs, the Stage-2 weights
and the UNet-layer covariances; 1e-4 relative Frobenius for the Stage-1
deltas after 3 Adam steps and for Stage 2's (adj_k, resid) (Adam divides
each gradient element by its own size, so an element whose gradient is
near zero carries the summation-order difference at full size: its
largest element error sits at 1.0e-4 of the largest element).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import emcid_tpu.engine.unet_edit as jue
from emcid_tpu.engine.uce import unet_param_path
from emcid_tpu.models.loader import build_tiny_pipeline

import emcid_torch.engine.unet_edit as tue
from emcid_torch.models.unet import TAP_LEAVES, unet_inject, unet_taps
from torch_parity import TINY_WORDS, one_torch_thread, port_components, rel_diff  # noqa: F401

RES = "up_blocks.1.resnets.1"
ATTN = "up_blocks.1.attentions.1.transformer_blocks.0.attn2"
FF = "up_blocks.1.attentions.1.transformer_blocks.0.ff"
MID_ATTN = "mid_block.attentions.0.transformer_blocks.0.attn2"
OWNERS = {"conv2_in": RES, "conv2_out": RES, "kv_in": ATTN, "k_out": ATTN,
          "v_out": ATTN, "attn_out_in": ATTN, "attn_out_out": MID_ATTN,
          "ff2_in": FF, "ff2_out": FF}
SEAMS = (f"{RES}.conv2", f"{ATTN}.to_k", f"{ATTN}.to_v", MID_ATTN,
         f"{FF}.net.2")
REQ = {"prompts": ["a photo of a {}", "an image of a {}"], "source": "cat",
       "dest": "dog", "seed_train": 0,
       "dest_prompts": ["a photo of a dog", "an image of a dog"]}
P = 2


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline(seed=0, words=TINY_WORDS)
    return comps, port_components(comps)


@pytest.fixture
def tiny_walk(monkeypatch):
    """The tiny UNet's two levels in both packages' layer walk."""
    for mod in (jue, tue):
        monkeypatch.setattr(mod, "_NUM_UP", 2)
        monkeypatch.setattr(mod, "_NUM_DOWN", 2)


def _hp(pkg, **over):
    d = {
        "final_layer": ["up_blocks", 1, "attn-out", 1],
        "spread_sub_block_cnt": 2, "skip_res_conv": False,
        "v_reduce_inside_img": True, "v_reduce_for_concept": True,
        "gloabl_sample": True, "num_t_blocks": 2, "even_sample": True,
        "v_num_grad_steps": 3, "v_lr": 0.05, "v_weight_decay": 5e-4,
        "clamp_norm_factor": 1.5, "objective": "ablate-source",
        "esd_mu": None, "mom2_update_weight": 100,
        "rewrite_module_tmp": {
            "mlp": "{}.{}.attentions.{}.transformer_blocks.0.ff.net.2",
            "conv-res": "{}.{}.resnets.{}.conv2",
            "conv-sample": "{}.{}.{}.0.conv"},
        "mom2_dataset": "css_filtered", "mom2_n_samples_prompts": 10,
        "mom2_n_steps_per_prompt": 2, "mom2_dtype": "float32",
    }
    d.update(over)
    return pkg.UNetEMCIDHyperParams.from_dict(d)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy() if t.dim() == 4 \
        else t.detach().numpy()


def _inputs(seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([700, 30], np.int32)
    ctx = rng.randn(2, 32, 32).astype(np.float32)
    injects = {  # JAX layouts: conv NHWC, the rest (B, N, C)
        f"{RES}.conv2": rng.randn(2, 8, 8, 32),
        f"{ATTN}.to_k": rng.randn(2, 32, 32),
        f"{ATTN}.to_v": rng.randn(2, 32, 32),
        MID_ATTN: rng.randn(2, 16, 64),
        f"{FF}.net.2": rng.randn(2, 64, 32),
    }
    return x, t, ctx, {k: (0.1 * v).astype(np.float32)
                       for k, v in injects.items()}


def _port_inject(injects, grad=False):
    out = {}
    for k, v in injects.items():
        v = _nchw(v) if v.ndim == 4 else torch.from_numpy(v)
        out[k] = v.clone().requires_grad_(grad)
    return out


@pytest.fixture(scope="module")
def seam_run(pair):
    """One forward in each package with an inject at each of the five
    seam kinds and every tap leaf recorded; and the gradients of a
    weighted sum of eps into the injects."""
    comps, pc = pair
    x, t, ctx, inj = _inputs()
    w = np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32)

    def jloss(inject):
        eps, state = comps.unet.apply(
            {"params": comps.unet_params}, x, t, ctx, inject=inject,
            mutable=["intermediates"])
        return jnp.sum(eps.sample * w), (eps.sample, state["intermediates"])

    (_, (jeps, jint)), jgrad = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))({k: jnp.asarray(v) for k, v in inj.items()})
    jtaps = {}
    for leaf, owner in OWNERS.items():
        node = jint
        for p in unet_param_path(owner):
            node = node[p]
        jtaps[leaf] = np.asarray(node[leaf][0])
    spec = {}
    for leaf, owner in OWNERS.items():
        spec.setdefault(owner, []).append(leaf)
    tinj = _port_inject(inj, grad=True)
    with unet_taps(pc.unet, spec) as taps, unet_inject(pc.unet, tinj):
        teps = pc.unet(_nchw(x), torch.from_numpy(t),
                       torch.from_numpy(ctx)).sample
    (teps * _nchw(w)).sum().backward()
    ttaps = {leaf: _nhwc(taps[owner][leaf]) for leaf, owner in OWNERS.items()}
    return dict(jeps=np.asarray(jeps), teps=_nhwc(teps), jtaps=jtaps,
                ttaps=ttaps,
                jgrad={k: np.asarray(v) for k, v in jgrad.items()},
                tgrad={k: _nhwc(v.grad) for k, v in tinj.items()})


def test_inject_eps_matches_jax(seam_run):
    assert rel_diff(seam_run["jeps"], seam_run["teps"]) <= 1e-5


@pytest.mark.parametrize("leaf", sorted(TAP_LEAVES))
def test_tap_matches_jax_sow(seam_run, leaf):
    """Each leaf against JAX's ``sow``, under the injects: the order of
    each read against its module's inject is JAX's (``attn_out_out``
    before the attention inject, ``conv2_out``, ``ff2_out``, ``k_out``,
    ``v_out`` after theirs)."""
    a, b = seam_run["jtaps"][leaf], seam_run["ttaps"][leaf]
    assert a.shape == b.shape
    assert rel_diff(a, b) <= 1e-5


@pytest.mark.parametrize("seam", SEAMS)
def test_inject_grad_matches_jax(seam_run, seam):
    assert rel_diff(seam_run["jgrad"][seam], seam_run["tgrad"][seam]) <= 1e-5


def test_zero_inject_and_taps_leave_eps_bitwise(pair):
    _, pc = pair
    x, t, ctx, inj = _inputs()
    run = lambda: pc.unet(_nchw(x), torch.from_numpy(t),
                          torch.from_numpy(ctx)).sample
    ref = run()
    zeros = {k: torch.zeros_like(v) for k, v in _port_inject(inj).items()}
    with unet_inject(pc.unet, zeros):
        assert torch.equal(run(), ref)
    with unet_taps(pc.unet, {o: list(TAP_LEAVES)[:1] for o in (RES,)}):
        assert torch.equal(run(), ref)
    assert not pc.unet._forward_hooks and not pc.unet._forward_pre_hooks
    assert all(not m._forward_hooks and not m._forward_pre_hooks
               for m in pc.unet.modules())


# ---------------------------------------------------------------------------
# layer walk and conv-as-matmul
# ---------------------------------------------------------------------------

WALK_STARTS = [["up_blocks", 3, "attn-out", 2], ["up_blocks", 2, "mlp", 1],
               ["up_blocks", 0, "res-last-conv", 2],
               ["mid_block", 0, "attn-out", 0],
               ["mid_block", 0, "res-last-conv", 1],
               ["down_blocks", 2, "attn-out", 1],
               ["down_blocks", 3, "res-last-conv", 1],
               ["down_blocks", 0, "res-last-conv", 0],
               ["up_blocks", 1, "upsampler-conv", 0]]


def _walk(mod, layer, n=6):
    out = []
    for _ in range(n):
        try:
            layer = mod.backward_const_res_single(layer)
        except ValueError as e:
            out.append(str(e))
            break
        out.append((list(layer), mod.list2name(layer)))
    return out


@pytest.mark.parametrize("start", WALK_STARTS, ids=lambda s: "-".join(
    map(str, s)))
def test_layer_walk_equal(start):
    assert _walk(tue, list(start)) == _walk(jue, list(start))


@pytest.mark.parametrize("final,cnt,skip", [
    (["up_blocks", 3, "attn-out"], 4, False),
    (["up_blocks", 3, "res-last-conv"], 4, False),
    (["up_blocks", 2, "res-last-conv", 2], 3, True),
    (["mid_block", 0, "attn-out", 0], 3, False),
    (["down_blocks", 1, "mlp", 1], 2, False)])
def test_retrieve_spreading_layers_equal(final, cnt, skip):
    kw = dict(final_layer=final, spread_sub_block_cnt=cnt,
              skip_res_conv=skip)
    import emcid_tpu.hparams as jhp

    import emcid_torch.hparams as thp

    assert (tue.retrieve_spreading_layers(_hp(thp, **kw))
            == jue.retrieve_spreading_layers(_hp(jhp, **kw)))


def test_tiny_walk_monkeypatched(tiny_walk):
    import emcid_tpu.hparams as jhp

    import emcid_torch.hparams as thp

    for final in (["up_blocks", 1, "attn-out", 1],
                  ["up_blocks", 1, "res-last-conv", 1]):
        assert (tue.retrieve_spreading_layers(_hp(thp, final_layer=final))
                == jue.retrieve_spreading_layers(_hp(jhp, final_layer=final)))


def test_conv_matrix_round_trip_matches_jax():
    rng = np.random.RandomState(0)
    kern = rng.randn(3, 3, 8, 16).astype(np.float32)  # flax (kh, kw, in, out)
    weight = torch.from_numpy(kern).permute(3, 2, 0, 1)  # (out, in, kh, kw)
    mat = tue.conv_weight_as_matrix(weight)
    assert np.array_equal(mat.numpy(),
                          np.asarray(jue.conv_weight_as_matrix(kern)))
    assert torch.equal(tue.matrix_as_conv_weight(mat, 3, 3), weight)


def test_pre_fold_output_delta_matches_jax():
    delta = np.random.RandomState(1).randn(2, 7, 6, 5).astype(np.float32)
    ref = np.asarray(jue.pre_fold_output_delta(jnp.asarray(delta), 3))
    got = tue.pre_fold_output_delta(_nchw(delta), 3)
    assert rel_diff(ref.reshape(2, 42, 45), got) <= 1e-6


def test_dilate_matches_jax():
    m = (np.random.RandomState(2).rand(2, 9, 7) > 0.8).astype(np.float32)
    for k in (1, 3):
        assert np.array_equal(np.asarray(jue.dilate(jnp.asarray(m), k)),
                              tue.dilate(torch.from_numpy(m), k).numpy())


@pytest.mark.parametrize("side", [4, 3])
def test_nearest_resize_matches_jax(side):
    """Half-pixel centres: at 8 -> 4 both read rows 1, 3, 5, 7."""
    m = np.arange(2 * 8 * 8, dtype=np.float32).reshape(2, 8, 8)
    ref = np.asarray(jax.image.resize(jnp.asarray(m), (2, side, side),
                                      "nearest"))
    got = tue.resize_nearest(torch.from_numpy(m), side).numpy()
    assert np.array_equal(ref, got)
    if side == 4:
        assert np.array_equal(got[0, :, 0], m[0, [1, 3, 5, 7], 1])


# ---------------------------------------------------------------------------
# capture, Stage 1 and Stage 2 with JAX's draws replayed
# ---------------------------------------------------------------------------


def _posterior(seed=5):
    rng = np.random.RandomState(seed)
    mean = (rng.randn(1, P, 8, 8, 4) * 0.18).astype(np.float32)
    return mean, np.full(mean.shape, -3.0, np.float32)


def _region():
    region = np.zeros((P, 8, 8), np.float32)
    region[:, 2:6, 1:6] = 1.0
    region[1, 0, 0] = 1.0
    return region


def _jnp(a):
    return np.asarray(a)


def _delta_draws(rng, shape, n_blocks, steps, n_ts=1000):
    """``compute_delta_unet``'s key schedule in the JAX package."""
    block_size = n_ts // n_blocks
    rng, k_lat, k_orig = jax.random.split(rng, 3)
    post = jax.random.normal(k_lat, shape)
    o_noise, o_off, o_img = [], [], []
    for i in range(n_blocks):
        k2, k3, k4 = jax.random.split(jax.random.fold_in(k_orig, i), 3)
        o_off.append(int(jax.random.randint(k3, (), 0, block_size)))
        o_noise.append(_jnp(jax.random.normal(k2, shape)))
        o_img.append(int(jax.random.randint(k4, (), 0, shape[0])))
    noise, ts = [], []
    for key in jax.random.split(rng, steps):
        k2, k3 = jax.random.split(key)
        noise.append(_jnp(jax.random.normal(k2, shape)))
        ts.append(_jnp(jax.random.randint(k3, (shape[0],), 0, n_ts)))
    return tue.DeltaDraws(_jnp(post), np.stack(o_noise), np.array(o_off),
                          np.array(o_img), np.stack(noise), np.stack(ts))


def _region_draws(rng, shape, n_draws):
    """``_region_io``'s key schedule for one request's key ``rng``."""
    rng, k_lat = jax.random.split(rng)
    return tue.RegionDraws(
        _jnp(jax.random.normal(k_lat, shape)),
        np.stack([_jnp(jax.random.normal(jax.random.fold_in(rng, i), shape))
                  for i in range(n_draws)]))


@pytest.mark.parametrize("est", ["single", "batchmean"])
def test_capture_block_outputs_matches_jax(pair, monkeypatch, est):
    """``EMCID_TPU_UNET_ORIG_EST`` read at call time, both values."""
    from emcid_tpu.models.pipeline import encode_prompts as jenc

    from emcid_torch.models.pipeline import encode_prompts

    comps, pc = pair
    monkeypatch.setenv("EMCID_TPU_UNET_ORIG_EST", est)
    mean, _ = _posterior()
    lat0 = mean[0]
    mask = np.array(jax.image.resize(jnp.asarray(_region()), (P, 8, 8),
                                     "nearest")).reshape(P, 64, 1)
    name = "up_blocks.1.attentions.1.transformer_blocks.0.attn2.to_out.0"
    prompts = [p.format("cat") for p in REQ["prompts"]]
    key = jax.random.PRNGKey(3)
    ref = jue.capture_block_outputs(
        comps, jenc(comps, prompts), name, "attn-out", jnp.asarray(lat0),
        jnp.asarray(mask), 2, key)
    noise, off, img = [], [], []
    for i in range(2):
        k2, k3, k4 = jax.random.split(jax.random.fold_in(key, i), 3)
        noise.append(_jnp(jax.random.normal(k2, lat0.shape)))
        off.append(int(jax.random.randint(k3, (), 0, 500)))
        img.append(int(jax.random.randint(k4, (), 0, P)))
    got = tue.capture_block_outputs(
        pc, encode_prompts(pc, prompts), name, "attn-out",
        torch.from_numpy(lat0), torch.from_numpy(mask), 2,
        replay=tue.BlockDraws(np.stack(noise), np.array(off), np.array(img)))
    assert rel_diff(np.asarray(ref), got) <= 1e-4


def test_capture_module_inputs_matches_jax(pair, tiny_walk):
    comps, pc = pair
    mean, logvar = _posterior()
    name = "up_blocks.1.resnets.1.conv2"
    ts = [0, 500, 999]
    ref = jue.capture_module_inputs(comps, REQ, name, "res-last-conv", ts,
                                    mean, logvar)
    rng = jax.random.PRNGKey(0)
    eps, noise = [], []
    for i in range(len(ts)):
        k1, k2 = jax.random.split(jax.random.fold_in(rng, i))
        eps.append(_jnp(jax.random.normal(k1, mean[0].shape)))
        noise.append(_jnp(jax.random.normal(k2, mean[0].shape)))
    got = tue.capture_module_inputs(
        pc, REQ, name, "res-last-conv", ts, mean, logvar,
        replay=tue.InputDraws(np.stack(eps), np.stack(noise)))
    assert got.shape == (P, 64, 32)
    assert rel_diff(np.asarray(ref), got) <= 1e-4


DELTA_CASES = {
    "attn_out_dest": dict(final_layer=["up_blocks", 1, "attn-out", 1]),
    "attn_out_esd": dict(final_layer=["up_blocks", 1, "attn-out", 1],
                         objective="esd", esd_mu=1.0),
    "conv_sampled_noise": dict(final_layer=["up_blocks", 1,
                                            "res-last-conv", 1],
                               use_sampled_noise=True),
}


@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_compute_delta_unet_matches_jax(pair, tiny_walk, case):
    import emcid_tpu.hparams as jhp

    import emcid_torch.hparams as thp

    comps, pc = pair
    mean, logvar = _posterior()
    region = _region()
    over = DELTA_CASES[case]
    key = jax.random.PRNGKey(11)
    ref = jue.compute_delta_unet(comps, REQ, _hp(jhp, **over), mean, logvar,
                                 region, rng=key, verbose=False)
    draws = _delta_draws(key, mean[0].shape, 2, 3)
    got = tue.compute_delta_unet(pc, REQ, _hp(thp, **over), mean, logvar,
                                 region, replay=draws, verbose=False)
    assert got.shape == ref.shape and np.abs(ref).sum() > 0
    assert rel_diff(ref, got, "fro") <= 1e-4


@pytest.mark.parametrize("kind", ["attn-out", "res-last-conv"])
def test_execute_emcid_unet_matches_jax(pair, tiny_walk, kind):
    """Two requests (one with a per-layer covariance dict), the layer
    walk's two spreading layers, JAX's default key: the edited weights
    and the returned (adj_k, resid) against the JAX package's."""
    import emcid_tpu.hparams as jhp

    import emcid_torch.hparams as thp

    comps, pc = pair
    final = ["up_blocks", 1, kind, 1]
    jh, th = _hp(jhp, final_layer=final), _hp(thp, final_layer=final)
    lat = [_posterior(5), _posterior(6)]
    regions = [_region(), _region()[::-1].copy()]
    rng = np.random.RandomState(7)
    deltas = [(rng.randn(2, 32) * 0.3).astype(np.float32) for _ in range(2)]
    layers = jue.retrieve_spreading_layers(jh)
    assert len(layers) == 2
    covs = {}
    for name, _ in layers:
        a = rng.randn(200, 32).astype(np.float32)
        covs[name] = a.T @ a / 200
    reqs = [REQ, dict(REQ, source="dog")]
    jd, jed = jue.execute_emcid_unet(comps, reqs, jh, deltas, regions, lat,
                                     covs, verbose=False)
    per_block = len(range(0, 500, 500 // 4))
    draws = [_region_draws(jax.random.fold_in(jax.random.PRNGKey(0), r),
                           lat[r][0][0].shape, 2 * per_block)
             for r in range(2)]
    td, ted = tue.execute_emcid_unet(pc, reqs, th, deltas, regions, lat,
                                     covs, replay=draws, verbose=False)
    assert set(td) == set(jd)
    for k in jd:
        assert rel_diff(jd[k][0], td[k][0], "fro") <= 1e-4
        assert rel_diff(jd[k][1], td[k][1], "fro") <= 1e-4
    for name, coords in layers:
        wj = np.asarray(jue._module_weight(jed.unet_params, name,
                                           coords[2])[0])
        wt = tue._module_weight(ted.unet, name, coords[2])[0]
        w0 = tue._module_weight(pc.unet, name, coords[2])[0]
        assert rel_diff(wj, wt) <= 1e-4
        # the update itself, not only the weight it lands on
        assert rel_diff(wj - w0.numpy(), wt - w0, "fro") <= 1e-4
    # every other parameter is shared with the unedited UNet
    edited = {f"{n}.weight" for n, _ in layers}
    before = dict(pc.unet.named_parameters())
    for k, v in ted.unet.named_parameters():
        assert (v is before[k]) == (k not in edited), k


def test_layer_stats_unet_matches_jax(pair, tmp_path):
    """Three (image, caption) pairs, 2 forwards each, a conv input (NCHW
    flattened channel-last) with JAX's draws replayed in the loader's
    order; the cache files are named alike and read across packages."""
    from emcid_tpu.engine.unet_stats import layer_stats_unet as jls
    from emcid_tpu.stats.running import FixedRandomSubsetSampler

    from emcid_torch.engine.unet_stats import UnetStatsDraws, layer_stats_unet

    comps, pc = pair
    rng = np.random.RandomState(8)
    pairs = [(np.clip(rng.randn(16, 16, 3) * 0.5, -1, 1).astype(np.float32),
              f"a photo of a {w}") for w in ("cat", "dog", "w1")]
    name, kind, steps = "up_blocks.1.resnets.1.conv2", "res-last-conv", 2
    js = jls(comps, name, kind, pairs, stats_dir=tmp_path / "jax",
             t_steps_per_pair=steps)
    key = jax.random.PRNGKey(0)
    post, noise, ts = [], [], []
    for _ in FixedRandomSubsetSampler(len(pairs), None, seed=1):
        key, sub = jax.random.split(key)
        k0, k = jax.random.split(sub)
        post.append(_jnp(jax.random.normal(k0, (1, 8, 8, 4)))[0])
        n_p, t_p = [], []
        for i in range(steps):
            k1, k2 = jax.random.split(jax.random.fold_in(k, i))
            n_p.append(_jnp(jax.random.normal(k1, (1, 8, 8, 4)))[0])
            t_p.append(int(jax.random.randint(k2, (1,), 0, 1000)[0]))
        noise.append(np.stack(n_p))
        ts.append(t_p)
    ts_ = layer_stats_unet(pc, name, kind, pairs, stats_dir=tmp_path / "torch",
                           t_steps_per_pair=steps,
                           replay=UnetStatsDraws(np.stack(post),
                                                 np.stack(noise),
                                                 np.array(ts)))
    assert ts_.mom2.count == js.mom2.count == 3 * steps * 64
    assert rel_diff(np.asarray(js.mom2.moment()), ts_.mom2.moment()) <= 1e-4
    jfile = sorted((tmp_path / "jax").rglob("*.npz"))
    tfile = sorted((tmp_path / "torch").rglob("*.npz"))
    assert [p.name for p in jfile] == [p.name for p in tfile] != []
    cross = layer_stats_unet(pc, name, kind, pairs,
                             stats_dir=tmp_path / "jax",
                             t_steps_per_pair=steps)
    assert rel_diff(np.asarray(js.mom2.moment()), cross.mom2.moment()) <= 1e-7
    back = jls(comps, name, kind, pairs, stats_dir=tmp_path / "torch",
               t_steps_per_pair=steps)
    assert rel_diff(ts_.mom2.moment(), np.asarray(back.mom2.moment())) <= 1e-7
