"""PyTorch port, the fused norms (K5 GroupNorm(+SiLU), K6 LayerNorm(+act)):
their plain versions against the JAX package's Pallas kernels in interpret
mode on the same numpy inputs (forward, VJP and GroupNorm's saved
statistics), the knobs ``EMCID_TPU_FUSED_GN``/``EMCID_TPU_FUSED_LN`` in the
tiny UNet against the JAX tiny UNet under the same knobs, and the dispatch.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against these plain versions there); on CPU tensors the wrappers compute
the plain versions and launch nothing.  The backwards' route pickers
(K5b ``resident``/``stream``, K6b ``rows``/``generic``) are pure Python on
shapes, dtypes and alignment, so they are held here at the UNet's shapes.  Tolerances: f32 on both sides,
differing only in summation order, so 1e-5 of the largest reference value
for one norm and 1e-4 through the whole tiny UNet (as
``test_torch_models``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from emcid_tpu.models.loader import build_tiny_pipeline
from emcid_tpu.ops import groupnorm as jgn
from emcid_tpu.ops import layernorm as jln

from emcid_torch.models import unet as tunet
from emcid_torch.ops import _build
from emcid_torch.ops import groupnorm as tgn
from emcid_torch.ops import layernorm as tln
from torch_parity import TINY_WORDS, port_components, rel_diff

OP_TOL = 1e-5
UNET_TOL = 1e-4


def _inputs(shape, seed):
    r = np.random.RandomState(seed)
    C = shape[-1]
    return (r.randn(*shape).astype(np.float32) * 2.0 + 0.5,
            r.randn(*shape).astype(np.float32),
            (1.0 + 0.3 * r.randn(C)).astype(np.float32),
            (0.2 * r.randn(C)).astype(np.float32))


def _nchw(a):
    """channel-last numpy (B, ..., C) -> channels-first torch (B, C, ...)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.permute(0, t.dim() - 1, *range(1, t.dim() - 1)).contiguous()


def _nhwc(t):
    return t.permute(0, *range(2, t.dim()), 1).detach().numpy()


# channels per group 2, 10 (the 320-channel spans), 80, then 20 and 30
# (the 640- and 960-channel spans: resident and stream at 384 px)
GN_SHAPES = [(2, 8, 8, 64), (2, 12, 12, 320), (1, 6, 6, 2560),
             (1, 8, 8, 640), (1, 8, 8, 960)]


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_groupnorm_plain_matches_pallas(shape, act):
    """K5f/K5b plain versions (directly and through the autograd.Function)
    against ``gn_act_pallas(..., interpret=True)``: y, the (B, 2, G)
    statistics, and the VJP's dx, dscale, dbias."""
    G, eps = 32, 1e-6
    x, g, sc, bi = _inputs(shape, seed=len(shape) + shape[-1])
    jx, jsc, jbi = map(jnp.asarray, (x, sc, bi))
    B, C = shape[0], shape[-1]
    y_ref, st_ref = jgn._fwd_call(jx.reshape(B, -1, C), jsc, jbi, G, eps, act,
                                  True)
    fn = lambda x, s, b: jgn.gn_act_pallas(x, s, b, G, eps, act, True)
    _, vjp = jax.vjp(fn, jx, jsc, jbi)
    dx_ref, dsc_ref, dbi_ref = vjp(jnp.asarray(g))

    tx = _nchw(x).requires_grad_()
    tsc = torch.from_numpy(sc).requires_grad_()
    tbi = torch.from_numpy(bi).requires_grad_()
    y, st = tgn.gn_fwd(tx.detach(), tsc.detach(), tbi.detach(), G, eps, act)
    assert rel_diff(np.asarray(y_ref).reshape(shape), _nhwc(y)) <= OP_TOL
    assert rel_diff(st_ref, st) <= OP_TOL
    dx, dsc, dbi = tgn.gn_bwd(tx.detach(), _nchw(g), tsc.detach(),
                              tbi.detach(), st, G, act)
    tgn.gn_act(tx, tsc, tbi, G, eps, act).backward(_nchw(g))
    for got_dx, got_dsc, got_dbi in ((dx, dsc, dbi),
                                     (tx.grad, tsc.grad, tbi.grad)):
        assert rel_diff(dx_ref, _nhwc(got_dx)) <= OP_TOL
        assert rel_diff(dsc_ref, got_dsc) <= OP_TOL
        assert rel_diff(dbi_ref, got_dbi) <= OP_TOL


def test_groupnorm_plain_group_sums_vanish():
    """ROADMAP F2 on the plain backward: with act none the per-group sum of
    dx is zero in exact arithmetic; in f32 |sum dx| / sum |dx| < 1e-4 (the
    bias the JAX kernel showed on hardware was O(1))."""
    x, g, sc, bi = _inputs((2, 16, 16, 320), seed=9)
    tx = _nchw(x)
    _, st = tgn.gn_fwd_plain(tx, torch.from_numpy(sc), torch.from_numpy(bi),
                             32, 1e-5)
    dx, _, _ = tgn.gn_bwd_plain(tx, _nchw(g), torch.from_numpy(sc),
                                torch.from_numpy(bi), st, 32)
    dg = dx.double().reshape(2, 32, -1)
    assert (dg.sum(-1).abs() / dg.abs().sum(-1)).max() < 1e-4


# the rows route's classes (320 at 4-byte, 640 at 8-byte, 1280 at
# 16-byte bf16 accesses) and a narrow row
LN_SHAPES = [(2, 64, 320), (2, 77, 64), (1, 144, 1280), (2, 16, 640)]


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layernorm_plain_matches_pallas(shape, act):
    """K6f/K6b plain versions (directly and through the autograd.Function)
    against ``ln_act_pallas(..., interpret=True)``: y and the VJP."""
    eps = 1e-5
    x, g, sc, bi = _inputs(shape, seed=shape[1])
    jx, jsc, jbi = map(jnp.asarray, (x, sc, bi))
    fn = lambda x, s, b: jln.ln_act_pallas(x, s, b, eps, act, True)
    y_ref, vjp = jax.vjp(fn, jx, jsc, jbi)
    dx_ref, dsc_ref, dbi_ref = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_()
    tsc = torch.from_numpy(sc).requires_grad_()
    tbi = torch.from_numpy(bi).requires_grad_()
    assert rel_diff(y_ref, tln.ln_fwd(tx.detach(), tsc.detach(),
                                      tbi.detach(), eps, act)) <= OP_TOL
    direct = tln.ln_bwd(tx.detach(), torch.from_numpy(g), tsc.detach(),
                        tbi.detach(), eps, act)
    tln.layer_norm_act(tx, tsc, tbi, eps=eps, act=act).backward(
        torch.from_numpy(g))
    for got in (direct, (tx.grad, tsc.grad, tbi.grad)):
        for ref, t in zip((dx_ref, dsc_ref, dbi_ref), got):
            assert rel_diff(ref, t) <= OP_TOL


def test_geo_wins_matches_jax():
    shapes = [(24, 64, 64, 320), (24, 48, 48, 640), (24, 64, 64, 640),
              (24, 32, 32, 1280), (24, 16, 16, 1280), (2, 8, 8, 64),
              (12, 2304, 960), (12, 2048, 640), (12, 2047, 320)]
    for s in shapes:
        assert tgn.geo_wins(s) == jgn.geo_wins(s), s


def test_knob_parsing(monkeypatch):
    """The knobs keep the JAX package's values: GN takes 0, 1 or geo and
    anything else means 0; LN is on only at 1."""
    for v, want in (("0", "0"), ("1", "1"), ("geo", "geo"), ("banana", "0"),
                    ("GEO", "0"), ("", "0")):
        monkeypatch.setenv("EMCID_TPU_FUSED_GN", v)
        assert tunet._fused_gn() == want, v
    monkeypatch.delenv("EMCID_TPU_FUSED_GN")
    assert tunet._fused_gn() == "0"
    for v, want in (("1", True), ("0", False), ("true", False)):
        monkeypatch.setenv("EMCID_TPU_FUSED_LN", v)
        assert tunet._fused_ln() is want, v
    monkeypatch.delenv("EMCID_TPU_FUSED_LN")
    assert tunet._fused_ln() is False


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline(seed=0, words=TINY_WORDS)
    return comps, port_components(comps)


def _unet_inputs():
    r = np.random.RandomState(11)
    return (r.randn(2, 8, 8, 4).astype(np.float32),
            np.array([10, 700], np.int32),
            r.randn(2, 32, 32).astype(np.float32),
            r.randn(2, 8, 8, 4).astype(np.float32))


def _jax_eps_grad(comps, x, t, ctx, w):
    def f(c):
        eps = comps.unet.apply({"params": comps.unet_params}, jnp.asarray(x),
                               jnp.asarray(t), c).sample
        return jnp.sum(eps * jnp.asarray(w)), eps

    (_, eps), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(ctx))
    return np.asarray(eps), np.asarray(grad)


def _port_eps_grad(pc, x, t, ctx, w):
    c = torch.from_numpy(ctx).requires_grad_()
    eps = pc.unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(t), c).sample.permute(0, 2, 3, 1)
    (eps * torch.from_numpy(w)).sum().backward()
    return eps.detach(), c.grad


@pytest.mark.parametrize("gn", ["1", "geo"])
def test_unet_with_fused_knobs_matches_jax(pair, monkeypatch, gn):
    """The tiny UNet with EMCID_TPU_FUSED_GN=gn and EMCID_TPU_FUSED_LN=1 in
    both packages: eps and the gradient into the text context (off the
    TPU, JAX runs its reference math at every site, the port its plain
    versions)."""
    comps, pc = pair
    monkeypatch.setenv("EMCID_TPU_FUSED_GN", gn)
    monkeypatch.setenv("EMCID_TPU_FUSED_LN", "1")
    x, t, ctx, w = _unet_inputs()
    eps_j, grad_j = _jax_eps_grad(comps, x, t, ctx, w)
    eps_t, grad_t = _port_eps_grad(pc, x, t, ctx, w)
    assert rel_diff(eps_j, eps_t) <= UNET_TOL
    assert rel_diff(grad_j, grad_t) <= UNET_TOL


def test_unet_knobs_off_is_stock(pair, monkeypatch):
    """An unknown GN value runs the stock modules: bit-equal to the knobs
    unset."""
    _, pc = pair
    x, t, ctx, w = _unet_inputs()
    monkeypatch.delenv("EMCID_TPU_FUSED_GN", raising=False)
    monkeypatch.delenv("EMCID_TPU_FUSED_LN", raising=False)
    base, _ = _port_eps_grad(pc, x, t, ctx, w)
    monkeypatch.setenv("EMCID_TPU_FUSED_GN", "banana")
    monkeypatch.setenv("EMCID_TPU_FUSED_LN", "yes")
    off, _ = _port_eps_grad(pc, x, t, ctx, w)
    assert torch.equal(base, off)


def test_state_dict_same_with_knobs(monkeypatch):
    """The norm modules hold the parameters whichever path runs: the same
    names, shapes and values, and a strict load across."""
    from emcid_torch.models.configs import tiny_unet

    def build():
        torch.manual_seed(0)
        return tunet.UNet2DCondition(tiny_unet())

    monkeypatch.setenv("EMCID_TPU_FUSED_GN", "1")
    monkeypatch.setenv("EMCID_TPU_FUSED_LN", "1")
    on = build().state_dict()
    monkeypatch.delenv("EMCID_TPU_FUSED_GN")
    monkeypatch.delenv("EMCID_TPU_FUSED_LN")
    off_model = build()
    off = off_model.state_dict()
    assert list(on) == list(off)
    for k in on:
        assert torch.equal(on[k], off[k]), k
    off_model.load_state_dict(on, strict=True)


def test_cpu_wrappers_launch_nothing():
    _build.reset_launches()
    x, g, sc, bi = _inputs((2, 8, 8, 64), seed=3)
    tx = _nchw(x).requires_grad_()
    tgn.group_norm_act(tx, torch.from_numpy(sc), torch.from_numpy(bi),
                       num_groups=32, eps=1e-5, act="silu").sum().backward()
    lx = torch.from_numpy(x.reshape(2, 64, 64)).requires_grad_()
    tln.layer_norm_act(lx, torch.from_numpy(sc), torch.from_numpy(bi),
                       eps=1e-5).sum().backward()
    assert all(n == 0 for n in _build.LAUNCHES.values())
    assert set(_build.LAUNCHES) >= {"K5f groupnorm_fwd", "K5b groupnorm_bwd",
                                    "K6f layernorm_fwd", "K6b layernorm_bwd"}


# (C, S, dtype, route) of K5b at G = 32: the UNet's bf16 spans at 384 px
# (48x48) and 512 px (64x64) and deeper levels, the model check's f32
# spans, and ragged f32 spans (a span of 84 bytes is not whole 16-byte
# pieces)
GN_ROUTES = [
    (320, 2304, torch.bfloat16, "resident"),
    (640, 2304, torch.bfloat16, "resident"),
    (960, 2304, torch.bfloat16, "stream"),
    (320, 4096, torch.bfloat16, "resident"),
    (640, 4096, torch.bfloat16, "stream"),
    (1280, 576, torch.bfloat16, "resident"),
    (2560, 36, torch.bfloat16, "resident"),
    (320, 2304, torch.float32, "resident"),
    (640, 2304, torch.float32, "stream"),
    (64, 300, torch.float32, "resident"),
    (96, 7, torch.float32, "stream"),
]


@pytest.mark.parametrize("C,S,dtype,route", GN_ROUTES)
def test_gn_bwd_route(C, S, dtype, route):
    """``resident`` exactly where the span's x and g fit one block's
    shared memory (and are whole 16-byte pieces), else ``stream``."""
    x = torch.empty(2, C, S, dtype=dtype)
    assert tgn.gn_bwd_route(x, 32, torch.empty_like(x)) == route


# (rows shape, dtype, route) of K6b
LN_ROUTES = [
    ((12, 2304, 320), torch.bfloat16, "rows"),
    ((12, 576, 640), torch.bfloat16, "rows"),
    ((12, 144, 1280), torch.bfloat16, "rows"),
    ((2, 77, 64), torch.float32, "rows"),
    ((2, 77, 320), torch.float32, "rows"),
    ((2, 77, 640), torch.float32, "rows"),
    ((2, 77, 1280), torch.float32, "generic"),
    ((3, 5, 3000), torch.float32, "generic"),
    ((2, 7, 77), torch.bfloat16, "generic"),
    ((2, 5, 96), torch.bfloat16, "generic"),
]


@pytest.mark.parametrize("shape,dtype,route", LN_ROUTES)
def test_ln_bwd_route(shape, dtype, route):
    """``rows`` where C = 32 * V * nv with nv <= 5 (V elements in one
    access of 4 to 16 bytes), else ``generic``."""
    x = torch.empty(shape, dtype=dtype)
    assert tln.ln_bwd_route(x, torch.empty_like(x)) == route


@pytest.mark.parametrize("route_of", ["gn", "ln"])
def test_bwd_routes_need_16_byte_alignment(route_of):
    """A tensor off a 16-byte boundary sends either backward to its
    general route."""
    buf = torch.empty(2 * 320 * 64 + 1, dtype=torch.bfloat16)
    off = buf[1:].view(2, 320, 64)
    ok = torch.empty(2, 320, 64, dtype=torch.bfloat16)
    if route_of == "gn":
        assert tgn.gn_bwd_route(ok, 32, ok) == "resident"
        assert tgn.gn_bwd_route(ok, 32, off) == "stream"
    else:
        assert tln.ln_bwd_route(ok, ok) == "rows"
        assert tln.ln_bwd_route(ok, off) == "generic"


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", ["gn", "ln"])
def test_cpu_backward_types(norm, pdtype):
    """On CPU tensors the backward wrappers return (C,) float32 dscale and
    dbias (their plain versions), and the autograd Functions return the
    parameters' type, launching nothing."""
    _build.reset_launches()
    x, g, sc, bi = _inputs((2, 4, 4, 64), seed=5)
    tsc = torch.from_numpy(sc).to(pdtype)
    tbi = torch.from_numpy(bi).to(pdtype)
    if norm == "gn":
        tx = _nchw(x)
        _, st = tgn.gn_fwd(tx, tsc, tbi, 32, 1e-5)
        out = tgn.gn_bwd(tx, _nchw(g), tsc, tbi, st, 32)
        fused = lambda x, s, b: tgn.gn_act(x, s, b, 32, 1e-5)
        tg = _nchw(g)
    else:
        tx = torch.from_numpy(x.reshape(2, 16, 64))
        tg = torch.from_numpy(g.reshape(2, 16, 64))
        out = tln.ln_bwd(tx, tg, tsc, tbi, 1e-5)
        fused = lambda x, s, b: tln.layer_norm_act(x, s, b, eps=1e-5)
    assert out[0].shape == tx.shape
    for t in out[1:]:
        assert t.shape == (64,) and t.dtype == torch.float32
    xa, sa, ba = (t.clone().requires_grad_() for t in (tx, tsc, tbi))
    fused(xa, sa, ba).backward(tg)
    assert sa.grad.dtype == pdtype and ba.grad.dtype == pdtype
    assert torch.equal(sa.grad, out[1].to(pdtype))
    assert all(n == 0 for n in _build.LAUNCHES.values())


def test_norm_bwd_routes_counted_and_reset():
    """K5b and K6b count their launches per route in ``_build.ROUTES``,
    and ``reset_launches`` zeroes them."""
    assert set(_build.ROUTES["K5b groupnorm_bwd"]) == set(tgn.GN_BWD_ENTRY)
    assert set(_build.ROUTES["K6b layernorm_bwd"]) == set(tln.LN_BWD_ENTRY)
    _build.ROUTES["K5b groupnorm_bwd"]["resident"] = 3
    _build.ROUTES["K6b layernorm_bwd"]["generic"] = 2
    _build.reset_launches()
    assert all(n == 0 for k in ("K5b groupnorm_bwd", "K6b layernorm_bwd")
               for n in _build.ROUTES[k].values())


@pytest.mark.parametrize("parts,groups", [(1, 1), (2, 1), (5, 2), (9, 3),
                                          (528, 23), (1056, 32)])
def test_fold_groups(parts, groups):
    """The two-level fold's group count (``fold_group_size`` in
    ``csrc/common.cuh``: ceil(sqrt(parts)) blocks a group), within the
    counters a device keeps."""
    assert _build.fold_groups(parts) == groups
    assert groups + 1 <= _build.FOLD_COUNTERS
