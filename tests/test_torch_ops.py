"""PyTorch port, ops: attention dispatch (CPU path), the plain versions of
the four CUDA kernels, the route K1-K4 take for a dtype and head dim, and
the closed-form solve, each against the JAX package on the same numpy
inputs.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against these plain versions there); on CPU tensors each wrapper
computes its plain version and launches nothing.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from emcid_tpu.ops.attention import _flash_forward
from emcid_tpu.ops.attention import attention as jax_attention
from emcid_tpu.ops.flash_v2 import _bwd as jax_flash_v2_bwd
from emcid_tpu.ops.flash_v2 import _fwd as jax_flash_v2_fwd
from emcid_tpu.ops.flash_v2 import flash_attention_v2 as jax_flash_v2
from emcid_tpu.ops.solve import solve_adj_k as jax_solve

from emcid_torch.ops import _build
from emcid_torch.ops.attention import (
    SHORT_KV_ENTRY,
    attention,
    flash_attention,
    mha_chunked,
    short_kv_fwd,
    short_kv_route,
)
from emcid_torch.ops import flash_v2 as fv2
from emcid_torch.ops.flash_v2 import (
    bwd_route,
    flash_attention_v2,
    flash_dkv_plain,
    flash_dq_plain,
    flash_fwd,
    fwd_route,
    row_delta,
)
from emcid_torch.ops.groupnorm import GN_BWD_ENTRY
from emcid_torch.ops.layernorm import LN_BWD_ENTRY
from emcid_torch.ops.solve import solve_adj_k, upd_matrix_match_shape


def _qkv(seed, B, N, M, H, D):
    r = np.random.RandomState(seed)
    return (r.randn(B, N, H, D).astype(np.float32),
            r.randn(B, M, H, D).astype(np.float32),
            r.randn(B, M, H, D).astype(np.float32))


def _t(*xs, grad=False):
    return [torch.from_numpy(x.copy()).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("shape", [
    (2, 64, 64, 2, 40),      # short path (einsum softmax)
    (1, 2048, 2048, 1, 16),  # long: chunked scan on the CPU
    (1, 1024, 77, 2, 40),    # long queries, 77-token context
])
def test_attention_cpu_matches_jax(shape):
    B, N, M, H, D = shape
    q, k, v = _qkv(0, B, N, M, H, D)
    ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), D ** -0.5))
    got = attention(*_t(q, k, v), scale=D ** -0.5).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_mha_chunked_unaligned_matches_jax():
    q, k, v = _qkv(1, 2, 200, 200, 2, 40)
    from emcid_tpu.ops.attention import mha_chunked as jax_chunked

    ref = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), 40 ** -0.5, block_q=64))
    got = mha_chunked(*_t(q, k, v), 40 ** -0.5, block_q=64).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("shape", [
    (2, 512, 512, 2, 40),   # SD level-0 head dim
    (1, 256, 256, 2, 80),
    (2, 300, 300, 1, 40),   # N not a block multiple
    (1, 512, 77, 2, 40),    # padded + masked key block
    (1, 256, 256, 1, 512),  # the VAE's single 512-wide head (d512 route)
])
def test_flash_v2_plain_forward_matches_jax(shape):
    """K1's plain version against the Pallas kernel in interpret mode."""
    B, N, M, H, D = shape
    q, k, v = _qkv(2, B, N, M, H, D)
    ref = np.asarray(jax_flash_v2(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), D ** -0.5, True))
    got = flash_attention_v2(*_t(q, k, v), D ** -0.5).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape", [
    (1, 384, 384, 2, 40),
    (1, 256, 77, 2, 40),
])
def test_flash_v2_plain_grads_match_jax(shape):
    """K2/K3's plain versions (through the autograd.Function) against the
    Pallas backward kernels in interpret mode."""
    B, N, M, H, D = shape
    q, k, v = _qkv(3, B, N, M, H, D)
    w = np.random.RandomState(4).randn(B, N, H, D).astype(np.float32)
    f = lambda q, k, v: jnp.sum(
        jax_flash_v2(q, k, v, D ** -0.5, True) * jnp.asarray(w))
    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = _t(q, k, v, grad=True)
    (flash_attention_v2(qt, kt, vt, D ** -0.5) * torch.from_numpy(w)).sum(
    ).backward()
    for a, b, name in zip(ref, (qt.grad, kt.grad, vt.grad), "qkv"):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=5e-4,
                                   atol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("shape", [
    (1, 256, 256, 2, 40),
    (1, 256, 77, 2, 40),   # the cross-attention shape
])
def test_short_kv_plain_matches_jax_kernel(shape):
    """K4's plain version against ``_flash_forward`` in interpret mode."""
    B, N, M, H, D = shape
    q, k, v = _qkv(5, B, N, M, H, D)
    ref = np.asarray(_flash_forward(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), D ** -0.5, block_q=128,
                                    interpret=True))
    got = short_kv_fwd(*_t(q, k, v), D ** -0.5).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)


# bf16 inputs on both sides (the same rounded values): the Pallas kernels
# round P to bf16 before P.V where the plain versions keep it in f32, and
# both round the output to bf16 (2^-9 relative), so they agree to about 1%
# of the largest output value; 2e-2 of it is the bound.  The scores and the
# lse are f32 products of the same bf16 values in both.
BF16_TOL = 2e-2
# The backward (K2/K3) on the same bf16 inputs, lse and O: the Pallas
# kernels also round dS = P * (dP - delta) to bf16 before dS.K and dS^T.Q
# (2^-9 relative per term, in sums over every key or query of random
# sign); the gradients agree to under 1% of the largest value, and the
# bound is again 2e-2 of it.
BF16_BWD_TOL = 2e-2


def _bf16(*xs):
    """The same bf16 values as a jax and a torch array, for each input."""
    out = []
    for x in xs:
        t = torch.from_numpy(x).to(torch.bfloat16)
        out.append((jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t))
    return out


def _bwd_bf16_vs_pallas(kernel, B, N, H, D, qj, kj, vj, qt, kt, vt):
    """K2's or K3's plain version against the Pallas backward in interpret
    mode, both on the same bf16 inputs and cotangent and on K1's lse and O
    (the Pallas forward's, as the JAX backward reads them)."""
    s = D ** -0.5
    (gj, gt), = _bf16(np.random.RandomState(10).randn(B, N, H, D)
                      .astype(np.float32))
    o_j, lse_j = jax_flash_v2_fwd(qj, kj, vj, s, interpret=True)
    refs = jax_flash_v2_bwd((qj, kj, vj, lse_j, o_j), gj, s, interpret=True)
    lse = torch.from_numpy(np.asarray(lse_j)[:, 0, :N].reshape(B, H, N).copy())
    o = torch.from_numpy(np.array(o_j.astype(jnp.float32))).to(torch.bfloat16)
    delta = row_delta(o, gt)
    if kernel == "K2":
        pairs = [(flash_dq_plain(qt, kt, vt, gt, lse, delta, s), refs[0])]
    else:
        dk, dv = flash_dkv_plain(qt, kt, vt, gt, lse, delta, s)
        pairs = [(dk, refs[1]), (dv, refs[2])]
    for got, ref in pairs:
        assert got.dtype == torch.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= BF16_BWD_TOL * np.abs(ref).max()


@pytest.mark.parametrize("kernel,shape", [
    ("K1", (1, 256, 256, 2, 40)),   # the mma route's head dim
    ("K1", (2, 300, 300, 1, 40)),   # ragged N and M
    ("K4", (1, 256, 77, 2, 40)),    # the cross-attention shape
    ("K4", (1, 300, 200, 2, 40)),   # M past one 80-key chunk
    ("K2", (1, 256, 256, 2, 40)),   # the mma route's head dims
    ("K2", (2, 300, 300, 1, 40)),   # ragged N and M
    ("K2", (1, 256, 256, 1, 80)),
    ("K3", (1, 256, 256, 2, 40)),
    ("K3", (2, 300, 300, 1, 40)),
    ("K3", (1, 256, 256, 1, 80)),
])
def test_plain_bf16_matches_pallas(kernel, shape):
    """K1-K4's plain versions on bf16 inputs against the Pallas kernels in
    interpret mode on the same bf16 inputs."""
    B, N, M, H, D = shape
    (qj, qt), (kj, kt), (vj, vt) = _bf16(*_qkv(9, B, N, M, H, D))
    if kernel in ("K2", "K3"):
        _bwd_bf16_vs_pallas(kernel, B, N, H, D, qj, kj, vj, qt, kt, vt)
        return
    if kernel == "K1":
        ref, lse_ref = jax_flash_v2_fwd(qj, kj, vj, D ** -0.5, interpret=True)
        got, lse = flash_fwd(qt, kt, vt, D ** -0.5)
        lse_ref = np.asarray(lse_ref)[:, 0, :N].reshape(B, H, N)
        np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-4)
    else:
        ref = _flash_forward(qj, kj, vj, D ** -0.5, block_q=128,
                             interpret=True)
        got = short_kv_fwd(qt, kt, vt, D ** -0.5)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= BF16_TOL * np.abs(ref).max()


def _route_inputs(dtype, D, misaligned=False):
    n = 1 * 8 * 2 * D
    base = torch.zeros(n + 1, dtype=dtype)
    q = (base[1:] if misaligned else base[:n]).view(1, 8, 2, D)
    k, v = torch.zeros(1, 8, 2, D, dtype=dtype), torch.zeros(1, 8, 2, D,
                                                             dtype=dtype)
    return q, k, v, torch.empty_like(k)


@pytest.mark.parametrize("kernel,dtype,D,misaligned,route", [
    ("K1", torch.bfloat16, 40, False, "mma"),
    ("K1", torch.bfloat16, 80, False, "mma"),
    ("K1", torch.bfloat16, 512, False, "d512"),
    ("K1", torch.float32, 40, False, "fma"),
    ("K1", torch.bfloat16, 16, False, "fma"),
    ("K1", torch.bfloat16, 40, True, "fma"),   # not 16-byte aligned
    ("K4", torch.bfloat16, 40, False, "mma"),
    ("K4", torch.bfloat16, 80, False, "mma"),
    ("K4", torch.float32, 40, False, "fma"),
    ("K4", torch.bfloat16, 512, False, "fma"),
] + [(kernel, dtype, D, misaligned, route)
     for kernel in ("K2", "K3")
     for dtype, D, misaligned, route in (
         (torch.bfloat16, 40, False, "mma"),
         (torch.bfloat16, 80, False, "mma"),
         (torch.float32, 40, False, "fma"),
         (torch.bfloat16, 16, False, "fma"),
         (torch.bfloat16, 512, False, "fma"),
         (torch.bfloat16, 40, True, "fma"))])   # not 16-byte aligned
def test_kernel_routes(kernel, dtype, D, misaligned, route):
    """The route K1 (``fwd_route``), K2/K3 (``bwd_route``, on the inputs and
    the kernel's outputs) and K4 (``short_kv_route``) take: the tensor-core
    routes for bf16 at the UNet's head dims (and the VAE's 512-wide head for
    K1), the float-FMA kernels for the rest."""
    q, k, v, o = _route_inputs(dtype, D, misaligned)
    if kernel == "K1":
        got = fwd_route(q, k, v, o)
    elif kernel == "K2":
        got = bwd_route(q, k, v, o, torch.empty_like(q))
    elif kernel == "K3":
        got = bwd_route(q, k, v, o, torch.empty_like(k), torch.empty_like(v))
    else:
        got = short_kv_route(q, k, v, o)
    assert got == route


def test_reset_launches_clears_routes():
    _build.ROUTES["K1 flash_v2_fwd"]["mma"] = 3
    _build.ROUTES["K2 flash_v2_dq"]["mma"] = 2
    _build.ROUTES["K3 flash_v2_dkv"]["fma"] = 4
    _build.ROUTES["K4 short_kv_fwd"]["fma"] = 1
    _build.reset_launches()
    assert all(n == 0 for r in _build.ROUTES.values() for n in r.values())
    assert set(_build.ROUTES["K1 flash_v2_fwd"]) == {"mma", "d512", "fma"}
    assert set(_build.ROUTES["K2 flash_v2_dq"]) == {"mma", "fma"}
    assert set(_build.ROUTES["K3 flash_v2_dkv"]) == {"mma", "fma"}
    assert set(_build.ROUTES["K4 short_kv_fwd"]) == {"mma", "fma"}


@pytest.mark.parametrize("kernel,entries", [
    ("K1 flash_v2_fwd", fv2.FWD_ENTRY),
    ("K2 flash_v2_dq", fv2.DQ_ENTRY),
    ("K3 flash_v2_dkv", fv2.DKV_ENTRY),
    ("K4 short_kv_fwd", SHORT_KV_ENTRY),
    ("K5b groupnorm_bwd", GN_BWD_ENTRY),
    ("K6b layernorm_bwd", LN_BWD_ENTRY),
])
def test_route_entry_points_are_bound(kernel, entries):
    """Every route a wrapper can pick is counted in ``ROUTES`` and names a C
    entry point that ``_build`` binds, with the same signature as the
    kernel's other routes."""
    assert set(entries) == set(_build.ROUTES[kernel])
    sigs = [_build._SIGNATURES[name] for name in entries.values()]
    assert all(sig == sigs[0] for sig in sigs)


def test_short_kv_backward_is_chunked_recompute():
    """K4's backward (the chunked recompute) against the VJP of the JAX
    package's ``mha_chunked``, which is what its ``flash_attention``
    backward runs."""
    from emcid_tpu.ops.attention import mha_chunked as jax_chunked

    q, k, v = _qkv(6, 1, 256, 77, 2, 40)
    g = lambda q, k, v: jnp.sum(jax_chunked(q, k, v, 40 ** -0.5) ** 2)
    ref = jax.grad(g, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = _t(q, k, v, grad=True)
    (flash_attention(qt, kt, vt, 40 ** -0.5) ** 2).sum().backward()
    for a, b in zip(ref, (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=5e-4,
                                   atol=5e-5)


def test_cpu_wrappers_launch_nothing():
    _build.reset_launches()
    q, k, v = _t(*_qkv(7, 1, 1024, 1024, 1, 16))
    flash_attention_v2(q, k, v).sum()
    short_kv_fwd(q[:, :, :, :], k[:, :77], v[:, :77], 0.25)
    assert all(n == 0 for n in _build.LAUNCHES.values())


@pytest.mark.parametrize("method,tol", [("f32_ir", 1e-4), ("f64", 1e-10)])
def test_solve_adj_k_matches_jax(method, tol):
    r = np.random.RandomState(8)
    A = r.randn(300, 64).astype(np.float32)
    C = (A.T @ A / 300).astype(np.float32)
    K = r.randn(64, 5).astype(np.float32)
    ref = np.asarray(jax_solve(C, K, 40.0, method=method))
    got = solve_adj_k(torch.from_numpy(C), torch.from_numpy(K), 40.0,
                      method=method)
    got = got.numpy() if torch.is_tensor(got) else got
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_solve_f32_ir_reaches_f64_on_an_ill_conditioned_system():
    """At cond(A) ~8e5 (a covariance over a small caption corpus is worse:
    ~1e8), refinement on f32 residuals stalls at 4e-3 of the float64
    solve; on float64 residuals it reaches it within 1e-5."""
    r = np.random.RandomState(0)
    q, _ = np.linalg.qr(r.randn(128, 128))
    C = ((q * np.logspace(-3, 3, 128)) @ q.T).astype(np.float32)
    K = r.randn(128, 4).astype(np.float32)
    ref = solve_adj_k(C, K, 1.0, method="f64")  # the same f32 inputs
    got = solve_adj_k(torch.from_numpy(C), torch.from_numpy(K), 1.0,
                      method="f32_ir")
    assert got.dtype == torch.float32
    assert np.linalg.norm(got.double().numpy() - ref) <= \
        1e-5 * np.linalg.norm(ref)


def test_solve_f32_ir_raises_when_the_refinement_diverges():
    """At cond(A) 1e8 and 512 wide the f32 factor is too poor for the
    refinement to contract: the solve raises with the ratio reached
    instead of returning an unconverged x."""
    r = np.random.RandomState(0)
    q, _ = np.linalg.qr(r.randn(512, 512))
    C = ((q * np.logspace(-4, 4, 512)) @ q.T).astype(np.float32)
    K = r.randn(512, 4).astype(np.float32)
    with pytest.raises(FloatingPointError, match="did not converge"):
        solve_adj_k(torch.from_numpy(C), torch.from_numpy(K), 1.0,
                    method="f32_ir")


def test_upd_matrix_match_shape():
    m = torch.zeros(3, 5)
    assert tuple(upd_matrix_match_shape(m, (5, 3)).shape) == (5, 3)
    assert tuple(upd_matrix_match_shape(m, (3, 5)).shape) == (3, 5)
    with pytest.raises(ValueError):
        upd_matrix_match_shape(m, (4, 4))
