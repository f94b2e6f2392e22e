"""Parity of the port's ADMM building blocks and fused-segment kernels
with the JAX package.

Each kernel form's plain twin (``admm_segment_ref`` /
``admm_segment_factored_ref``) is held against the JAX Pallas kernel
under ``jax.vmap`` in interpret mode, as tests/test_pallas_kernel.py
runs it, on inputs the port's own pipeline builds (the operator and
state of a second segment, so the state is not the zero start).

Tolerances: float64 agrees to rounding carried through the segment's
iterations (atol 1e-9 on the kernels, 1e-10 on single steps). Single
float32 steps agree to 1e-5 relative (f32 rounding is ~6e-8 per
operation); float32 segments are held against a float64 evaluation
(see assert_segment_close), because 25-35 iterations near a clip or
prox kink can carry a last-bit difference well past a fixed ulp
budget.
The CUDA kernels themselves run only on a card
(tests/test_torch_cuda.py and ``chip_smoke.py``).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from porqua_tpu.ops import admm_kernel as jk
from porqua_tpu.qp import admm as jadmm
from porqua_tpu.qp.admm import SolverParams as JaxParams
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.ruiz import Scaling as JaxScaling

from porqua_tpu_torch.ops import admm_kernel as tk
from porqua_tpu_torch.qp import admm as tadmm
from porqua_tpu_torch.qp.admm import SolverParams
from porqua_tpu_torch.qp.solve import _prepare_impl
from porqua_tpu_torch.tracking import build_tracking_qp, synthetic_universe_np

from tests.test_torch_cuda import FORMS, SCALE_OF, f32_floor, kernel_inputs

STEP_TOL = {np.float64: dict(atol=1e-10, rtol=0),
            np.float32: dict(atol=1e-6, rtol=1e-5)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


@pytest.mark.parametrize("n", [40, 300])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_blocked_triangular_inverse(rng, n, dtype):
    """n=300 crosses the 192 threshold: one recursion level with an
    odd split padded by a unit diagonal."""
    A = rng.standard_normal((2, n, n))
    L = np.linalg.cholesky(A @ A.transpose(0, 2, 1) / n + np.eye(n))
    L = L.astype(dtype)
    ref = jax.vmap(jadmm.blocked_triangular_inverse)(jnp.asarray(L))
    port = tadmm.blocked_triangular_inverse(torch.as_tensor(L))
    close(port, ref, STEP_TOL[dtype])


@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_factored_solve(rng, refine, dtype):
    B, k, n = 3, 7, 12
    Dv = (0.5 + rng.random((B, n))).astype(dtype)
    V = rng.standard_normal((B, k, n)).astype(dtype)
    r = rng.standard_normal((B, n)).astype(dtype)
    ref_d, ref_W = jax.vmap(jadmm.factored_solve_pieces)(
        jnp.asarray(Dv), jnp.asarray(V))
    inv_d, W = tadmm.factored_solve_pieces(torch.as_tensor(Dv),
                                           torch.as_tensor(V))
    tol = STEP_TOL[dtype]
    close(inv_d, ref_d, tol)
    close(W, ref_W, tol)
    ref_x = jax.vmap(lambda d, v, i, w, rr: jadmm.factored_solve_from_pieces(
        d, v, i, w, refine)(rr))(jnp.asarray(Dv), jnp.asarray(V), ref_d,
                                 ref_W, jnp.asarray(r))
    x = tadmm.factored_solve_from_pieces(
        torch.as_tensor(Dv), torch.as_tensor(V), inv_d, W, refine)(
            torch.as_tensor(r))
    close(x, ref_x, dict(tol, atol=tol["atol"] * 10))


def scaled_tracking(dtype, B=3, T=30, N=12, seed=5):
    Xs, ys = synthetic_universe_np(seed, B, T, N)
    qp = build_tracking_qp(torch.as_tensor(Xs.astype(dtype)),
                           torch.as_tensor(ys.astype(dtype)))
    scaled, scaling = _prepare_impl(qp, SolverParams(scaling_iters=2))[:2]
    return scaled, scaling


def to_jax(nt, cls):
    return cls(*(None if a is None else jnp.asarray(a.numpy()) for a in nt))


@pytest.mark.parametrize("l1", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_residuals_and_infeasibility(rng, dtype, l1):
    scaled, scaling = scaled_tracking(dtype)
    B, n, m = scaled.q.shape[0], scaled.n, scaled.m
    draw = lambda *s: torch.as_tensor(
        (1e-2 * rng.standard_normal((B,) + s)).astype(dtype))
    x, z, w, y, mu = draw(n), draw(m), draw(n), draw(m), draw(n)
    dx, dy, dmu = draw(n), draw(m), draw(n)
    l1w = torch.as_tensor(np.abs(rng.standard_normal((B, n))).astype(dtype)) \
        if l1 else None
    params = SolverParams(eps_pinf=1e-4, eps_dinf=1e-4)
    jparams = JaxParams(eps_pinf=1e-4, eps_dinf=1e-4)
    jqp, jsc = to_jax(scaled, JaxQP), to_jax(scaling, JaxScaling)
    j = lambda t: jnp.asarray(t.numpy())

    ref = jax.vmap(lambda q, s, *v: jadmm._residuals(q, s, *v, jparams))(
        jqp, jsc, j(x), j(z), j(w), j(y), j(mu))
    port = tadmm._residuals(scaled, scaling, x, z, w, y, mu, params)
    for a, b in zip(port, ref):
        close(a, b, STEP_TOL[dtype])

    ref = jax.vmap(lambda q, s, a, b, c, lw: jadmm._infeasibility(
        q, s, a, b, c, jparams, l1w=lw), in_axes=(0, 0, 0, 0, 0,
                                                  0 if l1 else None))(
        jqp, jsc, j(dx), j(dy), j(dmu), j(l1w) if l1 else None)
    port = tadmm._infeasibility(scaled, scaling, dx, dy, dmu, params, l1w=l1w)
    for a, b in zip(port[:2], ref[:2]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the fused segment: plain twins against the Pallas kernel -------------

def pallas(fn, args, kw):
    """The JAX Pallas kernel in interpret mode, vmapped over the batch."""
    if fn is tk.admm_segment_factored:
        jfn = functools.partial(jk.admm_segment_factored, interpret=True,
                                **kw)
    else:
        jfn = functools.partial(jk.admm_segment, interpret=True, **kw)
    return jax.vmap(jfn)(*(jnp.asarray(a.numpy()) for a in args))


def assert_segment_close(port, ref, kw, exact=None):
    """float64: agreement to 1e-9. float32: neither side is "the"
    answer, so both are held against ``exact`` (the Pallas kernel run
    in float64 on the same inputs): per output, the port's distance to
    it is at most 4x the Pallas kernel's own, plus two f32 ulps of the
    output's scale (the state vector it belongs to) per iteration.
    chip_smoke.py holds the CUDA kernel to its twin by the same rule."""
    for i, (a, b) in enumerate(zip(port, ref)):
        a, b = np.asarray(a), np.asarray(b)
        if exact is None:
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
            continue
        e = np.asarray(exact[i])
        scale = np.abs(np.asarray(exact[SCALE_OF[i]])).max()
        e_port = np.abs(a.astype(np.float64) - e).max()
        e_ref = np.abs(b.astype(np.float64) - e).max()
        assert e_port <= 4.0 * e_ref + f32_floor(kw) * scale, (
            i, e_port, e_ref)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_twin_matches_pallas_interpret(form, dtype):
    fn, args, kw = kernel_inputs(form, dtype)
    ref = pallas(fn, args, kw)
    twin = {tk.admm_segment: tk.admm_segment_ref,
            tk.admm_segment_factored: tk.admm_segment_factored_ref}[fn]
    port = twin(*args, **kw)
    exact = None
    if dtype == np.float32:
        exact = pallas(fn, tuple(a.double() for a in args), kw)
    assert_segment_close(port, ref, kw, exact)


@pytest.mark.parametrize("refine", [0, 2])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [5, 37])
def test_factored_twin_matches_pallas_at_cluster_test_shapes(n, m, refine):
    """The factored twin, which the cluster kernel is held against on the
    card, at the shapes of that test (few columns per rank, extra
    constraint rows, two refinement rounds): float64, 1e-9."""
    fn, args, kw = kernel_inputs("factored_refine0", np.float64, n=n, m=m,
                                 refine=refine)
    port = tk.admm_segment_factored_ref(*args, **kw)
    assert_segment_close(port, pallas(fn, args, kw), kw)


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [5, 13, 37])
@pytest.mark.parametrize("form", ["triangular", "inverse"])
def test_dense_twin_matches_pallas_at_cluster_test_shapes(form, n, m):
    """The dense twin, which the dense cluster kernels are held against
    on the card, at the shapes of that test (ranks without a column,
    ragged last ranks, extra constraint rows): float64, 1e-9."""
    fn, args, kw = kernel_inputs(form, np.float64, n=n, m=m)
    port = tk.admm_segment_ref(*args, **kw)
    assert_segment_close(port, pallas(fn, args, kw), kw)


def test_cpu_wrapper_runs_the_twin_and_counts_nothing():
    fn, args, kw = kernel_inputs("triangular", np.float64)
    before = fn.launches
    out = fn(*args, **kw)
    ref = tk.admm_segment_ref(*args, **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert fn.launches == before


def test_wrapper_rejects_bad_inputs():
    fn, args, kw = kernel_inputs("inverse", np.float64)
    bad = list(args)
    bad[0] = args[0].transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        fn(*bad, **kw)
    bad[0] = args[0][:, :-1, :-1].contiguous()
    with pytest.raises(ValueError, match="shape"):
        fn(*bad, **kw)
    bad[0] = args[0].float()
    with pytest.raises(ValueError, match="dtype"):
        fn(*bad, **kw)
    with pytest.raises(ValueError, match="n_iters"):
        fn(*args, **dict(kw, n_iters=0))


@pytest.mark.parametrize("dtype, linsolve, want", [
    (torch.float32, "auto", "trinv"),
    (torch.float64, "auto", "chol"),
    (torch.float64, "inverse", "inverse"),
    (torch.float32, "woodbury", "woodbury"),
])
def test_resolve_linsolve(dtype, linsolve, want):
    scaled, _ = scaled_tracking(np.float64)
    qp = scaled._replace(P=scaled.P.to(dtype))
    assert tadmm.resolve_linsolve(SolverParams(linsolve=linsolve), qp) == want


def test_woodbury_needs_factor():
    scaled, _ = scaled_tracking(np.float64)
    with pytest.raises(ValueError, match="requires the factored"):
        tadmm.resolve_linsolve(SolverParams(linsolve="woodbury"),
                               scaled._replace(Pf=None))


def test_segment_plan_f32_clamp_and_halpern():
    scaled, _ = scaled_tracking(np.float32)
    plan = tadmm._segment_plan(scaled, SolverParams(backend="pallas"))
    assert plan.use_pallas and (plan.rho_lo, plan.rho_hi) == (1e-3, 1e2)
    with pytest.raises(NotImplementedError, match="Halpern"):
        tadmm._segment_plan(
            scaled, SolverParams(backend="pallas", halpern=True), warn=True)
    plan = tadmm._segment_plan(scaled._replace(P=scaled.P.double()),
                               SolverParams(linsolve="chol"))
    assert (plan.rho_lo, plan.rho_hi) == (1e-6, 1e6)


def test_halpern_xla_matches_jax_pallas_halpern():
    """The intended divergence: with backend="pallas", halpern=True the
    JAX package warns and runs its XLA Halpern segment, the port raises
    (above). The port's backend="xla", halpern=True runs that segment:
    same status and iterations per lane on the same small f32 batch,
    weights by the f32 tracking rule (5e-5)."""
    import warnings

    import porqua_tpu_torch as pt
    from porqua_tpu.tracking import tracking_step as jax_tracking_step

    Xs, ys = synthetic_universe_np(3, 3, 30, 12)
    opts = dict(max_iter=2000, eps_abs=1e-4, eps_rel=1e-4, polish=False,
                scaling_iters=2, check_interval=4, halpern=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = jax_tracking_step(jnp.asarray(Xs), jnp.asarray(ys),
                                JaxParams(backend="pallas", **opts))
    assert any("Halpern" in str(w.message) for w in caught)
    port = pt.tracking_step(Xs, ys, SolverParams(backend="xla", **opts),
                            device="cpu")
    np.testing.assert_array_equal(port.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(port.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(port.weights.numpy(), np.asarray(ref.weights),
                               atol=5e-5, rtol=0)
