"""The port's differentiable solve (``porqua_tpu_torch/qp/diff.py``)
against the JAX package's (``porqua_tpu/qp/diff.py``, XLA-CPU) on the
same seeded numpy inputs and against central finite differences of the
port's own solve, and the committed JAX golden of ``chip_smoke.py``'s
phase 9.

Tolerances: in float64 at eps 1e-11 the port's gradient equals
``jax.grad``'s to GRAD_RTOL (1e-6) relative to the field's largest
cotangent, and a directional derivative of the port's own solve
(central differences, step 1e-6) to FD_RTOL relative plus FD_ATOL.
Each JAX reference is computed once per module (each is a JAX compile),
and torch runs on one thread.

Regenerate the golden (XLA-CPU; the f64 runs of the 252 x 500 batch
dominate):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_diff.py --write-golden
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from porqua_tpu.accounting import simulate as jax_simulate
from porqua_tpu.compare import compare_solvers as jax_compare_solvers
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.diff import active_sets as jax_active_sets
from porqua_tpu.qp.diff import solve_qp_diff as jax_solve_qp_diff
from porqua_tpu.qp.diff import solve_qp_l1_diff as jax_solve_qp_l1_diff
from porqua_tpu.qp.solve import SolverParams as JaxParams
from porqua_tpu.qp.solve import solve_qp as jax_solve_qp
from porqua_tpu.tracking import build_tracking_qp as jax_build_tracking_qp
from porqua_tpu.tracking import synthetic_universe_np as jax_universe

import porqua_tpu_torch as pt
from chip_smoke import chain_market, net_sharpe
from porqua_tpu_torch.accounting import simulate
from porqua_tpu_torch.qp import diff
from porqua_tpu_torch.qp.canonical import CanonicalQP
from porqua_tpu_torch.qp.polish import polish_capacitance_dim

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_ROOT, "porqua_tpu_torch", "testdata",
                      "diff_golden.npz")

PARAMS64 = dict(max_iter=50000, eps_abs=1e-11, eps_rel=1e-11)
FIELDS = ("P", "q", "C", "l", "u", "lb", "ub")
GRAD_RTOL = 1e-6
FD_H, FD_RTOL, FD_ATOL = 1e-6, 1e-4, 1e-7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems, several test workers on one machine: one
    intra-op thread avoids the contention that slows loops of small
    ops by about 10x (tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tparams(**over):
    return pt.SolverParams(**{**PARAMS64, **over})


def jparams(**over):
    return JaxParams(**{**PARAMS64, **over})


def port_qp(parts, requires_grad=()):
    """A CanonicalQP of float64 CPU tensors (no padding, no batch axis)
    from numpy parts; the named fields are leaves that need a gradient."""
    n, m = parts["P"].shape[0], parts["C"].shape[0]
    t = lambda k, v: torch.tensor(np.asarray(v, np.float64),
                                  requires_grad=k in requires_grad)
    return CanonicalQP(
        **{k: t(k, parts[k]) for k in FIELDS},
        var_mask=torch.ones(n, dtype=torch.float64),
        row_mask=torch.ones(m, dtype=torch.float64),
        constant=torch.tensor(float(parts.get("constant", 0.0)),
                              dtype=torch.float64),
        Pf=None if "Pf" not in parts else t("Pf", parts["Pf"]),
        Pdiag=None if "Pdiag" not in parts else t("Pdiag", parts["Pdiag"]))


def jax_qp(parts):
    n, m = parts["P"].shape[0], parts["C"].shape[0]
    a = lambda v: jnp.asarray(np.asarray(v, np.float64))
    return JaxQP(
        **{k: a(parts[k]) for k in FIELDS},
        var_mask=jnp.ones(n), row_mask=jnp.ones(m),
        constant=jnp.asarray(float(parts.get("constant", 0.0))),
        Pf=None if "Pf" not in parts else a(parts["Pf"]),
        Pdiag=None if "Pdiag" not in parts else a(parts["Pdiag"]))


def rel_err(a, b):
    """max |a - b| over the largest |b| (0 when both are 0)."""
    scale = float(np.abs(b).max()) if np.size(b) else 0.0
    err = float(np.abs(np.asarray(a) - np.asarray(b)).max()) if np.size(b) else 0.0
    return err / scale if scale > 0 else err


def tracking_parts(rng, n, T, ub=1.0, ridge2=0.01):
    X = rng.standard_normal((T, n)) * 0.1
    w = rng.dirichlet(np.ones(n))
    y = X @ w
    return dict(P=2.0 * X.T @ X + ridge2 * np.eye(n), q=-2.0 * X.T @ y,
                C=np.ones((1, n)), l=np.ones(1), u=np.ones(1),
                lb=np.zeros(n), ub=np.full(n, ub), constant=float(y @ y))


# ---------------------------------------------------------------------------
# every CanonicalQP field, on the dense and on the factored adjoint
# ---------------------------------------------------------------------------

def mixed_parts(n, T, ub, factored, seed=1):
    """A tracking QP with a mixed active set: the budget equality, a
    sector cap held at its upper bound, a sector floor held at its lower
    bound, coordinates at lb and at ub. The cap and floor come from the
    budget-and-box solution; ``factored`` adds the objective factor
    (``Pf = X``, k + m < n runs the factored adjoint)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((T, n)) * 0.1
    w = rng.dirichlet(np.ones(n) * 0.5)
    w[[1, 6]] = 0.0
    w /= w.sum()
    y = X @ w + 0.01 * rng.standard_normal(T)
    parts = dict(P=2.0 * X.T @ X + 0.01 * np.eye(n), q=-2.0 * X.T @ y,
                 C=np.ones((1, n)), l=np.ones(1), u=np.ones(1),
                 lb=np.zeros(n), ub=np.full(n, ub), constant=float(y @ y))
    x0 = pt.solve_qp(port_qp(parts), tparams(), device="cpu").x.numpy()
    parts["C"] = np.stack([np.ones(n), np.r_[np.ones(3), np.zeros(n - 3)],
                           np.r_[np.zeros(n - 3), np.ones(3)]])
    parts["l"] = np.array([1.0, -np.inf, 1.2 * x0[-3:].sum() + 0.02])
    parts["u"] = np.array([1.0, 0.8 * x0[:3].sum(), np.inf])
    if factored:
        parts.update(Pf=X, Pdiag=np.full(n, 0.01))
    return parts


def fd_direction(parts, field, rng):
    """A direction for ``field`` (finite entries only; P symmetric) and
    the moves it makes, as {field: delta}. The equality row moves its l
    and u together (l == u must hold), under field "l"."""
    v = rng.standard_normal(parts[field].shape)
    if field == "P":
        v = 0.5 * (v + v.T)
    v = np.where(np.isfinite(parts[field]), v, 0.0)
    eq = parts["u"] - parts["l"] <= 1e-9
    if field == "u":
        v = np.where(eq, 0.0, v)
    moves = {field: v}
    if field == "l":
        moves["u"] = np.where(eq, v, 0.0)
    return moves


@pytest.fixture(scope="module", params=["dense", "factored"])
def adjoint_case(request):
    factored = request.param == "factored"
    parts = (mixed_parts(24, 12, 0.15, True) if factored
             else mixed_parts(10, 24, 0.3, False))
    cvec = np.random.default_rng(3).standard_normal(parts["q"].shape[0])
    g_jax = jax.grad(lambda qp: jnp.dot(jnp.asarray(cvec), jax_solve_qp_diff(
        qp, jparams())))(jax_qp(parts))
    qp = port_qp(parts, FIELDS)
    x = pt.solve_qp_diff(qp, tparams(), device="cpu")
    (torch.as_tensor(cvec) @ x).backward()
    return dict(parts=parts, cvec=cvec, factored=factored, x=x.detach().numpy(),
                jax={f: np.asarray(getattr(g_jax, f)) for f in FIELDS},
                port={f: getattr(qp, f).grad.numpy() for f in FIELDS})


def test_grads_every_field_match_jax_and_finite_differences(adjoint_case):
    """Each differentiable field's gradient on a mixed active set equals
    jax.grad's to GRAD_RTOL and a directional derivative of the port's
    own solve to FD_RTOL; the dense and the factored adjoint (the
    factored one where k + m < n, as the reference dispatches)."""
    d = adjoint_case
    parts, cvec, x = d["parts"], d["cvec"], d["x"]
    qp = port_qp(parts)
    assert (polish_capacitance_dim(qp) is not None) == d["factored"]
    n = parts["q"].shape[0]
    ub = parts["ub"][0]
    # The set is mixed: both sides of the box and of the rows bind.
    assert 0 < int((x < 1e-9).sum()) < n and int((x > ub - 1e-9).sum()) > 0
    for f in FIELDS:
        assert float(np.abs(d["port"][f]).max()) > 0.0, f
        assert rel_err(d["port"][f], d["jax"][f]) <= GRAD_RTOL, f

    loss = lambda p: float(cvec @ pt.solve_qp(port_qp(p), tparams(),
                                              device="cpu").x.numpy())
    rng = np.random.default_rng(11)
    for f in FIELDS:
        moves = fd_direction(parts, f, rng)
        shift = lambda s: dict(parts, **{k: parts[k] + s * v
                                         for k, v in moves.items()})
        want = sum(float(np.sum(d["port"][k] * v)) for k, v in moves.items())
        if f == "P" and d["factored"]:
            # The factored solve reads P through its factor only: move
            # P by moving Pf, P = 2 Pf'Pf + diag(Pdiag), dP = 2(V'Pf + Pf'V).
            V, Pf = rng.standard_normal(parts["Pf"].shape), parts["Pf"]
            shift = lambda s: dict(parts, Pf=Pf + s * V, P=2.0 * (
                Pf + s * V).T @ (Pf + s * V) + np.diag(parts["Pdiag"]))
            want = float(np.sum(d["port"]["P"] * 2.0 * (V.T @ Pf + Pf.T @ V)))
        fd = (loss(shift(FD_H)) - loss(shift(-FD_H))) / (2 * FD_H)
        assert abs(fd - want) <= FD_RTOL * abs(want) + FD_ATOL, (f, fd, want)


def test_unsolved_lane_gets_zero_gradient(adjoint_case):
    """A batch of two: the mixed problem and the same problem made
    infeasible (box caps summing below the budget). The infeasible
    lane's cotangents are all zero; the solved lane's equal the
    one-problem gradients."""
    parts = adjoint_case["parts"]
    bad = dict(parts, ub=np.full_like(parts["ub"], 0.5 / len(parts["ub"])))
    qps = [port_qp(p) for p in (parts, bad)]
    batch = CanonicalQP(*(None if f[0] is None else
                          torch.stack(f).requires_grad_(k in FIELDS)
                          for k, f in zip(CanonicalQP._fields, zip(*qps))))
    prm = tparams(max_iter=2000)
    x = diff.solve_qp_batch_diff(batch, prm, device="cpu")
    sol = pt.solve_qp_batch(batch, prm, device="cpu")
    assert sol.status.tolist()[0] == 1 and sol.status.tolist()[1] != 1
    (torch.as_tensor(adjoint_case["cvec"]) * x).sum().backward()
    for f in FIELDS:
        g = getattr(batch, f).grad
        assert torch.equal(g[1], torch.zeros_like(g[1])), f
        assert rel_err(g[0].numpy(), adjoint_case["port"][f]) <= 1e-9, f


def test_failed_adjoint_lane_gets_zero_not_nan(adjoint_case, monkeypatch):
    """A lane whose adjoint factorization failed (NaN from the batched
    KKT solve) ends with zero cotangents, and the summed gradient stays
    finite; the other lane is untouched."""
    parts = adjoint_case["parts"]
    real = diff._adjoint_kkt_solve

    def nan_lane_1(*args):
        out = real(*args)
        return tuple(torch.cat([t[:1], torch.full_like(t[1:], float("nan"))])
                     for t in out)

    monkeypatch.setattr(diff, "_adjoint_kkt_solve", nan_lane_1)
    q = torch.tensor(np.stack([parts["q"]] * 2), requires_grad=True)
    one = port_qp(parts)
    batch = CanonicalQP(*(None if t is None else torch.stack([t, t])
                          for t in one))._replace(q=q)
    x = diff.solve_qp_batch_diff(batch, tparams(), device="cpu")
    (torch.as_tensor(adjoint_case["cvec"]) * x).sum().backward()
    assert torch.isfinite(q.grad).all()
    assert torch.equal(q.grad[1], torch.zeros_like(q.grad[1]))
    assert rel_err(q.grad[0].numpy(), adjoint_case["port"]["q"]) <= 1e-9


# ---------------------------------------------------------------------------
# the native-L1 vjp
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def l1_case():
    """The reference's TestL1Diff problem: kink-resters and movers at a
    mid-sized penalty (n = 10, T = 40, lambda 2e-3)."""
    rng = np.random.default_rng(31)
    n, T = 10, 40
    X = rng.standard_normal((T, n)) * 0.1
    y = X @ rng.dirichlet(np.ones(n))
    c_prev = rng.dirichlet(np.ones(n))
    lam = 2e-3
    cvec = rng.standard_normal(n)
    parts = dict(P=2.0 * X.T @ X + 0.01 * np.eye(n), q=-2.0 * X.T @ y,
                 C=np.ones((1, n)), l=np.ones(1), u=np.ones(1),
                 lb=np.zeros(n), ub=np.ones(n), constant=float(y @ y))
    g_jax = jax.grad(lambda qp, w, c: jnp.dot(
        jnp.asarray(cvec), jax_solve_qp_l1_diff(qp, w, c, jparams())),
        argnums=(0, 1, 2))(jax_qp(parts), jnp.full(n, lam),
                           jnp.asarray(c_prev))
    qp = port_qp(parts, FIELDS)
    w = torch.full((n,), lam, dtype=torch.float64, requires_grad=True)
    c = torch.tensor(c_prev, requires_grad=True)
    x = pt.solve_qp_l1_diff(qp, w, c, tparams(), device="cpu")
    (torch.as_tensor(cvec) @ x).backward()
    port = {f: getattr(qp, f).grad.numpy() for f in FIELDS}
    port.update(l1_weight=w.grad.numpy(), l1_center=c.grad.numpy())
    ref = {f: np.asarray(getattr(g_jax[0], f)) for f in FIELDS}
    ref.update(l1_weight=np.asarray(g_jax[1]), l1_center=np.asarray(g_jax[2]))
    return dict(parts=parts, lam=lam, c_prev=c_prev, cvec=cvec,
                x=x.detach().numpy(), port=port, jax=ref)


def l1_loss(parts, w, c, cvec):
    sol = pt.solve_qp(port_qp(parts), tparams(), l1_weight=torch.as_tensor(w),
                      l1_center=None if c is None else torch.as_tensor(c),
                      device="cpu")
    return float(cvec @ sol.x.numpy())


def test_l1_grads_match_jax(l1_case):
    """w_bar, c_bar and every CanonicalQP field's cotangent equal the
    JAX package's to GRAD_RTOL, at a point with both kink-resters and
    movers."""
    d = l1_case
    at_c = np.abs(d["x"] - d["c_prev"]) < 1e-9
    assert 0 < int(at_c.sum()) < len(at_c)
    for k in d["jax"]:
        assert rel_err(d["port"][k], d["jax"][k]) <= GRAD_RTOL, k
    assert float(np.abs(d["port"]["l1_weight"]).max()) > 0.0


def test_l1_weight_and_center_match_finite_differences(l1_case):
    """d/dlambda (all weights together) and d/dc on one kink-rester and
    one mover (zero locally) against central differences of the port's
    own solve (step 1e-7, rtol 1e-3 as the reference's test)."""
    d = l1_case
    parts, lam, c0, cvec = d["parts"], d["lam"], d["c_prev"], d["cvec"]
    n, h = len(c0), 1e-7
    fd = (l1_loss(parts, np.full(n, lam + h), c0, cvec)
          - l1_loss(parts, np.full(n, lam - h), c0, cvec)) / (2 * h)
    np.testing.assert_allclose(d["port"]["l1_weight"].sum(), fd, rtol=1e-3,
                               atol=1e-8)
    at_c = np.abs(d["x"] - c0) < 1e-9
    for i in (int(np.argmax(at_c)), int(np.argmax(~at_c))):
        cp, cm = c0.copy(), c0.copy()
        cp[i] += h
        cm[i] -= h
        fd = (l1_loss(parts, np.full(n, lam), cp, cvec)
              - l1_loss(parts, np.full(n, lam), cm, cvec)) / (2 * h)
        np.testing.assert_allclose(d["port"]["l1_center"][i], fd, rtol=1e-3,
                                   atol=1e-7)
    assert abs(d["port"]["l1_center"][int(np.argmax(~at_c))]) < 1e-7


def test_l1_center_on_box_bound_routes_cotangent_to_box():
    """The reference's corner: a previous holding of 0 for an asset
    whose weight stays 0, so the kink pin and lb coincide. The box
    cotangent wins: c_bar is 0 there and lb_bar carries the sensitivity,
    equal to the JAX package's and to a one-sided difference."""
    rng = np.random.default_rng(41)
    n, T = 8, 30
    X = rng.standard_normal((T, n)) * 0.1
    w_true = np.zeros(n)
    w_true[: n - 2] = rng.dirichlet(np.ones(n - 2))
    y = X @ w_true
    c_prev = np.concatenate([rng.dirichlet(np.ones(n - 2)), [0.0, 0.0]])
    lam = np.full(n, 5e-3)
    cvec = rng.standard_normal(n)
    parts = dict(P=2.0 * X.T @ X + 0.01 * np.eye(n), q=-2.0 * X.T @ y,
                 C=np.ones((1, n)), l=np.ones(1), u=np.ones(1),
                 lb=np.zeros(n), ub=np.ones(n), constant=float(y @ y))
    qp = port_qp(parts, ("lb",))
    c = torch.tensor(c_prev, requires_grad=True)
    x = pt.solve_qp_l1_diff(qp, torch.as_tensor(lam), c, tparams(),
                            device="cpu")
    (torch.as_tensor(cvec) @ x).backward()
    g_lb, g_c = qp.lb.grad.numpy(), c.grad.numpy()
    dead = np.where(x.detach().numpy() < 1e-9)[0]
    assert dead.size > 0
    i = int(dead[0])
    assert c_prev[i] == 0.0 and abs(g_c[i]) < 1e-10

    j_lb, j_c = jax.grad(lambda lb, cv: jnp.dot(jnp.asarray(cvec),
                         jax_solve_qp_l1_diff(jax_qp(parts)._replace(lb=lb),
                                              jnp.asarray(lam), cv,
                                              jparams())),
                         argnums=(0, 1))(jnp.zeros(n), jnp.asarray(c_prev))
    assert rel_err(g_lb, np.asarray(j_lb)) <= GRAD_RTOL
    assert rel_err(g_c, np.asarray(j_c)) <= GRAD_RTOL
    h = 1e-7
    lb_p = np.zeros(n)
    lb_p[i] = h
    up = l1_loss(dict(parts, lb=lb_p), lam, c_prev, cvec)
    base = l1_loss(parts, lam, c_prev, cvec)
    np.testing.assert_allclose(g_lb[i], (up - base) / h, rtol=1e-3, atol=1e-7)


def test_l1_weight_zero_and_none_center():
    """At lambda = 0 the weight's gradient is the one-sided limit
    -u sign(x - c), not zero, as the JAX package gives it; a None center
    is a zero center, with the same gradients as an explicit zero one
    and as the JAX package's None."""
    rng = np.random.default_rng(13)
    n, T = 8, 24
    parts = tracking_parts(rng, n, T)
    parts["lb"] = np.full(n, -1.0)
    cvec = rng.standard_normal(n)
    c_prev = rng.dirichlet(np.ones(n))

    def port_grad(lam, center):
        w = torch.full((n,), lam, dtype=torch.float64, requires_grad=True)
        c = None if center is None else torch.tensor(center)
        x = pt.solve_qp_l1_diff(port_qp(parts), w, c, tparams(), device="cpu")
        (torch.as_tensor(cvec) @ x).backward()
        return float(w.grad.sum())

    def jax_grad(lam, center):
        c = None if center is None else jnp.asarray(center)
        return float(jax.grad(lambda s: jnp.dot(jnp.asarray(cvec),
                              jax_solve_qp_l1_diff(jax_qp(parts),
                                                   jnp.full(n, s), c,
                                                   jparams())))(
            jnp.asarray(lam)))

    g0 = port_grad(0.0, c_prev)
    assert abs(g0) > 1e-3
    np.testing.assert_allclose(g0, jax_grad(0.0, c_prev), rtol=GRAD_RTOL)
    h = 1e-7
    fd_right = (l1_loss(parts, np.full(n, h), c_prev, cvec)
                - l1_loss(parts, np.zeros(n), c_prev, cvec)) / h
    np.testing.assert_allclose(g0, fd_right, rtol=1e-3)
    g_none = port_grad(1e-3, None)
    np.testing.assert_allclose(g_none, port_grad(1e-3, np.zeros(n)),
                               rtol=1e-10)
    np.testing.assert_allclose(g_none, jax_grad(1e-3, None), rtol=GRAD_RTOL)


# ---------------------------------------------------------------------------
# batches, precision, and the tuning examples' compositions
# ---------------------------------------------------------------------------

def test_batch_of_dates_equals_per_date_gradients():
    """Three tracking windows through the batched build and
    solve_qp_batch_diff, a per-date ridge and y carrying gradients:
    each date's gradients equal that date solved alone (1e-9)."""
    rng = np.random.default_rng(9)
    B, T, n = 3, 24, 8
    Xs = rng.standard_normal((B, T, n)) * 0.1
    ys = np.einsum("btn,n->bt", Xs, rng.dirichlet(np.ones(n)))
    cvec = torch.as_tensor(rng.standard_normal(n))

    def grads(idx):
        ridge = torch.full((len(idx),), 0.02, dtype=torch.float64,
                           requires_grad=True)
        y = torch.tensor(ys[idx], requires_grad=True)
        qp = pt.build_tracking_qp(torch.as_tensor(Xs[idx]), y, ridge=ridge)
        x = diff.solve_qp_batch_diff(qp, tparams(), device="cpu")
        (x @ cvec).sum().backward()
        return ridge.grad.numpy(), y.grad.numpy()

    g_r, g_y = grads([0, 1, 2])
    for b in range(B):
        r1, y1 = grads([b])
        np.testing.assert_allclose(g_r[b], r1[0], rtol=1e-9, atol=1e-14)
        assert rel_err(g_y[b], y1[0]) <= 1e-9
    assert np.all(np.abs(g_r) > 0)


def test_lifted_and_native_l1_gradients_agree():
    """examples/cost_penalty_tuning.py's check at a small size: the net
    loss's d/dlog(lambda) through the lifted 2n-variable QP (lambda in
    q, through solve_qp_diff) and through the native prox
    (solve_qp_l1_diff) agree to 1e-6 + 1e-3 relative."""
    rng = np.random.default_rng(11)
    N, T, B = 8, 30, 2
    w_prev = rng.dirichlet(np.ones(N))
    Xs = rng.standard_normal((B, 2 * T, N)) * 0.01
    ys = Xs @ rng.dirichlet(np.ones(N)) + rng.standard_normal((B, 2 * T)) * 0.002
    Xf, yf, Xo, yo = (torch.as_tensor(a) for a in
                      (Xs[:, :T], ys[:, :T], Xs[:, T:], ys[:, T:]))
    wp = torch.as_tensor(w_prev)
    eye, zero = torch.eye(N, dtype=torch.float64), torch.zeros(N, N,
                                                               dtype=torch.float64)

    def lifted(X, y, lam):
        P = torch.zeros(2 * N, 2 * N, dtype=torch.float64)
        P[:N, :N] = 2.0 * X.T @ X
        return CanonicalQP(
            P=P, q=torch.cat([-2.0 * X.T @ y, lam * torch.ones(N, dtype=torch.float64)]),
            C=torch.cat([torch.cat([torch.ones(1, N, dtype=torch.float64),
                                    torch.zeros(1, N, dtype=torch.float64)], 1),
                         torch.cat([eye, -eye], 1), torch.cat([-eye, -eye], 1)]),
            l=torch.cat([torch.ones(1, dtype=torch.float64),
                         torch.full((2 * N,), -float("inf"), dtype=torch.float64)]),
            u=torch.cat([torch.ones(1, dtype=torch.float64), wp, -wp]),
            lb=torch.zeros(2 * N, dtype=torch.float64),
            ub=torch.cat([torch.ones(N, dtype=torch.float64),
                          torch.full((N,), float("inf"), dtype=torch.float64)]),
            var_mask=torch.ones(2 * N, dtype=torch.float64),
            row_mask=torch.ones(1 + 2 * N, dtype=torch.float64),
            constant=y @ y)

    def plain(X, y):
        return CanonicalQP(
            P=2.0 * X.T @ X, q=-2.0 * X.T @ y,
            C=torch.ones(1, N, dtype=torch.float64),
            l=torch.ones(1, dtype=torch.float64), u=torch.ones(1, dtype=torch.float64),
            lb=torch.zeros(N, dtype=torch.float64), ub=torch.ones(N, dtype=torch.float64),
            var_mask=torch.ones(N, dtype=torch.float64),
            row_mask=torch.ones(1, dtype=torch.float64), constant=y @ y)

    prm = tparams(max_iter=20000, eps_abs=1e-10, eps_rel=1e-10)

    def net(solve):
        log_lam = torch.tensor(-3.2, dtype=torch.float64, requires_grad=True)
        lam = 10.0 ** log_lam
        total = 0.0
        for b in range(B):
            w = solve(b, lam)
            te = torch.sqrt(torch.mean((Xo[b] @ w - yo[b]) ** 2))
            total = total + te + 0.003 * torch.sum(torch.abs(w - wp))
        (total / B).backward()
        return float(log_lam.grad)

    g_lift = net(lambda b, lam: pt.solve_qp_diff(
        lifted(Xf[b], yf[b], lam), prm, device="cpu")[:N])
    g_native = net(lambda b, lam: pt.solve_qp_l1_diff(
        plain(Xf[b], yf[b]), lam * torch.ones(N, dtype=torch.float64), wp,
        prm, device="cpu"))
    assert abs(g_lift) > 0
    assert abs(g_lift - g_native) <= 1e-6 + 1e-3 * abs(g_lift)


def test_grad_f32_agrees_with_f64_direction():
    """The f32 gradient (sqrt(f32 eps) adjoint regularization, looser
    solve) agrees with the f64 one in sign and to 10% in magnitude, as
    the JAX package's own contract states."""
    rng = np.random.default_rng(3)
    n, T = 8, 24
    parts = tracking_parts(rng, n, T, ub=0.4, ridge2=0.0)
    cvec = rng.standard_normal(n)

    def grad(dtype, prm):
        ridge = torch.tensor(0.05, dtype=dtype, requires_grad=True)
        qp = port_qp(parts)
        qp = CanonicalQP(*(None if f is None else f.to(dtype) for f in qp))
        qp = qp._replace(P=qp.P + 2.0 * ridge * torch.eye(n, dtype=dtype))
        x = pt.solve_qp_diff(qp, prm, device="cpu")
        (torch.as_tensor(cvec, dtype=dtype) @ x).backward()
        return float(ridge.grad)

    g64 = grad(torch.float64, tparams())
    g32 = grad(torch.float32, pt.SolverParams(max_iter=20000, eps_abs=1e-6,
                                              eps_rel=1e-6))
    assert np.sign(g64) == np.sign(g32)
    np.testing.assert_allclose(g32, g64, rtol=0.1)


def chain_inputs(seed, n, T, B):
    rng = np.random.default_rng(seed)
    Xs = rng.standard_normal((B, T, n)) * 0.1
    ys = np.einsum("bti,i->bt", Xs, rng.dirichlet(np.ones(n)))
    return Xs, ys, rng.dirichlet(np.ones(n))


def test_grad_through_turnover_coupled_scan():
    """Four dates chained through the L1 center (each date's solution is
    the next date's center; the reference's lax.scan is a Python loop
    here): d(sum of TE + cost)/d(lambda) equals the JAX package's to
    GRAD_RTOL and central differences of the port's chain to 1e-3."""
    n, T, B, lam0 = 8, 30, 4, 1.5e-3
    Xs, ys, w0 = chain_inputs(53, n, T, B)

    def port_chain(lam, grad):
        lam = torch.tensor(lam, dtype=torch.float64, requires_grad=grad)
        c, total = torch.as_tensor(w0), 0.0
        for b in range(B):
            X, y = torch.as_tensor(Xs[b]), torch.as_tensor(ys[b])
            qp = pt.build_tracking_qp(X, y, ridge=0.005)
            x = (pt.solve_qp_l1_diff(qp, lam * torch.ones(n, dtype=torch.float64),
                                     c, tparams(), device="cpu") if grad else
                 pt.solve_qp(qp, tparams(), l1_weight=lam * torch.ones(
                     n, dtype=torch.float64), l1_center=c, device="cpu").x)
            total = total + torch.sqrt(torch.mean((X @ x - y) ** 2)) \
                + 0.003 * torch.sum(torch.abs(x - c))
            c = x
        if not grad:
            return float(total)
        total.backward()
        return float(lam.grad)

    def jax_chain(lam):
        def body(c_prev, Xy):
            X, y = Xy
            x = jax_solve_qp_l1_diff(jax_build_tracking_qp(X, y, ridge=0.005),
                                     jnp.full(n, lam), c_prev, jparams())
            te = jnp.sqrt(jnp.mean((X @ x - y) ** 2))
            return x, te + 0.003 * jnp.sum(jnp.abs(x - c_prev))
        _, nets = jax.lax.scan(body, jnp.asarray(w0),
                               (jnp.asarray(Xs), jnp.asarray(ys)))
        return jnp.sum(nets)

    g = port_chain(lam0, True)
    g_jax = float(jax.grad(jax_chain)(jnp.asarray(lam0)))
    np.testing.assert_allclose(g, g_jax, rtol=GRAD_RTOL)
    h = 1e-7
    fd = (port_chain(lam0 + h, False) - port_chain(lam0 - h, False)) / (2 * h)
    np.testing.assert_allclose(g, fd, rtol=1e-3, atol=1e-8)
    assert abs(g) > 1e-6


def test_grad_through_net_pnl_accounting():
    """The turnover-coupled chain composed with the accounting engine
    (accounting.simulate: drift, levels, variable costs) into annualized
    net Sharpe: d/dlambda equals the JAX package's to GRAD_RTOL and
    central differences of the port's pipeline to 1e-3."""
    rng = np.random.default_rng(21)
    n, window, d_reb, step = 6, 16, 3, 8
    T = window + d_reb * step + 1
    R = rng.standard_normal((T, n)) * 0.01 + 0.0004 * rng.standard_normal(n)
    y = R @ rng.dirichlet(np.ones(n)) + 0.001 * rng.standard_normal(T)
    reb_idx = np.arange(window, window + d_reb * step, step)
    Xs = np.stack([R[i - window:i] for i in reb_idx])
    ys = np.stack([y[i - window:i] for i in reb_idx])
    w0 = np.full(n, 1.0 / n)
    lam0 = 4e-4

    def port_sharpe(lam, grad):
        lam = torch.tensor(lam, dtype=torch.float64, requires_grad=grad)
        w, ws = torch.as_tensor(w0), []
        for b in range(d_reb):
            qp = pt.build_tracking_qp(torch.as_tensor(Xs[b]),
                                      torch.as_tensor(ys[b]), ridge=0.01)
            wv = lam * torch.ones(n, dtype=torch.float64)
            w = (pt.solve_qp_l1_diff(qp, wv, w, tparams(), device="cpu")
                 if grad else pt.solve_qp(qp, tparams(), l1_weight=wv,
                                          l1_center=w, device="cpu").x)
            ws.append(w)
        sim = simulate(torch.stack(ws), torch.as_tensor(R), reb_idx, vc=0.005)
        s = net_sharpe(sim.returns, sim.valid.to(torch.float64))
        if not grad:
            return float(s)
        s.backward()
        return float(lam.grad)

    def jax_sharpe(lam):
        def body(w_prev, Xy):
            X, yb = Xy
            w = jax_solve_qp_l1_diff(jax_build_tracking_qp(X, yb, ridge=0.01),
                                     jnp.full(n, lam), w_prev, jparams())
            return w, w
        _, ws = jax.lax.scan(body, jnp.asarray(w0),
                             (jnp.asarray(Xs), jnp.asarray(ys)))
        sim = jax_simulate(ws, jnp.asarray(R), jnp.asarray(reb_idx), vc=0.005)
        return net_sharpe(sim.returns, sim.valid.astype(jnp.float64))

    g = port_sharpe(lam0, True)
    np.testing.assert_allclose(
        g, float(jax.grad(jax_sharpe)(jnp.asarray(lam0))), rtol=GRAD_RTOL)
    h = 1e-7
    fd = (port_sharpe(lam0 + h, False) - port_sharpe(lam0 - h, False)) / (2 * h)
    np.testing.assert_allclose(g, fd, rtol=1e-3, atol=1e-6)
    assert abs(g) > 1e-3


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """No silent CPU fallback: the differentiable entry points raise
    without a card and without ``device``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    qp = port_qp(tracking_parts(np.random.default_rng(0), 4, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.solve_qp_diff(qp, tparams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.solve_qp_l1_diff(qp, torch.zeros(4, dtype=torch.float64), None,
                            tparams())


# ---------------------------------------------------------------------------
# the golden of chip_smoke.py's phase 9
# ---------------------------------------------------------------------------

# chip_smoke.py's phase 9: the differentiable solve at the main path's
# width. The tracking batch of examples/differentiable_tuning.py's
# objective (252 dates x 500 assets; per date a 252-day fit window and
# the 21 trading days after it as the evaluation window), the ridge of
# examples/backtest_usa.py's configuration 2 (1e-4, a point optimum);
# the turnover-knob chain of examples/net_sharpe_tuning.py on the first
# CHAIN dates at the chained-cost configuration's lambda = vc = 0.002;
# date 0's first box_assets assets with the box capped at box_ub (0.02:
# 22 weights at the cap, 30 at zero) for the box-bound cotangents on the
# dense adjoint (at all 500 assets three weights within eps of zero make
# f32 and f64 take different active sets, and the gradients differ by
# half); date 0 as examples/compare_solver.py poses it (no ridge, the
# box capped at 0.1) for the cross-solver table, SLSQP on its first 100
# assets.
FULL = dict(seed=42, n_dates=252, fit=252, oos=21, n_assets=500,
            ridge=1e-4, chain_dates=64, lam=0.002, vc=0.002, box_ub=0.02,
            box_assets=100, compare_ub=0.1, slsqp_assets=100, f64=True)
HEADLINE = dict(max_iter=2000, eps_abs=1e-5, eps_rel=1e-5, polish=False,
                scaling_iters=2)
DIFF = {
    "diff_trinv": dict(HEADLINE, linsolve="trinv"),
    "diff_woodbury": dict(HEADLINE, linsolve="woodbury", woodbury_refine=1,
                          check_interval=35, scaling_mode="factored"),
    # diff_trinv's solve with Pf/Pdiag dropped: the dense adjoint.
    "diff_dense": dict(HEADLINE, linsolve="trinv"),
}
DENSE = ("diff_dense",)
CHAIN = dict(max_iter=2000, eps_abs=1e-3, eps_rel=1e-3, polish=False,
             scaling_iters=2, linsolve="woodbury", woodbury_refine=0,
             check_interval=35, scaling_mode="factored")
BOX_FIELDS = ("q", "C", "l", "u", "lb", "ub")
COMPARE_ROWS = ("device-admm-f32", "device-admm-f64", "ipm-f64",
                "native-cpp-admm")
HIGHEST = jax.lax.Precision.HIGHEST


def phase9_inputs(s):
    """(Xf, yf, Xo, yo) float32 numpy: per date the fit window and the
    evaluation window after it, from one draw of the universe."""
    Xs, ys = jax_universe(s["seed"], s["n_dates"], s["fit"] + s["oos"],
                          s["n_assets"])
    f = s["fit"]
    return Xs[:, :f], ys[:, :f], Xs[:, f:], ys[:, f:]


def pack(mask):
    return np.packbits(np.asarray(mask, bool), axis=-1)


def jax_tuning_run(Xf, yf, Xo, yo, th, params, dense):
    """examples/differentiable_tuning.py's loss over the batch, its
    gradients w.r.t. the per-date log10 ridge and the fit-window
    benchmark, the forward solve and its active sets."""
    def qps_of(yv, tv):
        qp = jax.vmap(lambda X, y, t: jax_build_tracking_qp(
            X, y, ridge=10.0 ** t))(Xf, yv, tv)
        return qp._replace(Pf=None, Pdiag=None) if dense else qp

    def loss(yv, tv):
        w = jax.vmap(lambda qp: jax_solve_qp_diff(qp, params))(qps_of(yv, tv))
        r = jnp.einsum("btn,bn->bt", Xo, w, precision=HIGHEST) - yo
        return jnp.mean(jnp.sqrt(jnp.mean(r * r, axis=1)))

    def forward(yv, tv):
        qps = qps_of(yv, tv)
        sol = jax.vmap(lambda qp: jax_solve_qp(qp, params))(qps)
        return sol.status, sol.iters, jax.vmap(jax_active_sets)(qps, sol)

    val, (dy, dth) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(yf, th)
    status, iters, sets = jax.jit(forward)(yf, th)
    aC, _, aB, _, upC, upB = sets
    return dict(loss=np.asarray(val), dtheta=np.asarray(dth),
                dy=np.asarray(dy), status=np.asarray(status),
                iters=np.asarray(iters), aC=pack(aC), aB=pack(aB),
                upC=pack(upC), upB=pack(upB))


L1_SETS = ("kink", "pos", "neg", "aC", "box", "upC", "upB")


def jax_l1_sets(qp, sol, w, c):
    """The JAX package's native-L1 vjp classification at one solution
    (``porqua_tpu/qp/diff.py::_l1_bwd``): kink-resters, the smooth-side
    sign as two masks, active rows and box coordinates, their sides."""
    from porqua_tpu.qp.diff import _classification_tols
    from porqua_tpu.qp.polish import classify_active, classify_l1

    x = sol.x
    err = jnp.maximum(sol.prim_res, sol.dual_res)
    prox, dual_tol = _classification_tols(sol, x.dtype)
    at_kink, sign_s, mu_box, window = classify_l1(x, sol.mu, w, c, err,
                                                  dual_mode="solution")
    dead_side = jnp.where(jnp.abs(x - c) > window, jnp.sign(x - c), 0.0)
    sign_s = jnp.where(w > 0, sign_s, dead_side)
    low_C, up_C, eq_C, low_B, up_B, eq_B = classify_active(
        qp, sol.z, x, sol.y, mu_box, prox, dual_tol)
    box = (low_B | up_B | eq_B) & (qp.var_mask > 0)
    return dict(kink=at_kink & ~box, pos=sign_s > 0, neg=sign_s < 0,
                aC=(low_C | up_C | eq_C) & (qp.row_mask > 0), box=box,
                upC=up_C & ~low_C, upB=up_B & ~low_B)


def jax_chain_run(Xc, yc, R, reb, w0, lam, vc, params, dtype):
    """The turnover chain on XLA-CPU: each date's solution is the next
    date's L1 center (no warm start); the loss is the held series' net
    Sharpe after variable costs. Returns the chain, each date's vjp
    classification, the per-date vjps of the backward (w_bar, c_bar for
    each date's incoming cotangent g), dS/dlog(lambda), and ``date``
    (one date's solution, classification and vjp from a carry)."""
    n = Xc.shape[-1]
    wvec = jnp.full(n, lam, dtype)

    def date(X, y, cv, g):
        qp = jax_build_tracking_qp(X, y)
        sol = jax_solve_qp(qp, params, l1_weight=wvec, l1_center=cv)
        bars = jax.vjp(lambda w, cc: jax_solve_qp_l1_diff(qp, w, cc, params),
                       wvec, cv)[1](g)
        return sol.status, sol.iters, jax_l1_sets(qp, sol, wvec, cv), bars

    date = jax.jit(date)
    T = Xc.shape[0]
    xs, c = [], jnp.asarray(w0, dtype)
    build = jax.jit(jax_build_tracking_qp)
    for t in range(T):
        c = jax_solve_qp(build(Xc[t], yc[t]), params, l1_weight=wvec,
                         l1_center=c).x
        xs.append(c)
    ws = jnp.stack(xs)

    def sharpe(ws):
        sim = jax_simulate(ws, R, reb, vc=vc)
        return net_sharpe(sim.returns, sim.valid.astype(dtype))

    d = jax.grad(sharpe)(ws)
    per = [None] * T
    g = d[T - 1]
    for t in range(T - 1, -1, -1):
        cv = ws[t - 1] if t else jnp.asarray(w0, dtype)
        per[t] = (g,) + date(Xc[t], yc[t], cv, g)
        if t:
            g = d[t - 1] + per[t][4][1]
    out = dict(x=np.asarray(ws), g=np.stack([np.asarray(p[0]) for p in per]),
               status=np.asarray([int(p[1]) for p in per], np.int32),
               iters=np.asarray([int(p[2]) for p in per], np.int32),
               w_bar=np.stack([np.asarray(p[4][0]) for p in per]),
               c_bar=np.stack([np.asarray(p[4][1]) for p in per]),
               sharpe=np.asarray(sharpe(ws)), date=date)
    for k in L1_SETS:
        out[f"sets/{k}"] = pack(np.stack([np.asarray(p[3][k]) for p in per]))
    out["dlog_lam"] = np.asarray(lam * out["w_bar"].astype(np.float64).sum())
    return out


def box_parts(Xf0, yf0, ub, ridge=0.0):
    """Date 0's tracking QP with the box capped at ``ub`` (numpy f64)."""
    X, y = np.asarray(Xf0, np.float64), np.asarray(yf0, np.float64)
    n = X.shape[1]
    return dict(P=2.0 * X.T @ X + 2.0 * ridge * np.eye(n), q=-2.0 * X.T @ y,
                C=np.ones((1, n)), l=np.ones(1), u=np.ones(1),
                lb=np.zeros(n), ub=np.full(n, ub), constant=float(y @ y))


def write_golden(path=GOLDEN, sizes=FULL):
    """Run the JAX package (XLA-CPU, backend="xla") on phase 9's inputs
    and save what the card is held to: per tuning config (f32 and f64)
    status, iterations, the loss, per-date dL/dtheta and dL/dy_fit and
    the active sets (bit-packed); the chain's f32 carries, incoming
    cotangents and per-date w_bar/c_bar, the same vjps in f64 from the
    f32 carries, and both chains' dS/dlog(lambda); the box problem's
    field gradients; the cross-solver tables. Never P."""
    s = sizes
    Xf, yf, Xo, yo = phase9_inputs(s)
    dtypes = (np.float32, np.float64) if s["f64"] else (np.float32,)
    out = {"meta": json.dumps(dict(s, platform=jax.default_backend()))}
    for name, over in DIFF.items():
        params = JaxParams(**dict(over, backend="xla"))
        out[f"{name}/params"] = json.dumps(dataclasses.asdict(params))
        for dtype in dtypes:
            sfx = "" if dtype == np.float32 else "_f64"
            a = lambda v: jnp.asarray(v, dtype)
            t0 = time.perf_counter()
            res = jax_tuning_run(a(Xf), a(yf), a(Xo), a(yo),
                                 jnp.full(len(Xf), np.log10(s["ridge"]), dtype),
                                 params, name in DENSE)
            for k, v in res.items():
                out[f"{name}/{k}{sfx}"] = (v.astype(np.float32)
                                           if v.dtype == np.float64 else v)
            print(f"{name}{sfx}: {time.perf_counter() - t0:.1f} s, solved "
                  f"{int((res['status'] == 1).sum())}/{len(Xf)}, iters "
                  f"{sorted(set(res['iters'].tolist()))}, dL/dtheta "
                  f"{float(res['dtheta'].sum()):.6e}", flush=True)

    # The chain (f32), its per-date vjps in f64 from the f32 carries, and
    # the f64 chain's own gradient (printed on the card, not held).
    D = s["chain_dates"]
    R, reb = chain_market(Xo[:D])
    w0 = np.full(s["n_assets"], 1.0 / s["n_assets"])
    params = JaxParams(**dict(CHAIN, backend="xla"))
    out["chain/params"] = json.dumps(dataclasses.asdict(params))
    chains = {}
    for dtype in dtypes:
        a = lambda v: jnp.asarray(v, dtype)
        t0 = time.perf_counter()
        chains[dtype] = jax_chain_run(a(Xf[:D]), a(yf[:D]), a(R), reb, w0,
                                      s["lam"], s["vc"], params, dtype)
        print(f"chain {np.dtype(dtype).name}: {time.perf_counter() - t0:.1f} s"
              f", dS/dlog lam {float(chains[dtype]['dlog_lam']):.6e}",
              flush=True)
    c32 = chains[np.float32]
    for k in ("x", "status", "iters", "g", "w_bar", "c_bar", "sharpe",
              "dlog_lam") + tuple(f"sets/{k}" for k in L1_SETS):
        out[f"chain/{k}"] = (c32[k].astype(np.float32)
                             if c32[k].dtype == np.float64 else c32[k])
    if s["f64"]:
        # Each date again in f64 from the f32 chain's carry, with the f32
        # backward's incoming cotangent: the per-date twin.
        out["chain/dlog_lam_f64"] = chains[np.float64]["dlog_lam"].astype(
            np.float32)
        a = lambda v: jnp.asarray(v, np.float64)
        carry = np.concatenate([w0[None], c32["x"][:-1]]).astype(np.float32)
        _, _, sets, (w64, c64) = jax.vmap(chains[np.float64]["date"])(
            a(Xf[:D]), a(yf[:D]), a(carry), a(c32["g"]))
        out["chain/w_bar_f64"] = np.asarray(w64, np.float32)
        out["chain/c_bar_f64"] = np.asarray(c64, np.float32)
        for k in L1_SETS:
            out[f"chain/sets/{k}_f64"] = pack(sets[k])

    # The box problem: both sides of the box bind.
    k = s["box_assets"]
    parts = box_parts(Xf[0][:, :k], yf[0], s["box_ub"], s["ridge"])
    params = JaxParams(**dict(DIFF["diff_trinv"], backend="xla"))
    for dtype in dtypes:
        sfx = "" if dtype == np.float32 else "_f64"
        qp = JaxQP(**{f: jnp.asarray(parts[f], dtype) for f in FIELDS},
                   var_mask=jnp.ones(k, dtype), row_mask=jnp.ones(1, dtype),
                   constant=jnp.asarray(parts["constant"], dtype))
        Xo0, yo0 = jnp.asarray(Xo[0][:, :k], dtype), jnp.asarray(yo[0], dtype)

        def te(qp):
            r = jnp.dot(Xo0, jax_solve_qp_diff(qp, params),
                        precision=HIGHEST) - yo0
            return jnp.sqrt(jnp.mean(r * r))

        g = jax.jit(jax.grad(te))(qp)
        sol = jax_solve_qp(qp, params)
        aC, _, aB, _, upC, upB = jax_active_sets(qp, sol)
        for f in BOX_FIELDS:
            out[f"box/{f}{sfx}"] = np.asarray(getattr(g, f), np.float32)
        for f, v in dict(status=sol.status, iters=sol.iters, aC=pack(aC),
                         aB=pack(aB), upC=pack(upC), upB=pack(upB)).items():
            out[f"box/{f}{sfx}"] = np.asarray(v)

    # The cross-solver tables (the harness's default params).
    parts = box_parts(Xf[0], yf[0], s["compare_ub"])
    tables = {}
    k = s["slsqp_assets"]
    sliced = dict(parts, P=parts["P"][:k, :k], q=parts["q"][:k],
                  C=parts["C"][:, :k], lb=parts["lb"][:k], ub=parts["ub"][:k])
    for tag, p, rows in (("full", parts, COMPARE_ROWS),
                         ("slice", sliced, ("scipy-slsqp", "ipm-f64"))):
        t0 = time.perf_counter()
        df = jax_compare_solvers(jax_qp(p), solvers=list(rows))
        tables[tag] = {r: {c: float(df.loc[r, c]) for c in df.columns
                           if c != "error"} for r in df.index}
        print(f"compare {tag}: {time.perf_counter() - t0:.1f} s\n{df}",
              flush=True)
    out["compare"] = json.dumps(tables)
    # Why the SLSQP row runs on the slice: one call at full width.
    from porqua_tpu.compare import _backend_scipy

    t0 = time.perf_counter()
    _backend_scipy(parts, JaxParams())
    print(f"scipy-slsqp at {s['n_assets']} assets: "
          f"{time.perf_counter() - t0:.1f} s a call (the harness calls it "
          f"twice)", flush=True)
    np.savez_compressed(path, **out)


# A small size of phase 9 where the window (12 days) is shorter than the
# universe (16 assets), so the factored adjoint runs as at full width.
SMALL = dict(FULL, n_dates=3, fit=12, oos=4, n_assets=16, chain_dates=3,
             box_ub=0.1, box_assets=16, compare_ub=0.3, slsqp_assets=8)


def test_write_golden_and_rehearse_phase9_at_a_small_size(tmp_path,
                                                          monkeypatch):
    """The --write-golden mode end to end at a small size (every array
    chip_smoke.py's phase 9 reads, with its shape and dtype), then phase
    9 itself on the CPU against that golden: the port's f32 runs (the
    kernels' plain twins here) pass every check but the launch counts,
    which only the card can meet, and both faulty backwards fail the box
    rule. One test, so the golden's JAX compiles run once."""
    import chip_smoke

    path = str(tmp_path / "g.npz")
    write_golden(path, SMALL)
    g = np.load(path)
    assert json.loads(str(g["meta"]))["n_assets"] == 16
    for name in DIFF:
        for sfx in ("", "_f64"):
            assert g[f"{name}/dy{sfx}"].shape == (3, 12)
            assert g[f"{name}/dy{sfx}"].dtype == np.float32
            assert g[f"{name}/dtheta{sfx}"].shape == (3,)
            assert g[f"{name}/aB{sfx}"].shape == (3, 2)
            assert (g[f"{name}/status{sfx}"] == 1).all()
    assert g["chain/w_bar"].shape == g["chain/w_bar_f64"].shape == (3, 16)
    assert g["chain/g"].dtype == np.float32
    assert g["chain/sets/kink"].shape == g["chain/sets/kink_f64"].shape
    assert g["box/ub_f64"].shape == (16,)
    tables = json.loads(str(g["compare"]))
    assert set(tables["full"]) == set(COMPARE_ROWS)
    assert set(tables["slice"]) == {"scipy-slsqp", "ipm-f64"}

    monkeypatch.setattr(chip_smoke, "DIFF_PATH", path)
    monkeypatch.setattr(chip_smoke, "kernel_row", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    monkeypatch.setattr(chip_smoke, "FAILURES", [])
    added = chip_smoke.diff_phase({}, lambda: None, device="cpu")
    assert added == ["diff_trinv", "diff_woodbury", "diff_chain",
                     "diff_compare"]
    failed = chip_smoke.FAILURES
    assert len(failed) == 5 and all("launched" in f for f in failed), failed


if __name__ == "__main__":
    if "--write-golden" not in sys.argv:
        sys.exit("usage: python tests/test_torch_diff.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    write_golden()
    print(f"wrote {GOLDEN} in {time.perf_counter() - t0:.1f} s")
