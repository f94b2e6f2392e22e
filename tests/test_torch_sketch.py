"""The port's count-sketch embedding (``qp/canonical.py::sketch_rows``,
``tracking.py::_sketch_window``, ``qp/sketch.py``) and the sketch-fed
tracking solve against the JAX package, on the same numpy windows.

The JAX package draws its buckets, signs and probes with
``jax.random``; torch cannot reproduce those streams, so the port takes
the draws as inputs, and these tests hand it the JAX package's arrays.
With the same draws the sketched window equals the JAX package's
within SKETCH_RTOL (each bucket sums the same signed rows in float32,
in another order; measured equal on the CPU), and the Gram error bound
within 1e-5 relative. Solves pin float32 on both sides: status and
iterations equal per lane, TE within 5e-4 relative (measured 1.7e-4:
the in-sample TE of an iterate stopped at eps 1e-5), weights within
W_TOL. The sketched objective has rank at most D = 32 < N = 48, so its
optimum is a face and the f32 weights are fixed only up to rounding
along it (measured 8.5e-5 apart with equal iterations; ROADMAP section
C records the same for the USA backtest's face).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from porqua_tpu.qp.canonical import sketch_rows as jax_sketch_rows
from porqua_tpu.qp.sketch import SketchParams as JaxSketchParams
from porqua_tpu.qp.sketch import gram_rel_err as jax_gram_rel_err
from porqua_tpu.qp.sketch import sketched_tracking_qp as jax_sketched_qp
from porqua_tpu.qp.solve import SolverParams as JaxParams
from porqua_tpu.tracking import _sketch_window as jax_sketch_window
from porqua_tpu.tracking import tracking_step as jax_tracking_step

import porqua_tpu_torch as pt
from porqua_tpu_torch.qp.canonical import SketchDraws, sketch_draws, sketch_rows
from porqua_tpu_torch.qp.sketch import (SketchParams, count_sketch,
                                        gram_rel_err, sketched_tracking_qp,
                                        tracking_step_sketched)
from porqua_tpu_torch.tracking import _sketch_window, build_tracking_qp

T, N, D = 64, 48, 32
PARAMS = pt.SolverParams(max_iter=2000, eps_abs=1e-5, eps_rel=1e-5,
                         polish=False, check_interval=25)
SKETCH_RTOL = 1e-6
W_TOL = 2e-4
QP_FIELDS = ("P", "q", "C", "l", "u", "lb", "ub", "constant", "Pf", "Pdiag")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def universe(seed=3, b=4):
    return pt.synthetic_universe_np(seed, b, T, N)


def jax_draws(rows, sketch_dim, seed, n, probes=8):
    """The JAX package's draws for ``seed`` (its tracking path's key
    splits), as the port's SketchDraws."""
    k_embed, k_probe = jax.random.split(jax.random.key(seed))
    kb, ks = jax.random.split(k_embed)
    return SketchDraws(
        torch.as_tensor(np.asarray(jax.random.randint(kb, (rows,), 0,
                                                      sketch_dim))),
        torch.as_tensor(np.array(jax.random.rademacher(ks, (rows,),
                                                       jnp.float32))),
        torch.as_tensor(np.array(jax.random.normal(k_probe, (probes, n),
                                                   jnp.float32))))


# ---------------------------------------------------------------------------
# the embedding primitive
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [8, D, 63])
def test_sketch_rows_with_jax_draws_equals_jax(d):
    Xs, _ = universe()
    X = Xs[0]
    key = jax.random.key(11)
    kb, ks = jax.random.split(key)
    bucket = np.asarray(jax.random.randint(kb, (T,), 0, d))
    sign = np.array(jax.random.rademacher(ks, (T,), jnp.float32))
    ref = np.asarray(jax_sketch_rows(jnp.asarray(X), d, key))
    got = sketch_rows(torch.as_tensor(X), d, torch.as_tensor(bucket),
                      torch.as_tensor(sign)).numpy()
    np.testing.assert_allclose(got, ref, rtol=SKETCH_RTOL,
                               atol=SKETCH_RTOL * np.abs(ref).max())
    # count_sketch is the same primitive.
    assert np.array_equal(count_sketch(torch.as_tensor(X), d,
                                       torch.as_tensor(bucket),
                                       torch.as_tensor(sign)).numpy(), got)


def test_port_draws_are_seeded_and_deterministic():
    """Same seed, same bits (buckets, signs, probes, the embedding);
    another seed, another embedding; batched lanes share the draws."""
    a, b = sketch_draws(T, D, 5, n=N, probes=4), sketch_draws(T, D, 5, n=N,
                                                              probes=4)
    for f, g in zip(a, b):
        assert torch.equal(f, g)
    assert set(a.sign.tolist()) <= {-1.0, 1.0}
    assert int(a.bucket.min()) >= 0 and int(a.bucket.max()) < D
    c = sketch_draws(T, D, 6)
    assert not torch.equal(a.bucket, c.bucket)
    Xs, ys = universe()
    X, y = torch.as_tensor(Xs), torch.as_tensor(ys)
    one = _sketch_window(X, y, D, a)
    two = _sketch_window(X, y, D, b)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    lane = _sketch_window(X[1:2], y[1:2], D, a)
    assert torch.equal(lane[0][0], one[0][1])


def test_window_sketch_equals_jax():
    """The stacked [X | y] embedding of the tracking path, fed the JAX
    package's draws for a seed, equals its _sketch_window."""
    Xs, ys = universe()
    draws = jax_draws(T, D, 9, N)
    Xj, yj, _ = jax_sketch_window(jnp.asarray(Xs[0]), jnp.asarray(ys[0]),
                                  D, 9)
    Xt, yt = _sketch_window(torch.as_tensor(Xs[:1]), torch.as_tensor(ys[:1]),
                            D, draws)
    for got, ref in ((Xt[0], Xj), (yt[0], yj)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=SKETCH_RTOL,
                                   atol=SKETCH_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("d", [8, 16, 48])
def test_gram_rel_err_with_jax_probes(d):
    """The measured Gram error with the JAX package's probes equals its
    certificate within 1e-5 relative, and shrinks as the sketch widens
    (checked across the parametrization by the last case)."""
    Xs, _ = universe()
    X = Xs[0]
    k_s, k_p = jax.random.split(jax.random.key(0))
    kb, ks = jax.random.split(k_s)
    Xs_j = jax_sketch_rows(jnp.asarray(X), d, k_s)
    ref = float(jax_gram_rel_err(jnp.asarray(X), Xs_j, k_p, 8))
    V = torch.as_tensor(np.array(jax.random.normal(k_p, (8, N),
                                                   jnp.float32)))
    got = float(gram_rel_err(torch.as_tensor(X)[None],
                             torch.as_tensor(np.asarray(Xs_j))[None], V)[0])
    assert got > 0.0
    assert abs(got - ref) <= 1e-5 * ref
    if d == 48:
        Xs_8 = torch.as_tensor(np.asarray(jax_sketch_rows(jnp.asarray(X), 8,
                                                          k_s)))[None]
        assert got < float(gram_rel_err(torch.as_tensor(X)[None], Xs_8,
                                        V)[0])


# ---------------------------------------------------------------------------
# the threaded (sketch-fed) path
# ---------------------------------------------------------------------------

def test_sketch_dim_zero_is_bit_exact_passthrough():
    """sketch_dim = 0, and a non-compressing sketch_dim >= T, build
    exactly the unsketched QPs; tracking_step with sketch_dim = 0 and
    tracking_step_sketched with SketchParams() equal the plain
    tracking_step bit for bit."""
    Xs, ys = universe()
    X, y = torch.as_tensor(Xs), torch.as_tensor(ys)
    base = build_tracking_qp(X, y)
    for d in (0, T, T + 7):
        qp = build_tracking_qp(X, y, sketch_dim=d, sketch_seed=5)
        for name in QP_FIELDS:
            assert torch.equal(getattr(qp, name), getattr(base, name)), name
    plain = pt.tracking_step(Xs, ys, PARAMS, device="cpu")
    off = pt.tracking_step(Xs, ys, dataclasses.replace(PARAMS, sketch_dim=0,
                                                       sketch_seed=4),
                           device="cpu")
    skd, info = tracking_step_sketched(Xs, ys, PARAMS, SketchParams(),
                                       device="cpu")
    for res in (off, skd):
        for f, g in zip(res, plain):
            assert torch.equal(f, g)
    assert info.sketch_dim.tolist() == [0] * 4
    assert info.gram_rel_err.tolist() == [0.0] * 4


def test_threaded_sketch_matches_sketched_tracking_qp():
    """The solve path (build_tracking_qp(sketch_dim=d)) and the
    certificate path (sketched_tracking_qp) share one embedding: the
    assembled QPs are bit-equal, for the port's own draws and for
    given ones."""
    Xs, ys = universe()
    X, y = torch.as_tensor(Xs), torch.as_tensor(ys)
    qp_a = build_tracking_qp(X, y, sketch_dim=D, sketch_seed=9)
    qp_b, info = sketched_tracking_qp(X, y, SketchParams(D, seed=9))
    assert qp_a.Pf.shape == (4, D, N)
    assert info.sketch_dim.tolist() == [D] * 4
    assert info.rows_in.tolist() == [T] * 4
    for name in QP_FIELDS:
        assert torch.equal(getattr(qp_a, name), getattr(qp_b, name)), name
    draws = jax_draws(T, D, 9, N)
    qp_c = build_tracking_qp(X, y, sketch_dim=D, draws=draws)
    qp_d, _ = sketched_tracking_qp(X, y, SketchParams(D), draws=draws)
    for name in QP_FIELDS:
        assert torch.equal(getattr(qp_c, name), getattr(qp_d, name)), name


def test_certificate_path_matches_jax():
    """sketched_tracking_qp with the JAX draws: the QP equals the JAX
    package's within the f32 tolerance of its Gram build, and the
    certificate equals its gram_rel_err."""
    Xs, ys = universe(b=1)
    qp_j, info_j = jax_sketched_qp(jnp.asarray(Xs[0]), jnp.asarray(ys[0]),
                                   JaxSketchParams(D, seed=2))
    qp_t, info_t = sketched_tracking_qp(
        torch.as_tensor(Xs), torch.as_tensor(ys), SketchParams(D, seed=2),
        draws=jax_draws(T, D, 2, N))
    for name in ("q", "Pf", "constant"):
        ref = np.asarray(getattr(qp_j, name))
        np.testing.assert_allclose(getattr(qp_t, name)[0].numpy(), ref,
                                   rtol=1e-5, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)
    assert abs(float(info_t.gram_rel_err[0])
               - float(info_j.gram_rel_err)) <= 1e-5 * float(
                   info_j.gram_rel_err)


@pytest.mark.parametrize("method", ["admm", "pdhg", "napg"])
def test_sketch_fed_solve_matches_jax(method):
    """tracking_step with sketch_dim set, fed the JAX package's draws
    for the seed, against the JAX package's tracking_step on every
    backend: status and iterations equal per lane, weights within W_TOL,
    TE (always on the true window) within 5e-4 relative."""
    Xs, ys = universe()
    params = dataclasses.replace(PARAMS, method=method, sketch_dim=D,
                                 sketch_seed=1)
    if method == "pdhg":
        params = dataclasses.replace(params, eps_abs=1e-4, eps_rel=1e-4,
                                     max_iter=4000)
    ref = jax_tracking_step(jnp.asarray(Xs), jnp.asarray(ys),
                            JaxParams(**dataclasses.asdict(params)))
    got = pt.tracking_step(Xs, ys, params, device="cpu",
                           draws=jax_draws(T, D, 1, N))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights),
                               atol=W_TOL, rtol=0)
    np.testing.assert_allclose(got.tracking_error.numpy(),
                               np.asarray(ref.tracking_error), rtol=5e-4)
    assert (got.status == 1).all()


def test_sketch_fed_own_draws_repeat_and_stay_in_band():
    """The port's own seeded draws: two calls give the same bits, the
    solve retires SOLVED, and the TE on the true window stays within
    the reference test's band of the dense solve (relative drift < 2)."""
    Xs, ys = universe()
    params = dataclasses.replace(PARAMS, sketch_dim=D, sketch_seed=3)
    a = pt.tracking_step(Xs, ys, params, device="cpu")
    b = pt.tracking_step(Xs, ys, params, device="cpu")
    for f, g in zip(a, b):
        assert torch.equal(f, g)
    dense = pt.tracking_step(Xs, ys, PARAMS, device="cpu")
    assert (a.status == 1).all() and (dense.status == 1).all()
    drift = ((a.tracking_error - dense.tracking_error)
             / dense.tracking_error).max()
    assert float(drift) < 2.0
    w = a.weights.numpy()
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=10 * PARAMS.eps_abs)


def test_committed_golden_shapes():
    """secondary_golden.npz carries what chip_smoke.py's phase 8 reads."""
    from test_torch_compaction import COMPACTED, GOLDEN, SECONDARY

    g = np.load(GOLDEN)
    meta = json.loads(str(g["meta"]))
    B, n = meta["n_dates"], meta["n_assets"]
    for name in SECONDARY:
        assert g[f"{name}/x"].shape == (B, n)
        assert g[f"{name}/x"].dtype == np.float32
        assert set(json.loads(str(g[f"{name}/params"]))) == set(
            dataclasses.asdict(pt.SolverParams()))
    for name in COMPACTED:
        assert g[f"{name}/x_f64"].shape == (B, n)
        assert g[f"{name}/report/lane_segments"] <= g[
            f"{name}/report/dense_lane_segments"]
    assert (g["pdhg/status"] == 2).all()                 # BENCH_r19's 0/252
    assert (g["compact_napg/status"] == 1).all()
    assert g["northstar/bucket"].shape == (meta["sk_window"],)
    assert g["northstar/probes"].shape == (meta["probes"], meta["sk_assets"])
    for arm in ("dense", "admm", "pdhg", "napg"):
        assert int(g[f"northstar/{arm}/status"][0]) == 1
    assert os.path.getsize(GOLDEN) < 4 * 2 ** 20
