"""The port's covariance and mean estimators and PSD helpers against
the JAX package's on the same numpy inputs, in float64 to 1e-12 (the
same arithmetic in another summation order)."""

import numpy as np
import pandas as pd
import pytest

import jax.numpy as jnp
import torch

from porqua_tpu.estimators import covariance as jcov
from porqua_tpu.estimators import mean as jmean
from porqua_tpu.utils import psd as jpsd

from porqua_tpu_torch.estimators import covariance as tcov
from porqua_tpu_torch.estimators import mean as tmean
from porqua_tpu_torch.utils import psd as tpsd


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-12


@pytest.fixture
def returns(rng):
    return rng.standard_normal((120, 6)) * 0.01


def close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=1e-12)


@pytest.mark.parametrize("fn", ["cov_pearson", "cov_duv",
                                "cov_linear_shrinkage", "cov_ledoit_wolf"])
def test_covariance_functions_match_jax(fn, returns):
    """On one window and on a batch of three (a leading axis)."""
    batch = np.stack([returns, returns[::-1] * 1.5, returns ** 2])
    for X in (returns, batch):
        args = (0.3,) if fn == "cov_linear_shrinkage" else ()
        close(getattr(tcov, fn)(torch.as_tensor(X), *args),
              getattr(jcov, fn)(jnp.asarray(X), *args))


@pytest.mark.parametrize("spec", [
    dict(method="pearson"), dict(method="duv"),
    dict(method="linear_shrinkage", lambda_covmat_regularization=0.2),
    dict(method="linear_shrinkage", lambda_covmat_regularization=float("nan")),
    dict(method="ledoit_wolf"),
])
def test_covariance_class_matches_jax(spec, returns):
    frame = pd.DataFrame(returns, columns=[f"A{i}" for i in range(6)])
    got = tcov.Covariance(**spec)
    ref = jcov.Covariance(**spec)
    est = got.estimate(frame)
    assert isinstance(est, pd.DataFrame)
    pd.testing.assert_index_equal(est.columns, frame.columns)
    close(est.to_numpy(), ref.estimate(frame).to_numpy())
    F, d = got.factor(frame)
    Fr, dr = ref.factor(frame)
    close(F, Fr)
    close(d, dr)


def test_covariance_repairs_an_indefinite_estimate():
    """check_positive_definite swaps in the eigenvalue-clip projection
    where the estimate is not PSD (a rank-deficient window here)."""
    X = np.random.default_rng(1).standard_normal((4, 8)) * 0.01
    got = tcov.Covariance().estimate_array(torch.as_tensor(X))
    ref = jcov.Covariance().estimate_array(jnp.asarray(X))
    close(got, ref, atol=1e-10)
    assert bool(tpsd.is_psd(got, tol=1e-15))


@pytest.mark.parametrize("spec", [
    dict(), dict(n_mom=60), dict(n_mom=60, n_rev=5, scalefactor=2),
    dict(method="arithmetic", n_mom=30, n_rev=3),
])
def test_mean_estimator_matches_jax(spec, returns):
    frame = pd.DataFrame(returns, columns=[f"A{i}" for i in range(6)])
    got = tmean.MeanEstimator(**spec).estimate(frame)
    ref = jmean.MeanEstimator(**spec).estimate(frame)
    assert isinstance(got, pd.Series)
    close(got.to_numpy(), ref.to_numpy())
    close(tmean.geometric_mean(torch.as_tensor(returns), 50, 2, 1.5),
          jmean.geometric_mean(jnp.asarray(returns), 50, 2, 1.5))


def test_mean_estimator_unknown_method_raises(returns):
    with pytest.raises(NotImplementedError):
        tmean.MeanEstimator(method="median").estimate(returns)
    with pytest.raises(NotImplementedError):
        tcov.Covariance(method="shrunk").estimate(returns)


def test_psd_helpers_match_jax(rng):
    A = rng.standard_normal((6, 6))
    M = A + A.T - 3 * np.eye(6)            # indefinite
    close(tpsd.project_psd(torch.as_tensor(M), 1e-6),
          jpsd.project_psd(jnp.asarray(M), 1e-6), atol=1e-10)
    close(tpsd.nearest_psd(torch.as_tensor(M)),
          jpsd.nearest_psd(jnp.asarray(M)), atol=1e-10)
    for mat in (M, A @ A.T):
        assert bool(tpsd.is_psd(torch.as_tensor(mat))) == bool(
            jpsd.is_psd(jnp.asarray(mat)))
