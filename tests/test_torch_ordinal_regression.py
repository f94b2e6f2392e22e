"""The port's ordinal and linear regressions
(``porqua_tpu_torch/models/ordinal.py``, ``models/regression.py``)
against the JAX package's on the same numpy inputs, f32 on both sides,
and the models package's public names.

The two ordinal fits take different L-BFGS paths (optax's in the JAX
package, ``torch.optim.LBFGS`` with a strong-Wolfe line search in the
port), so they are held at the optimum: coefficients, cutpoints and
probabilities within 2e-3 (1.5e-4 measured on 1,500 x 10 rows; the JAX
package's own test holds its fit to scipy's BFGS at 2e-2) and the
negative log-likelihood within 1e-5 (equal to the last f32 digit
measured)."""

import numpy as np
import pandas as pd
import pytest
import torch

import porqua_tpu.models as jmodels
from porqua_tpu.models import ordinal as jord
from porqua_tpu.models import regression as jreg

import porqua_tpu_torch.models as tmodels
from porqua_tpu_torch.models import ordinal as tord
from porqua_tpu_torch.models import regression as treg

OPT_ATOL = 2e-3
NLL_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_models_names_match_jax():
    assert tmodels.__all__ == jmodels.__all__
    assert treg.__all__ == jreg.__all__
    for name in tmodels.__all__:
        assert getattr(tmodels, name).__module__.startswith(
            "porqua_tpu_torch.models")


@pytest.fixture(scope="module")
def ordinal_rows():
    import chip_smoke

    return chip_smoke.ordinal_data(11, 600, 4, 5)


@pytest.mark.parametrize("distr", ["probit", "logit"])
def test_ordinal_regression_at_the_jax_optimum(distr, ordinal_rows):
    X, y = ordinal_rows
    ref = jord.OrdinalRegression(distr=distr).fit(X, y)
    mine = tord.OrdinalRegression(distr=distr, device="cpu").fit(X, y)
    assert mine.n_classes == ref.n_classes == 5
    assert mine.beta_.dtype == mine.cutpoints_.dtype == np.float32
    np.testing.assert_allclose(mine.beta_, ref.beta_, rtol=0, atol=OPT_ATOL)
    np.testing.assert_allclose(mine.cutpoints_, ref.cutpoints_, rtol=0,
                               atol=OPT_ATOL)
    assert mine.nll_ == pytest.approx(ref.nll_, abs=NLL_ATOL)
    p_ref, p_mine = ref.predict_proba(X[:50]), mine.predict_proba(X[:50])
    np.testing.assert_allclose(p_mine, p_ref, rtol=0, atol=OPT_ATOL)
    np.testing.assert_allclose(p_mine.sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(mine.expected_rank(X[:50]),
                               ref.expected_rank(X[:50]), rtol=0,
                               atol=5 * OPT_ATOL)
    assert (mine.predict(X[:50]) == p_mine.argmax(1)).all()
    assert not torch.backends.cudnn.allow_tf32


def test_ordinal_checks_and_labels():
    with pytest.raises(RuntimeError, match="fit"):
        tord.OrdinalRegression(device="cpu").predict(np.zeros((1, 2)))
    with pytest.raises(ValueError, match="2 ordered classes"):
        tord.OrdinalRegression(device="cpu").fit(np.zeros((3, 2)),
                                                 np.zeros(3, int))
    with pytest.raises(ValueError, match="distr"):
        tord.OrdinalRegression(distr="cauchit", device="cpu").fit(
            np.eye(3), np.arange(3))
    ret = pd.DataFrame(np.random.default_rng(0).standard_normal((4, 30)))
    pd.testing.assert_frame_equal(tord.decile_rank_labels(ret),
                                  jord.decile_rank_labels(ret))


@pytest.fixture(scope="module")
def panel():
    """tests/test_regression.py's linear factor panel, plus a column
    that is the sum of two others (rank 8 of 9)."""
    rng = np.random.default_rng(21)
    X = rng.standard_normal((400, 8))
    y = X @ rng.standard_normal(8) + 0.05 * rng.standard_normal(400)
    return X, np.hstack([X, X[:, :1] + X[:, 1:2]]), y


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("const", [False, True])
def test_ols_matches_jax(panel, deficient, const):
    """Full rank and rank-deficient (the minimum-norm solution through
    the SVD with the JAX package's cut-off): coefficients and
    predictions within 1e-5 of the JAX package's (3.6e-7 measured) and
    of numpy's f64 lstsq to f32 accuracy."""
    X, Xd, y = panel
    A = Xd if deficient else X
    ref = jreg.OLS(add_constant=const).fit(A, y)
    mine = treg.OLS(add_constant=const, device="cpu").fit(A, y)
    assert mine.coef_.dtype == np.float32
    np.testing.assert_allclose(mine.coef_, ref.coef_, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mine.predict(A[:30]), ref.predict(A[:30]),
                               rtol=0, atol=1e-5)
    design = np.hstack([np.ones((len(A), 1)), A]) if const else A
    exact = np.linalg.lstsq(design, y, rcond=None)[0]
    np.testing.assert_allclose(mine.coef_, exact, rtol=0, atol=1e-5)


def test_pca_and_pcaols_match_jax(panel):
    """PCA's components up to a sign per row (neither package fixes it),
    the explained variance ratios and the transform; PCAOLS's
    predictions within 1e-5 of their scale."""
    _, Xd, y = panel
    ref = jreg.PCA(4).fit(Xd)
    mine = treg.PCA(4, device="cpu").fit(Xd)
    sign = np.sign(np.sum(ref.components_ * mine.components_, axis=1))
    assert set(np.abs(sign)) == {1.0}
    np.testing.assert_allclose(sign[:, None] * mine.components_,
                               ref.components_, rtol=0, atol=1e-4)
    np.testing.assert_allclose(mine.explained_variance_ratio_,
                               ref.explained_variance_ratio_, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(mine.transform(Xd[:5]) * sign,
                               ref.transform(Xd[:5]), rtol=0, atol=1e-4)
    want = jreg.PCAOLS(4).fit(Xd, y).predict(Xd)
    got = treg.PCAOLS(4, device="cpu").fit(Xd, y).predict(Xd)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for model in (treg.OLS(), treg.PCA(), treg.PCAOLS()):
        with pytest.raises(RuntimeError, match="fit"):
            (model.transform if isinstance(model, treg.PCA)
             else model.predict)(Xd[:2])


def test_boosted_regression_matches_jax(panel):
    """The same host-side sklearn search in both packages: the same
    parameters chosen, the same CV RMSE and predictions."""
    X, _, y = panel
    grid = {"max_depth": [2, 3], "learning_rate": [0.1], "max_iter": [20]}
    ref = jreg.boosted_regression(X, y, param_grid=grid, cv=2)
    mine = treg.boosted_regression(X, y, param_grid=grid, cv=2)
    assert mine[1] == ref[1] and mine[2] == pytest.approx(ref[2], rel=1e-12)
    np.testing.assert_array_equal(mine[0].predict(X[:20]),
                                  ref[0].predict(X[:20]))
    assert treg.calculate_rmse(y, mine[0].predict(X)) == pytest.approx(
        jreg.calculate_rmse(y, ref[0].predict(X)))
