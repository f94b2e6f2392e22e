"""The port's ML selection models (``porqua_tpu_torch/models/``) against
the JAX package's on the same numpy inputs, f32 on both sides: the rank
labels, the pairwise loss, ``PairwiseRanker`` and
``ltr_selection_scores`` from the same initial parameters, the LTR
builder; and the golden that ``chip_smoke.py``'s phase 12 holds the
card against, written here on XLA-CPU, with phase 12 rehearsed on the
CPU at a small size. The LSTM tests are in ``tests/test_torch_lstm.py``,
the ordinal and linear regressions in
``tests/test_torch_ordinal_regression.py``.

The JAX ranker draws its initial parameters with ``jax.random`` inside
``fit`` (``porqua_tpu/models/ltr.py::_init_mlp``), in float64 under
this suite's ``jax_enable_x64``; the tests hand both sides the same
float32 arrays by monkeypatching ``_init_mlp`` (the JAX package is not
edited).

Regenerate the golden and the shipped ranker's npz (XLA-CPU; about
three minutes, the 12 rankers' f32 and f64 fits at 520 assets
dominating):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_models.py --write-golden
"""

import dataclasses
import io
import json
import os
import sys
import tempfile
import types
import zipfile

import numpy as np
import pandas as pd
import pytest
import jax
import jax.numpy as jnp
import torch

import porqua_tpu as rj
from porqua_tpu import builders as jb
from porqua_tpu.batch import run_batch as jax_run_batch
from porqua_tpu.models import labels as jlabels
from porqua_tpu.models import lstm as jlstm
from porqua_tpu.models import ltr as jltr
from porqua_tpu.models import ordinal as jord
from porqua_tpu.models import regression as jreg
from porqua_tpu.qp import SolverParams as JaxParams

import porqua_tpu_torch as pt
from porqua_tpu_torch import builders as tb
from porqua_tpu_torch.models import labels as tlabels
from porqua_tpu_torch.models import ltr as tltr
from porqua_tpu_torch.synthetic import (synthetic_usa_np, usa_benchmark_np,
                                        usa_rebdates)
from tests.test_torch_backtest import USA_CONFIGS, usa_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_ROOT, "porqua_tpu_torch", "testdata", "ml_golden.npz")
ARTIFACT = os.path.join(_ROOT, "model", "lstm_msci_flax.msgpack")
ARTIFACT_NPZ = os.path.join(_ROOT, "porqua_tpu_torch", "testdata",
                            "lstm_msci.npz")

# Phase 12's configuration. ltr: examples/backtest_usa.py configuration
# 1 at full width, the first 12 rebalance dates, the reference's LTR
# settings; lstm: the shipped ranker's shape (24 assets, hidden 32,
# window 100); ref: the reference's Keras architecture (hidden 50).
FULL = dict(
    ltr=dict(n_days=1500, n_assets=520, n_dates=12, top_k=260,
             train_dates=12, horizon=21, epochs=300, early_epochs=25,
             width=252, upper=0.05, seed=2024),
    lstm=dict(seed=3, n_days=400, n_assets=24, window=100, n_windows=50),
    lstm_train=dict(window=100, seed=0, kwargs=dict(
        hidden=32, dropout=0.2, epochs=4, batch_size=128,
        learning_rate=1e-3)),
    ref=dict(window=100, hidden=50, seed=5),
    ordinal=dict(seed=11, n=1500, d=10, n_classes=10, n_proba=200),
    regression=dict(n_components=3, n_pred=1000),
)
SMALL = dict(
    ltr=dict(n_days=600, n_assets=40, n_dates=2, top_k=20, train_dates=1,
             horizon=21, epochs=20, early_epochs=5, width=60, upper=0.2,
             seed=2024),
    lstm=dict(seed=3, n_days=130, n_assets=24, window=100, n_windows=5),
    lstm_train=dict(window=10, seed=0, kwargs=dict(
        hidden=8, dropout=0.2, epochs=2, batch_size=32,
        learning_rate=1e-3)),
    ref=dict(window=20, hidden=8, seed=5),
    ordinal=dict(seed=11, n=300, d=3, n_classes=4, n_proba=20),
    regression=dict(n_components=2, n_pred=50),
)


def he_params(rng, sizes):
    """The JAX package's ``_init_mlp`` distribution, drawn with numpy in
    float32: He-normal weights, zero biases."""
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(
        np.float32), "b": np.zeros(b, np.float32)}
        for a, b in zip(sizes[:-1], sizes[1:])]


class jax_init:
    """Context: the JAX ranker's ``_init_mlp`` returns ``params`` (a
    callable of nothing, or a list) as ``dtype`` arrays."""

    def __init__(self, params, dtype=jnp.float32):
        self.params, self.dtype = params, dtype

    def __enter__(self):
        self.saved = jltr._init_mlp
        get = self.params if callable(self.params) else lambda: self.params
        jltr._init_mlp = lambda key, sizes: [
            {k: jnp.asarray(v, self.dtype) for k, v in layer.items()}
            for layer in get()]
        return self

    def __exit__(self, *exc):
        jltr._init_mlp = self.saved


# ---------------------------------------------------------------------
# labels, the pairwise loss, the ranker
# ---------------------------------------------------------------------

@pytest.mark.parametrize("ascending", [True, False])
def test_rank_labels_match_jax(ascending):
    """Series (NaNs dropped) and DataFrame (rows ranked, nullable Int64
    with NaNs, plain int without) input: equal values and dtypes."""
    rng = np.random.default_rng(1)
    s = pd.Series(rng.standard_normal(37), index=[f"a{i}" for i in range(37)])
    s.iloc[[3, 11]] = np.nan
    df = pd.DataFrame(rng.standard_normal((5, 23)))
    df_nan = df.copy()
    df_nan.iloc[1, 4] = np.nan
    for x in (s, df, df_nan):
        for bins in (10, 4):
            want = jlabels.rank_labels(x, n_bins=bins, ascending=ascending)
            got = tlabels.rank_labels(x, n_bins=bins, ascending=ascending)
            assert type(got) is type(want)
            if isinstance(want, pd.Series):
                pd.testing.assert_series_equal(got, want)
            else:
                pd.testing.assert_frame_equal(got, want)


def test_pairwise_loss_matches_jax_with_a_padded_slot():
    """Per group, batched over 3 groups (the JAX package's vmap), with a
    padded slot carrying an absurd score and label: equal to f32
    rounding (1e-6 relative), and the padded slot changes nothing."""
    rng = np.random.default_rng(2)
    scores = rng.standard_normal((3, 9)).astype(np.float32)
    labels = rng.integers(0, 4, (3, 9)).astype(np.float32)
    mask = np.ones((3, 9), np.float32)
    mask[:, -1] = 0.0
    scores[:, -1], labels[:, -1] = 99.0, 7.0
    want = np.asarray(jax.vmap(jltr.pairwise_logistic_loss)(
        jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(mask)))
    got = tltr.pairwise_logistic_loss(*(torch.from_numpy(a) for a in (
        scores, labels, mask))).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    bare = tltr.pairwise_logistic_loss(*(torch.from_numpy(a[:, :-1]) for a in
                                         (scores, labels, mask))).numpy()
    np.testing.assert_allclose(got, bare, rtol=1e-6)
    assert float(tltr.pairwise_logistic_loss(
        torch.tensor([3.0, 0.0, -3.0]), torch.tensor([2.0, 1.0, 0.0]),
        torch.ones(3))) < 0.1


def _groups(rng, n_groups=4, n=30, n_feat=3):
    truth = rng.standard_normal(n_feat)
    out = []
    for g in range(n_groups):
        k = n - 3 * g   # groups of different sizes: padded slots
        X = rng.standard_normal((k, n_feat)).astype(np.float32)
        y = (X @ truth + 0.3 * rng.standard_normal(k)).argsort().argsort()
        out.append((X, (y * 10 // k).astype(np.float32)))
    return out


def test_pairwise_ranker_matches_jax_from_the_same_parameters():
    """``fit`` and ``predict`` from the same f32 initial parameters: the
    per-epoch losses, every weight and the centred held-out scores
    within 2e-5 of the JAX ranker's over 25 epochs. The output bias is
    not compared: a pairwise loss sees scores only through differences,
    so its gradient is zero and each package's f32 gradient of it is
    rounding noise, which Adam's normalised step turns into steps of up
    to the learning rate (it shifts every score alike and no ranking).
    Longer runs drift apart in every weight as well (phase 12's golden
    measures that at the real size). The standardisation is the same
    numpy code, bit for bit."""
    rng = np.random.default_rng(3)
    groups = _groups(rng)
    init = he_params(np.random.default_rng(4), (3, 32, 1))
    X_new = rng.standard_normal((17, 3)).astype(np.float32)
    with jax_init(init):
        ref = jltr.PairwiseRanker(epochs=25).fit(groups)
    mine = tltr.PairwiseRanker(epochs=25, device="cpu").fit(
        groups, init_params=init)
    for a, b in zip(ref._norm, mine._norm):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(mine._losses.numpy(), np.asarray(ref._losses),
                               rtol=2e-5, atol=0)
    for a, b in zip(ref.params, mine.params):
        np.testing.assert_allclose(b["w"].numpy(), np.asarray(a["w"]),
                                   rtol=0, atol=2e-5)
    np.testing.assert_allclose(mine.params[0]["b"].numpy(),
                               np.asarray(ref.params[0]["b"]), rtol=0,
                               atol=2e-5)
    want, got = ref.predict(X_new), mine.predict(X_new)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got - got.mean(), want - want.mean(), rtol=0,
                               atol=2e-5 * np.abs(want).max())
    # Without parameters the port draws its own, from a generator.
    g1 = tltr.PairwiseRanker(epochs=3, device="cpu").fit(
        groups, generator=torch.Generator().manual_seed(7)).predict(X_new)
    g2 = tltr.PairwiseRanker(epochs=3, device="cpu").fit(
        groups, generator=torch.Generator().manual_seed(7)).predict(X_new)
    np.testing.assert_array_equal(g1, g2)
    with pytest.raises(ValueError, match="widths"):
        tltr.PairwiseRanker(epochs=1, device="cpu").fit(
            groups, init_params=he_params(rng, (4, 32, 1)))


def ltr_market(rng, n_assets=12, n_dates=10):
    """tests/test_models.py's market: monthly feature cross-sections
    where the feature ``signal`` predicts returns."""
    assets = [f"S{i}" for i in range(n_assets)]
    days = pd.bdate_range("2022-01-03", periods=n_dates * 21 + 42)
    skill = rng.standard_normal(n_assets) * 0.002
    returns = pd.DataFrame(
        rng.standard_normal((len(days), n_assets)) * 0.005 + skill,
        index=days, columns=assets)
    frames = {d: pd.DataFrame({
        "signal": skill + rng.standard_normal(n_assets) * 1e-4,
        "noise": rng.standard_normal(n_assets)}, index=assets)
        for d in days[::21][:n_dates]}
    return returns, pd.concat(frames, axis=0), days[::21][:n_dates]


def test_ltr_service_selects_what_jax_selects(monkeypatch):
    """A BacktestService with ``bibfn_selection_ltr`` (top_k 4) in each
    package, the same f32 initial parameters: the centred scores (see
    the ranker's test) within 1e-4 of their scale (60 epochs) and the same four assets selected; the
    port's ranker trains on the builder's ``device``, and without one
    and without a card it raises."""
    returns, features, dates = ltr_market(np.random.default_rng(42))
    rebdate = str(dates[-1].date())
    init = he_params(np.random.default_rng(9), (2, 32, 1))

    def service(pkg, bld, **kw):
        return pkg.BacktestService(
            data={"return_series": returns, "features": features},
            selection_item_builders={"ltr": pkg.SelectionItemBuilder(
                bibfn=bld.bibfn_selection_ltr, top_k=4, epochs=60, **kw)},
            optimization_item_builders={},
            optimization=pkg.EmptyOptimization(),
            settings={"rebdates": [rebdate]})

    ref = service(rj, jb)
    with jax_init(init):
        ref.build_selection(rebdate)
    mine = service(pt, tb, device="cpu",
                   init_params=lambda d, sizes: init)
    mine.build_selection(rebdate)
    want, got = ref.selection.filtered["ltr"], mine.selection.filtered["ltr"]
    assert list(got.columns) == ["values", "binary"]
    centred = lambda v: v - v.mean()
    np.testing.assert_allclose(centred(got["values"]),
                               centred(want["values"]), rtol=0,
                               atol=1e-4 * want["values"].abs().max())
    pd.testing.assert_series_equal(got["binary"], want["binary"])
    assert list(mine.selection.selected) == list(ref.selection.selected)
    assert len(mine.selection.selected) == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.bibfn_selection_ltr(mine, rebdate, top_k=4, epochs=1)


def test_usa_features_definition():
    """The feature panel: one cross-section per month end with 252 days
    of history, five columns, each the stated trailing statistic."""
    import chip_smoke

    X, _ = synthetic_usa_np(n_days=400, n_assets=6)
    F = chip_smoke.usa_features(X)
    dates = F.index.get_level_values(0).unique()
    assert list(F.columns) == ["ret21", "ret63", "ret126", "ret252", "vol63"]
    d = dates[0]
    t = X.index.get_loc(d)
    assert t + 1 >= 252 and X.index[t + 1].month != d.month
    R = X.to_numpy()
    row = F.xs(d, level=0)
    np.testing.assert_allclose(row["ret63"], np.prod(1 + R[t - 62:t + 1], 0)
                               - 1, rtol=1e-12)
    np.testing.assert_allclose(row["vol63"], R[t - 62:t + 1].std(0, ddof=1),
                               rtol=1e-12)


# ---------------------------------------------------------------------
# The golden of chip_smoke.py's phase 12
# ---------------------------------------------------------------------

def jax_lstm_draws(X, hidden, dropout, epochs, batch_size, seed):
    """What the JAX package's ``train_lstm(..., seed=seed)`` draws
    (``porqua_tpu/models/lstm.py:102-151``), replayed outside its jit:
    the initial parameters (numpy tree), each step's minibatch indices
    (``jax.random.choice`` without replacement), each step's dropout key
    and mask (Flax's Dropout output over its input, read with
    ``capture_intermediates``; the mask depends on the key and the
    shape only)."""
    X = jnp.asarray(X, jnp.float32)
    n_samples, _, n_assets = X.shape
    module = jlstm.LSTMRanker(n_assets=n_assets, hidden=hidden,
                              dropout=dropout)
    key, init_key = jax.random.split(jax.random.PRNGKey(seed))
    params = module.init(init_key, X[:1], deterministic=True)["params"]
    batch_size = min(batch_size, n_samples)
    n_steps = max(1, epochs * (n_samples // batch_size))
    keys = jax.random.split(key, 2 * n_steps)
    idx = np.stack([np.asarray(jax.random.choice(
        k, n_samples, (batch_size,), replace=False)) for k in keys[:n_steps]])
    @jax.jit
    def kept(xb, dk):
        _, state = module.apply({"params": params}, xb, deterministic=False,
                                rngs={"dropout": dk},
                                capture_intermediates=True)
        return state["intermediates"]["Dropout_0"]["__call__"][0] != 0

    masks = [np.asarray(kept(X[idx[s]], dk))
             for s, dk in enumerate(keys[n_steps:])]
    return (jax.tree.map(np.asarray, params), idx, np.stack(masks),
            keys[n_steps:])


def lstm64(n_assets, hidden, dropout):
    """The JAX package's ``LSTMRanker`` with float64 parameters and carry
    (its own keeps the carry in float32, which a float64 scan rejects):
    the same layers and parameter names."""
    import flax.linen as nn

    class LSTMRanker64(nn.Module):
        @nn.compact
        def __call__(self, x, *, deterministic=True):
            h = nn.RNN(nn.OptimizedLSTMCell(
                hidden, param_dtype=jnp.float64))(x)[:, -1, :]
            h = nn.Dropout(dropout, deterministic=deterministic)(h)
            return nn.Dense(n_assets, param_dtype=jnp.float64)(h)

    return LSTMRanker64()


def jax_train_f64(X, y, params, idx, drop_keys, hidden, dropout, epochs,
                  batch_size, learning_rate):
    """``train_lstm``'s loop in float64 with the JAX package's module and
    optax's Adam, on the same draws (:func:`lstm64`): the f64 twin of
    the f32 run."""
    import optax

    X = jnp.asarray(X, jnp.float64)
    y = jnp.asarray(y, jnp.float64)
    module = lstm64(X.shape[2], hidden, dropout)
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    tx = optax.adam(learning_rate)
    opt = tx.init(p)

    @jax.jit
    def step(p, opt, xb, yb, dk):
        def loss_fn(p):
            pred = module.apply({"params": p}, xb, deterministic=False,
                                rngs={"dropout": dk})
            return jnp.mean((pred - yb) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, updates), opt, loss

    losses = []
    for s in range(idx.shape[0]):
        p, opt, loss = step(p, opt, X[idx[s]], y[idx[s]], drop_keys[s])
        losses.append(float(loss))
    losses = np.asarray(losses).reshape(epochs, -1).mean(axis=1)
    return module, p, losses


def numpy_keras_lstm(X, W, U, b, Wd, bd):
    """tests/test_lstm.py's float64 forward with Keras semantics (gates
    i, f, c, o; relu cell activation)."""
    H = U.shape[0]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    outs = []
    for x_seq in X.astype(np.float64):
        h = np.zeros(H)
        c = np.zeros(H)
        for t in range(x_seq.shape[0]):
            z = x_seq[t] @ W + h @ U + b
            i, f, g, o = z[:H], z[H:2 * H], z[2 * H:3 * H], z[3 * H:]
            c = sig(f) * c + sig(i) * np.maximum(g, 0.0)
            h = sig(o) * np.maximum(c, 0.0)
        outs.append(h @ Wd + bd)
    return np.stack(outs)


def keras_archive(arrays) -> bytes:
    """A ``.keras`` zip holding ``model.weights.h5`` with the LSTM and
    Dense variables at the paths the reference's file uses."""
    import h5py

    h5 = io.BytesIO()
    with h5py.File(h5, "w") as f:
        for name, key in (("layers/lstm/cell/vars/0", "W"),
                          ("layers/lstm/cell/vars/1", "U"),
                          ("layers/lstm/cell/vars/2", "b"),
                          ("layers/dense/vars/0", "Wd"),
                          ("layers/dense/vars/1", "bd")):
            f.create_dataset(name, data=arrays[key])
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as z:
        z.writestr("model.weights.h5", h5.getvalue())
    return out.getvalue()


def flat(tree, prefix=""):
    """The flat ``a/b/c`` keys of a nested parameter tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def jax_ltr_service(X, bm, rebdates, lm, features, bibfn):
    """chip_smoke.usa_service in the JAX package."""
    O = rj.OptimizationItemBuilder
    return rj.BacktestService(
        data={"return_series": X, "bm_series": bm, "features": features},
        selection_item_builders={
            "data": rj.SelectionItemBuilder(bibfn=jb.bibfn_selection_data),
            "ltr": rj.SelectionItemBuilder(bibfn=bibfn)},
        optimization_item_builders={
            "returns": O(bibfn=jb.bibfn_return_series, width=lm["width"]),
            "bm": O(bibfn=jb.bibfn_bm_series, width=lm["width"], align=True),
            "budget": O(bibfn=jb.bibfn_budget_constraint),
            "box": O(bibfn=jb.bibfn_box_constraints, upper=lm["upper"])},
        optimization=rj.LeastSquares(),
        settings={"rebdates": rebdates, "quiet": True})


def write_artifact(path=ARTIFACT_NPZ):
    """``model/lstm_msci_flax.msgpack`` as read by Flax, flat keys."""
    from flax import serialization

    with open(ARTIFACT, "rb") as fh:
        tree = serialization.msgpack_restore(fh.read())
    np.savez_compressed(path, **flat(tree))


def write_golden(path=GOLDEN, sizes=FULL):
    """Run every part of phase 12 through the JAX package on XLA-CPU in
    f32, beside its float64 twin (the JAX ranker and LSTM in f64, the
    plain run_batch in f64, numpy's f64 Keras forward, scipy's f64 BFGS
    at the ordinal optimum), and save what the phase reads."""
    import scipy.optimize

    import chip_smoke

    out = {}
    meta = dict(sizes, platform=jax.default_backend())

    # ltr_usa: the ranker per date, then run_batch on its selection.
    lm = sizes["ltr"]
    X, _ = synthetic_usa_np(n_days=lm["n_days"], n_assets=lm["n_assets"])
    bm = usa_benchmark_np(X)
    rebdates = usa_rebdates(X.index)[:lm["n_dates"]]
    feats = chip_smoke.usa_features(X)
    holder = types.SimpleNamespace(data={"return_series": X,
                                         "features": feats})
    rng = np.random.default_rng(lm["seed"])
    n_feat = feats.shape[1]
    inits = [he_params(rng, (n_feat, 32, 1)) for _ in rebdates]
    frames, scores = {}, {np.float32: [], np.float64: []}
    kw = dict(top_k=lm["top_k"], train_dates=lm["train_dates"],
              horizon=lm["horizon"], epochs=lm["epochs"])
    for d, init in zip(rebdates, inits):
        for dtype in scores:
            with jax_init(init, dtype):
                df = jltr.ltr_selection_scores(holder, d, **kw)
            scores[dtype].append(df["values"].reindex(X.columns).to_numpy())
            if dtype is np.float32:
                frames[d] = df
    for i, layer in enumerate(zip(*inits)):
        out[f"ltr/w{i}"] = np.stack([p["w"] for p in layer])
        out[f"ltr/b{i}"] = np.stack([p["b"] for p in layer])
    out["ltr/scores"] = np.stack(scores[np.float32])
    out["ltr/scores_f64"] = np.stack(scores[np.float64])
    assert out["ltr/scores"].dtype == np.float32
    out["ltr/binary"] = np.stack([frames[d]["binary"].reindex(X.columns)
                                  .to_numpy() for d in rebdates])
    # The same rankers after their first epochs: scores and losses.
    for dtype, tag in ((np.float32, ""), (np.float64, "_f64")):
        early_scores, early_losses = [], []
        for d, init in zip(rebdates, inits):
            with jax_init(init, dtype), \
                    chip_smoke.fitted_rankers(jltr) as fitted:
                df = jltr.ltr_selection_scores(
                    holder, d, **{**kw, "epochs": lm["early_epochs"]})
            early_scores.append(df["values"].reindex(X.columns).to_numpy())
            early_losses.append(np.asarray(fitted[0]._losses))
        out[f"ltr/early_scores{tag}"] = np.stack(early_scores)
        out[f"ltr/early_losses{tag}"] = np.stack(early_losses)
    assert out["ltr/early_losses"].dtype == np.float32
    cached = lambda bs, rebdate, **kw: frames[rebdate]

    def weights(bt):
        return (bt.strategy.get_weights_df().reindex(
            index=rebdates, columns=X.columns).fillna(0.0).to_numpy(float))

    for name in USA_CONFIGS:
        params = usa_params(name, backend="xla")
        out[f"{name}/params"] = json.dumps(dataclasses.asdict(
            JaxParams(**params)))
        for tag, polish, dtype in (("weights", True, jnp.float32),
                                   ("weights_nopolish", False, jnp.float32),
                                   ("weights_nopolish_f64", False,
                                    jnp.float64)):
            bt = jax_run_batch(
                jax_ltr_service(X, bm, rebdates, lm, feats, cached),
                JaxParams(**{**params, "polish": polish}), dtype=dtype)
            out[f"{name}/{tag}"] = weights(bt)
            if tag == "weights":
                out[f"{name}/status"] = bt.output["batch"]["status"]
                out[f"{name}/iters"] = bt.output["batch"]["iters"]

    # lstm_msci: the shipped ranker on the series' last windows.
    sm = sizes["lstm"]
    R = chip_smoke.lstm_series(sm["seed"], sm["n_days"], sm["n_assets"])
    Xw, yw = jlstm.make_windows(R, sm["window"])
    Xm, ym = Xw[-sm["n_windows"]:], yw[-sm["n_windows"]:]
    tree = chip_smoke.tree_of(np.load(ARTIFACT_NPZ), "")
    module = jlstm.LSTMRanker(n_assets=sm["n_assets"],
                              hidden=tree["Dense_0"]["kernel"].shape[0])
    params = jax.tree.map(jnp.asarray, tree)
    out["msci/pred"] = jlstm.TrainedLSTM(
        module=module, params=params, loss_history=np.zeros(0)).predict(Xm)
    out["msci/pred_f64"] = np.asarray(lstm64(sm["n_assets"], module.hidden,
                                             0.0).apply(
        {"params": jax.tree.map(lambda a: a.astype(jnp.float64), params)},
        jnp.asarray(Xm, jnp.float64)))
    rel = np.argsort(np.argsort(ym, axis=1), axis=1).astype(np.float32)
    out["msci/ndcg"] = np.asarray(jlstm.ndcg(out["msci/pred"], rel, k=10))

    # lstm_train: train_lstm from its own draws, which are saved.
    tm = sizes["lstm_train"]
    Xt, yt = jlstm.make_windows(R, tm["window"])
    k = tm["kwargs"]
    init, idx, masks, drop_keys = jax_lstm_draws(
        Xt, k["hidden"], k["dropout"], k["epochs"], k["batch_size"],
        tm["seed"])
    res = jlstm.train_lstm(Xt, yt, seed=tm["seed"], **k)
    out.update(flat(init, "train/init/"))
    out["train/idx"], out["train/masks"] = idx, masks
    out["train/loss"] = res.loss_history
    out["train/pred"] = res.predict(Xt[-sm["n_windows"]:])
    module, p64, out["train/loss_f64"] = jax_train_f64(
        Xt, yt, init, idx, drop_keys, **k)
    out["train/pred_f64"] = np.asarray(module.apply(
        {"params": p64}, jnp.asarray(Xt[-sm["n_windows"]:], jnp.float64)))

    # ReferenceLSTM through load_reference_lstm on a Keras archive.
    rm = sizes["ref"]
    r = np.random.default_rng(rm["seed"])
    H, win, n_out = rm["hidden"], rm["window"], sm["n_assets"]
    arrays = {"W": r.standard_normal((win, 4 * H)) * 0.5 / np.sqrt(win),
              "U": r.standard_normal((H, 4 * H)) * 0.5 / np.sqrt(H),
              "b": r.standard_normal(4 * H) * 0.1,
              "Wd": r.standard_normal((H, n_out)) / np.sqrt(H),
              "bd": r.standard_normal(n_out) * 0.01}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    blob = keras_archive(arrays)
    Xr, _ = jlstm.reference_lstm_windows(R, win)
    Xr = Xr[-sm["n_windows"]:]
    with tempfile.TemporaryDirectory() as tmp:
        kpath = os.path.join(tmp, "ref.keras")
        with open(kpath, "wb") as fh:
            fh.write(blob)
        out["ref/pred"] = jlstm.load_reference_lstm(kpath).predict(Xr)
    out["ref/pred_f64"] = numpy_keras_lstm(Xr, *(arrays[k].astype(np.float64)
                                                 for k in ("W", "U", "b",
                                                           "Wd", "bd")))
    out.update({f"ref/{k}": v for k, v in arrays.items()})

    # ordinal: both likelihoods at the optimum, beside scipy's f64 one.
    om = sizes["ordinal"]
    Xo, yo = chip_smoke.ordinal_data(om["seed"], om["n"], om["d"],
                                     om["n_classes"])
    for distr in ("probit", "logit"):
        fit = jord.OrdinalRegression(distr=distr).fit(Xo, yo)
        p = f"ord/{distr}/"
        out[p + "beta"], out[p + "cutpoints"] = fit.beta_, fit.cutpoints_
        out[p + "nll"] = np.float64(fit.nll_)
        out[p + "proba"] = fit.predict_proba(Xo[:om["n_proba"]])
        raw0 = np.concatenate([fit.cutpoints_[:1],
                               np.log(np.diff(fit.cutpoints_))])
        opt = scipy.optimize.minimize(
            ordinal_nll64, np.concatenate([fit.beta_, raw0]).astype(float),
            args=(Xo.astype(np.float64), yo, om["n_classes"], distr),
            method="BFGS", options=dict(gtol=1e-10, maxiter=2000))
        d = om["d"]
        out[p + "beta_f64"] = opt.x[:d]
        out[p + "cutpoints_f64"] = np.concatenate([
            opt.x[d:d + 1], opt.x[d] + np.cumsum(np.exp(opt.x[d + 1:]))])

    # regression: the USA monthly panel.
    gm = sizes["regression"]
    P, yp = chip_smoke.usa_panel(X, feats)
    for tag, design in (("full", P), ("deficient",
                                      np.hstack([P, P[:, :1] + P[:, 1:2]]))):
        ols = jreg.OLS(add_constant=True).fit(design, yp)
        out[f"reg/ols_{tag}"] = ols.coef_
        out[f"reg/ols_{tag}_pred"] = ols.predict(design[:gm["n_pred"]])
    pca = jreg.PCA(gm["n_components"]).fit(P)
    out["reg/pca"], out["reg/pca_evr"] = (pca.components_,
                                          pca.explained_variance_ratio_)
    out["reg/pcaols_pred"] = jreg.PCAOLS(gm["n_components"]).fit(
        P, yp).predict(P[:gm["n_pred"]])
    out["meta"] = json.dumps(meta)
    np.savez_compressed(path, **out)
    return out


def ordinal_nll64(theta, X, y, K, distr):
    """The ordered model's mean negative log-likelihood in float64 with
    the statsmodels cutpoint transform (tests/test_ordinal.py's
    independent implementation)."""
    import scipy.stats

    d = X.shape[1]
    beta, raw = theta[:d], theta[d:]
    cuts = np.concatenate([raw[:1], raw[0] + np.cumsum(np.exp(raw[1:]))])
    F = (scipy.stats.norm.cdf if distr == "probit"
         else lambda z: 1.0 / (1.0 + np.exp(-z)))
    cdf = F(cuts[None, :] - (X @ beta)[:, None])
    upper = np.concatenate([cdf, np.ones((len(X), 1))], axis=1)
    lower = np.concatenate([np.zeros((len(X), 1)), cdf], axis=1)
    p = (upper - lower)[np.arange(len(X)), y]
    return -np.mean(np.log(np.clip(p, 1e-300, None)))


def test_lstm_msci_npz_equals_the_flax_artifact():
    """The committed npz holds exactly the arrays Flax reads from
    ``model/lstm_msci_flax.msgpack``, and the port's own msgpack reader
    gives the same tree."""
    import chip_smoke
    from flax import serialization

    from porqua_tpu_torch import convert

    with open(ARTIFACT, "rb") as fh:
        data = fh.read()
    want = flat(serialization.msgpack_restore(data))
    got = np.load(ARTIFACT_NPZ)
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == np.float32
        np.testing.assert_array_equal(got[k], v)
    mine = flat(convert.flax_msgpack_restore(data))
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(mine[k], v)
    assert flat(chip_smoke.tree_of(got, "")).keys() == want.keys()


def test_write_golden_and_rehearse_phase12_at_a_small_size(tmp_path,
                                                           monkeypatch):
    """The --write-golden mode end to end at a small size (every array
    phase 12 reads, with its shape and dtype), then phase 12 on the CPU
    against that golden: every check passes but the launch count of each
    run_batch config, which only the card can meet. One test, so the
    golden's JAX compiles run once."""
    import chip_smoke

    path = str(tmp_path / "ml.npz")
    write_golden(path, SMALL)
    g = np.load(path)
    lm = SMALL["ltr"]
    for k in ("scores", "scores_f64", "binary", "early_scores",
              "early_scores_f64"):
        assert g[f"ltr/{k}"].shape == (lm["n_dates"], lm["n_assets"])
    for k in ("early_losses", "early_losses_f64"):
        assert g[f"ltr/{k}"].shape == (lm["n_dates"], lm["early_epochs"])
    assert (g["ltr/binary"].sum(1) == lm["top_k"]).all()
    assert g["ltr/w0"].shape == (lm["n_dates"], 5, 32)
    for name in USA_CONFIGS:
        assert g[f"{name}/weights_nopolish_f64"].shape == (lm["n_dates"],
                                                          lm["n_assets"])
        assert (g[f"{name}/status"] == 1).all()
    assert g["train/masks"].dtype == bool
    assert g["train/loss"].shape == g["train/loss_f64"].shape == (2,)
    assert g["msci/pred"].shape == (5, 24) and g["ref/pred"].shape == (5, 24)

    monkeypatch.setattr(chip_smoke, "ML_PATH", path)
    monkeypatch.setattr(chip_smoke, "kernel_row", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "FAILURES", [])
    rows = {("trinv", "cluster"): {"name": "k2"},
            ("woodbury_refine1", "cluster"): {"name": "k1"}}
    added = chip_smoke.ml_phase(rows, lambda: None, device="cpu")
    assert added == [("ltr_trinv", "cluster"), ("ltr_woodbury", "cluster")]
    failed = chip_smoke.FAILURES
    assert len(failed) == 2 and all("launched" in f for f in failed), failed


if __name__ == "__main__":
    if "--write-golden" not in sys.argv:
        sys.exit("usage: python tests/test_torch_models.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, _ROOT)
    write_artifact()
    write_golden()
