"""The port's LSTM rankers (``porqua_tpu_torch/models/lstm.py``) against
the JAX package's on the same numpy inputs, f32 on both sides: the
windows, NDCG with tied scores, ``LSTMRanker``'s forward from
carried-over Flax weights, ``ReferenceLSTM`` from a Keras archive,
``train_lstm`` from the JAX package's own draws (initial parameters,
minibatch indices, dropout masks), and the Flax ``.msgpack`` files in
both directions."""

import numpy as np
import pandas as pd
import pytest
import jax
import jax.numpy as jnp
import torch

from porqua_tpu.models import lstm as jlstm

from porqua_tpu_torch import convert
from porqua_tpu_torch.models import lstm as tlstm
from tests.test_torch_models import (jax_lstm_draws, keras_archive,
                                     numpy_keras_lstm)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ar1():
    """tests/test_lstm.py's AR(1) universe (400 x 6), float32."""
    rng = np.random.default_rng(7)
    T, n = 400, 6
    phi = np.linspace(0.85, 0.95, n)
    eps = 0.05 * rng.standard_normal((T, n))
    X = np.zeros((T, n))
    for t in range(1, T):
        X[t] = phi * X[t - 1] + eps[t]
    return X.astype(np.float32)


def test_windows_match_jax(ar1):
    for fn in ("make_windows", "reference_lstm_windows"):
        want = getattr(jlstm, fn)(ar1, 10)
        got = getattr(tlstm, fn)(ar1, 10)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="window"):
        tlstm.make_windows(ar1[:10], 10)


@pytest.mark.parametrize("k", [None, 5])
def test_ndcg_matches_jax_with_ties(k):
    """Batched, with tied scores (a stable sort on both sides: ties keep
    their input order) and an all-zero relevance row: equal to 1e-6."""
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 4, (6, 12)).astype(np.float32)
    rel = rng.integers(0, 5, (6, 12)).astype(np.float32)
    rel[2] = 0.0
    want = np.asarray(jlstm.ndcg(jnp.asarray(scores), jnp.asarray(rel), k=k))
    got = tlstm.ndcg(torch.from_numpy(scores), rel, k=k).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[2] == 0.0
    assert float(tlstm.ndcg(np.arange(4.0), np.arange(4.0)[::-1].copy(),
                            device="cpu")) < 1.0
    assert float(tlstm.ndcg(torch.tensor([3.0, 2.0, 1.0, 0.0]),
                            [3.0, 2.0, 1.0, 0.0])) == pytest.approx(1.0)


def _flax_params(n_assets, hidden, T, seed=0):
    module = jlstm.LSTMRanker(n_assets=n_assets, hidden=hidden)
    p = module.init(jax.random.PRNGKey(seed),
                    jnp.zeros((1, T, n_assets), jnp.float32),
                    deterministic=True)["params"]
    return module, jax.tree.map(np.asarray, p)


def test_lstm_ranker_forward_from_flax_weights(ar1):
    """The port's fused ``[i, f, g, o]`` cell from Flax's per-gate
    kernels: predictions within 1e-6 of the JAX module's (3e-8 measured
    on this input), and ``TrainedLSTM.params`` returns Flax's tree."""
    X, _ = tlstm.make_windows(ar1, 10)
    module, p = _flax_params(6, 8, 10, seed=4)
    want = jlstm.TrainedLSTM(module=module, params=jax.tree.map(
        jnp.asarray, p), loss_history=np.zeros(0)).predict(X[:20])
    mine = tlstm.TrainedLSTM(module=tlstm.LSTMRanker(6, 8), params=p)
    got = mine.predict(X[:20])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mine.scores(X[3]), want[3], rtol=0, atol=1e-6)
    back = jax.tree.map(np.asarray, mine.params)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    jax.tree.map(np.testing.assert_array_equal, back, p)


def test_reference_lstm_from_a_keras_archive(tmp_path, ar1):
    """``load_reference_lstm`` in both packages on one Keras archive
    (relu cell scanning the asset axis): predictions within 1e-6 of the
    JAX package's and within 1e-5 of the float64 Keras forward."""
    rng = np.random.default_rng(8)
    H, win, n_out = 5, 10, 6
    arrays = {"W": rng.standard_normal((win, 4 * H)) * 0.3,
              "U": rng.standard_normal((H, 4 * H)) * 0.3,
              "b": rng.standard_normal(4 * H) * 0.1,
              "Wd": rng.standard_normal((H, n_out)),
              "bd": rng.standard_normal(n_out) * 0.01}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    path = str(tmp_path / "ref.keras")
    with open(path, "wb") as fh:
        fh.write(keras_archive(arrays))
    Xr, _ = tlstm.reference_lstm_windows(ar1, win)
    Xr = Xr[:7] * 10.0
    want = jlstm.load_reference_lstm(path).predict(Xr)
    got = tlstm.load_reference_lstm(path, device="cpu")
    assert isinstance(got.module, tlstm.ReferenceLSTM)
    got = got.predict(Xr)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    exact = numpy_keras_lstm(Xr, *(arrays[k].astype(np.float64)
                                   for k in ("W", "U", "b", "Wd", "bd")))
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dropout", [0.2, 0.0])
def test_train_lstm_matches_jax_from_its_draws(ar1, dropout):
    """``train_lstm`` handed what the JAX package's ``train_lstm(seed=3)``
    draws: the per-epoch loss history within 1e-6 relative and the
    predictions within 1e-6 of the JAX run's (1.9e-9 and 3e-8 measured
    with dropout on); with dropout 0 the masks are unused."""
    X, y = tlstm.make_windows(ar1[:200], 10)
    kw = dict(hidden=8, dropout=dropout, epochs=5, batch_size=64,
              learning_rate=3e-3)
    init, idx, masks, _ = jax_lstm_draws(X, kw["hidden"], dropout,
                                         kw["epochs"], kw["batch_size"], 3)
    if dropout:
        assert 0.7 < masks.mean() < 0.9
    ref = jlstm.train_lstm(X, y, seed=3, **kw)
    mine = tlstm.train_lstm(X, y, init_params=init, batch_indices=idx,
                            dropout_masks=masks, device="cpu", **kw)
    assert mine.loss_history.shape == ref.loss_history.shape == (5,)
    np.testing.assert_allclose(mine.loss_history, ref.loss_history,
                               rtol=1e-6)
    np.testing.assert_allclose(mine.predict(X[:20]), ref.predict(X[:20]),
                               rtol=0, atol=1e-6)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_train_lstm_draws_from_a_generator(ar1):
    """Without draws the port takes them from a generator (seeded with
    ``seed`` by default): the same seed trains the same bits, the loss
    falls on the AR(1) data, and the initial recurrent kernels are
    orthogonal per gate as Flax's."""
    X, y = tlstm.make_windows(ar1[:200], 10)
    kw = dict(hidden=8, epochs=20, batch_size=64, learning_rate=3e-3,
              device="cpu")
    a = tlstm.train_lstm(X, y, seed=1, **kw)
    b = tlstm.train_lstm(X, y, generator=torch.Generator().manual_seed(1),
                         **kw)
    np.testing.assert_array_equal(a.loss_history, b.loss_history)
    assert a.loss_history[-1] < 0.7 * a.loss_history[0]
    m = tlstm.LSTMRanker(6, 8)
    m.reset_parameters(torch.Generator().manual_seed(0))
    U = m.kernel_h.detach().numpy()
    for g in range(4):
        Ug = U[:, g * 8:(g + 1) * 8]
        np.testing.assert_allclose(Ug.T @ Ug, np.eye(8), atol=1e-5)
    with pytest.raises(ValueError, match="steps"):
        tlstm.train_lstm(X, y, hidden=8, epochs=1, batch_size=64,
                         batch_indices=np.zeros((1, 64), int), device="cpu")


def test_dropout_mask_is_an_input(ar1):
    """The training forward with an explicit mask scales the kept units
    by 1 / (1 - rate) as Flax's Dropout, equal to the JAX module's
    dropout forward whose mask this is; it never draws one itself."""
    X, _ = tlstm.make_windows(ar1, 10)
    module, p = _flax_params(6, 8, 10, seed=2)
    key = jax.random.PRNGKey(11)
    want, state = module.apply({"params": jax.tree.map(jnp.asarray, p)},
                               jnp.asarray(X[:16]), deterministic=False,
                               rngs={"dropout": key},
                               capture_intermediates=True)
    mask = np.asarray(state["intermediates"]["Dropout_0"]["__call__"][0]) != 0
    mine = tlstm.TrainedLSTM(module=tlstm.LSTMRanker(6, 8), params=p).module
    with torch.no_grad():
        got = mine(torch.from_numpy(X[:16]), deterministic=False,
                   dropout_mask=torch.from_numpy(mask)).numpy()
        with pytest.raises(ValueError, match="dropout_mask"):
            mine(torch.from_numpy(X[:2]), deterministic=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_msgpack_files_both_ways(tmp_path, ar1):
    """A file the port saves is byte for byte the file the JAX package
    saves for the same trained weights (keys sorted, as a trained tree
    comes out of ``jax.tree.map``), and each package loads the
    other's."""
    X, y = tlstm.make_windows(ar1[:120], 10)
    ref = jlstm.train_lstm(X, y, hidden=8, epochs=1, seed=1)
    mine = tlstm.train_lstm(X, y, hidden=8, epochs=1, device="cpu")
    p_jax, p_port = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    ref.save(p_jax)
    mine.save(p_port)
    # The port reads the JAX package's file, and writes it back the same.
    other = tlstm.train_lstm(X[:64], y[:64], hidden=8, epochs=1,
                             device="cpu")
    other.load_params(p_jax)
    np.testing.assert_allclose(other.predict(X[:3]), ref.predict(X[:3]),
                               rtol=0, atol=1e-6)
    p_again = str(tmp_path / "again.msgpack")
    other.save(p_again)
    with open(p_jax, "rb") as a, open(p_again, "rb") as b:
        assert a.read() == b.read()
    # The JAX package reads the port's file.
    ref.load_params(p_port)
    np.testing.assert_allclose(ref.predict(X[:3]), mine.predict(X[:3]),
                               rtol=0, atol=1e-6)
    with pytest.raises(RuntimeError):
        tlstm.TrainedLSTM(module=tlstm.LSTMRanker(6, 4)).load_params(p_port)


def test_lstm_selection_scores_contract(ar1):
    """The bibfn payload: values and a binary top-k column over the
    universe, trained on the named device."""
    class FakeService:
        pass

    bs = FakeService()
    dates = pd.bdate_range("2015-01-01", periods=ar1.shape[0])
    bs.data = {"return_series": pd.DataFrame(
        ar1, index=dates, columns=[f"A{i}" for i in range(6)])}
    out = tlstm.lstm_selection_scores(
        bs, rebdate=str(dates[-1].date()), window=10, train_windows=100,
        epochs=3, hidden=8, top_k=3, device="cpu")
    assert list(out.columns) == ["values", "binary"]
    assert out.shape == (6, 2) and out["binary"].sum() == 3


def test_train_lstm_needs_a_device_without_cuda(ar1, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = tlstm.make_windows(ar1[:40], 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlstm.train_lstm(X, y, hidden=4, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlstm.ndcg(np.ones(3), np.ones(3))


def test_flax_tree_round_trip():
    """``lstm_params_from_flax`` / ``lstm_params_to_flax`` are inverse,
    and the fused gate blocks sit in Flax's ``i, f, g, o`` order."""
    _, p = _flax_params(5, 3, 4, seed=9)
    state = convert.lstm_params_from_flax(p)
    assert state["kernel_i"].shape == (5, 12)
    np.testing.assert_array_equal(state["kernel_h"][:, 6:9].numpy(),
                                  p["OptimizedLSTMCell_0"]["hg"]["kernel"])
    back = convert.lstm_params_to_flax(state)
    jax.tree.map(np.testing.assert_array_equal, back, p)
