"""The port's data loader (a host copy) against the JAX package's, on
CSV and pickle files the test writes (the MSCI data is not in the
repo): the frames must be equal."""

import pickle

import numpy as np
import pandas as pd
import pytest

from porqua_tpu import data_loader as jdl
from porqua_tpu_torch import data_loader as tdl


def write_frame(path, index, values, columns, sep=","):
    frame = pd.DataFrame(values, index=index, columns=columns)
    frame.index.name = "Dates"
    frame.to_csv(path, sep=sep)


def dates(fmt, n=6):
    return [d.strftime(fmt) for d in pd.bdate_range("2021-03-01", periods=n)]


@pytest.mark.parametrize("sep", [",", ";"])
def test_load_data_msci_matches(tmp_path, sep):
    """dd-mm-yyyy returns of 30 countries (24 kept) and the benchmark,
    with one row whose date does not parse (dropped by both)."""
    rng = np.random.default_rng(3)
    idx = dates("%d-%m-%Y") + ["not a date"]
    write_frame(tmp_path / "msci_country_indices.csv", idx,
                rng.standard_normal((7, 30)) * 0.01,
                [f"C{i}" for i in range(30)], sep)
    write_frame(tmp_path / "NDDLWI.csv", idx, rng.standard_normal((7, 1)),
                ["NDDLWI"], sep)
    port = tdl.load_data_msci(path=str(tmp_path))
    ref = jdl.load_data_msci(path=str(tmp_path))
    assert sorted(port) == sorted(ref) == ["bm_series", "return_series"]
    for k in port:
        pd.testing.assert_frame_equal(port[k], ref[k])
    assert port["return_series"].shape == (6, 24)
    port12 = tdl.load_data_msci(path=str(tmp_path), n=12)
    pd.testing.assert_frame_equal(port12["return_series"],
                                  jdl.load_data_msci(path=str(tmp_path),
                                                     n=12)["return_series"])


def test_load_data_sptr_matches(tmp_path):
    """dd/mm/yyyy dates (the SPTR layout)."""
    rng = np.random.default_rng(4)
    write_frame(tmp_path / "SPTR.csv", dates("%d/%m/%Y", 9),
                rng.standard_normal((9, 1)), ["SPTR"])
    port = tdl.load_data_sptr(path=str(tmp_path))
    pd.testing.assert_frame_equal(port, jdl.load_data_sptr(path=str(tmp_path)))
    assert isinstance(port.index, pd.DatetimeIndex) and len(port) == 9


def test_load_pickle_matches(tmp_path, capsys):
    obj = {"a": [1, 2, 3], "b": np.arange(4)}
    with open(tmp_path / "obj.pkl", "wb") as f:
        pickle.dump(obj, f)
    (tmp_path / "empty.pkl").write_bytes(b"")
    (tmp_path / "junk.pkl").write_bytes(b"not a pickle")
    got = tdl.load_pickle("obj.pkl", path=str(tmp_path))
    ref = jdl.load_pickle("obj.pkl", path=str(tmp_path))
    assert got["a"] == ref["a"] and np.array_equal(got["b"], ref["b"])
    for name in ("empty.pkl", "junk.pkl", "missing.pkl"):
        assert tdl.load_pickle(name, path=str(tmp_path)) is None
        assert jdl.load_pickle(name, path=str(tmp_path)) is None
