"""How the dense segment wrapper picks its CUDA kernel, on the CPU.

``admm_segment`` chooses between two hand-written kernels by shape
before it launches: the cluster form (L^-1's packed lower columns over
8 blocks, or K^-1's columns over 16) where a block's slice fits the
card's shared memory and the card can hold such a cluster, else the
streaming form (C read from device memory beside the operator) where
its block of vectors fits, else it raises. ``_library`` is
replaced by the stub of tests/test_torch_cluster_route.py, which
answers the size, limit and occupancy queries from the C layouts
(mirrored in tests/test_torch_cuda.py, which holds the mirror to the C
functions on the card) and records which launcher was called. The file
imports no JAX.
"""

import numpy as np
import pytest
import torch

from porqua_tpu_torch.ops import admm_kernel as tk

from tests.test_torch_cluster_route import (DENSE_FORMS,  # noqa: F401
                                             H100_SMEM, counts_of,
                                             one_launch_of, stub)
from tests.test_torch_cuda import dense_cluster_bytes, dense_stream_bytes


def counts():
    return counts_of(tk.admm_segment)


def zero_inputs(n, m, B=1):
    """Inputs of a dense call in the wrapper's order."""
    f = lambda *s: torch.zeros((B,) + s, dtype=torch.float32)
    # Kinv C q l u lb ub rho rho_b l1w l1c x z w y mu
    return [f(n, n), f(m, n), f(n), f(m), f(m), f(n), f(n), f(m), f(n),
            f(n), f(n), f(n), f(m), f(n), f(m), f(n)]


KW = dict(sigma=1e-6, alpha=1.6, n_iters=25)

# (n, m, triangular, cluster occupancy, expected form)
ROUTES = [
    pytest.param(500, 1, True, 45, "cluster", id="headline-trinv"),
    pytest.param(500, 1, False, 24, "cluster", id="headline-inverse"),
    pytest.param(5, 3, True, 45, "cluster", id="trinv-ranks-without-columns"),
    pytest.param(13, 1, False, 24, "cluster",
                 id="inverse-ranks-without-columns"),
    pytest.param(37, 3, False, 24, "cluster", id="inverse-ragged"),
    pytest.param(500, 1, True, 0, "stream", id="trinv-no-resident-cluster"),
    pytest.param(500, 1, False, 0, "stream",
                 id="inverse-no-resident-cluster"),
    pytest.param(1024, 1, True, 45, "stream", id="trinv-1024"),
    pytest.param(1024, 1, False, 24, "stream", id="inverse-1024"),
    # The service's ladder rungs where C (m x n) would outgrow a block:
    # it stays in device memory, only the vectors in shared memory.
    pytest.param(1024, 128, True, 45, "stream", id="trinv-rung-1024x128"),
    pytest.param(1024, 128, False, 24, "stream", id="inverse-rung-1024x128"),
    pytest.param(512, 512, True, 45, "stream", id="trinv-rung-512x512"),
    pytest.param(512, 512, False, 24, "cluster", id="inverse-rung-512x512"),
    # The corner of the JAX package's dense domain: 1,664 assets (its
    # VMEM estimate's limit) at the ladder's widest 2,048 rows, 175 KB.
    pytest.param(1664, 2048, True, 45, "stream", id="trinv-corner-1664x2048"),
    pytest.param(1664, 2048, False, 24, "stream",
                 id="inverse-corner-1664x2048"),
]


@pytest.mark.parametrize("n, m, triangular, active, form", ROUTES)
def test_dense_form_by_shape(stub, n, m, triangular, active, form):
    stub.active = active
    assert tk.dense_form(n, m, triangular) == form
    cluster = dense_cluster_bytes(n, m, triangular) <= H100_SMEM
    stream = dense_stream_bytes(n, m) <= H100_SMEM
    assert (form == "cluster") == (cluster and active > 0)
    assert (form == "stream") == (stream and form != "cluster")


@pytest.mark.parametrize("n, m, triangular, active, form", ROUTES)
def test_card_path_launches_the_chosen_dense_form(stub, n, m, triangular,
                                                  active, form):
    """The whole card path on stubbed libraries: one launch of the chosen
    form with the problem's dimensions and operator kind, and the
    counters that say so."""
    stub.active = active
    out = tk._dense_on_card(None, zero_inputs(n, m), triangular=triangular,
                            **KW)
    assert [c[0] for c in stub.calls] == [form]
    args = stub.calls[0][1]
    assert args[24:28] == (1, n, m, KW["n_iters"])
    assert args[31] == int(triangular)
    assert counts() == one_launch_of(form, DENSE_FORMS)
    shapes = [tuple(t.shape) for t in out]
    assert shapes == [(1, n), (1, m), (1, n), (1, m), (1, n), (1, n), (1, m),
                      (1, n)]


@pytest.mark.parametrize("triangular", [True, False])
@pytest.mark.parametrize("n, limit", [
    pytest.param(6000, H100_SMEM, id="6000-assets"),
    pytest.param(500, 16 * 1024, id="16KB-card"),
])
def test_no_dense_form_fits_raises(stub, n, limit, triangular):
    stub.limit = limit
    with pytest.raises(ValueError, match="shared memory"):
        tk.dense_form(n, 1, triangular)
    with pytest.raises(ValueError, match="shared memory"):
        tk._dense_on_card(None, zero_inputs(n, 1), triangular=triangular,
                          **KW)
    assert stub.calls == [] and counts() == (0, 0, 0)


@pytest.mark.parametrize("triangular", [True, False])
@pytest.mark.parametrize("form", DENSE_FORMS)
def test_failed_dense_launch_raises_and_counts_nothing(stub, form,
                                                       triangular):
    """A launch the card refuses raises; no other form is tried."""
    stub.rc = 1
    stub.active = 40 if form == "cluster" else 0
    n, m = 500, 1
    with pytest.raises(RuntimeError, match="launch failed"):
        tk._dense_on_card(None, zero_inputs(n, m), triangular=triangular,
                          **KW)
    assert [c[0] for c in stub.calls] == [form]
    assert counts() == (0, 0, 0)


@pytest.mark.parametrize("triangular", [True, False])
def test_failed_dense_occupancy_query_raises(stub, triangular):
    stub.active = -1
    with pytest.raises(RuntimeError, match="occupancy"):
        tk.dense_form(500, 1, triangular)
    with pytest.raises(RuntimeError, match="occupancy"):
        tk._dense_on_card(None, zero_inputs(500, 1), triangular=triangular,
                          **KW)
    assert stub.calls == [] and counts() == (0, 0, 0)


@pytest.mark.parametrize("form", DENSE_FORMS)
def test_named_dense_form_is_launched_as_named(stub, form):
    """The private entry launches the form it is given, whatever the
    shape would choose."""
    inputs = zero_inputs(1024, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        tk._admm_segment_form(form, *inputs, triangular=True, **KW)
    tk._dense_on_card(form, inputs, triangular=True, **KW)
    assert [c[0] for c in stub.calls] == [form]
    assert counts() == one_launch_of(form, DENSE_FORMS)
    with pytest.raises(ValueError, match="no dense kernel form"):
        tk._admm_segment_form("factored", *inputs, **KW)
    with pytest.raises(ValueError, match="no dense kernel form"):
        tk._admm_segment_form("global", *inputs, **KW)


@pytest.mark.parametrize("triangular", [True, False])
def test_dense_cpu_tensors_run_the_twin_and_count_nothing(stub, triangular):
    """CPU tensors go to the plain twin: no library query, no launch,
    no counter."""
    rng = np.random.default_rng(int(triangular))
    B, n, m = 2, 13, 1
    inputs = zero_inputs(n, m, B)
    op = 0.1 * rng.standard_normal((B, n, n)).astype(np.float32)
    inputs[0] = torch.as_tensor(np.tril(op) if triangular else op)
    for i in (11, 13):                  # x w
        inputs[i] = torch.as_tensor(0.1 * rng.standard_normal(
            (B, n)).astype(np.float32))
    for i in (7, 8):                    # rho rho_b
        inputs[i] = torch.full_like(inputs[i], 0.5)
    inputs[5] -= 1.0                    # lb
    inputs[6] += 1.0                    # ub
    out = tk.admm_segment(*inputs, triangular=triangular, **KW)
    ref = tk.admm_segment_ref(*inputs, triangular=triangular, **KW)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert stub.calls == [] and counts() == (0, 0, 0)
