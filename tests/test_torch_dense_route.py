"""How the dense segment wrapper picks its CUDA kernel, on the CPU.

``admm_segment`` chooses between three hand-written kernels by shape
before it launches: the cluster form (L^-1's packed lower columns over
8 blocks, else over 16, or K^-1's columns over 16) where a block's
slice fits the card's shared memory and the card can hold such a
cluster, else (K^-1) the cluster with a streamed tail where its
resident rows, C's slice and the vectors fit, else the streaming form
(C read from device memory beside the operator) where its block of
vectors fits, else it raises. ``_library`` is
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
from tests.test_torch_cuda import (dense_cluster_bytes, dense_stream_bytes,
                                   dense_tail_bytes)


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
    # 1,024 assets: a rank's share of L^-1 fits at 16 ranks, not 8; a
    # 16th of K^-1 does not fit, so its first 725 rows stay resident.
    pytest.param(1024, 1, True, 7, "cluster", id="trinv-1024"),
    pytest.param(1024, 1, False, 7, "tail", id="inverse-1024"),
    # The service's wide ladder rungs: L^-1 on 16 ranks, K^-1 with 520
    # of each rank's 1,024 rows resident (1,024 x 128); at 512 x 512 both
    # fit on 16 ranks.
    pytest.param(1024, 128, True, 7, "cluster", id="trinv-rung-1024x128"),
    pytest.param(1024, 128, False, 7, "tail", id="inverse-rung-1024x128"),
    pytest.param(512, 512, True, 7, "cluster", id="trinv-rung-512x512"),
    pytest.param(512, 512, False, 24, "cluster", id="inverse-rung-512x512"),
    # The corner of the JAX package's dense domain: 1,664 assets (its
    # VMEM estimate's limit) at the ladder's widest 2,048 rows, 175 KB
    # for the one-block form; the clusters' receive buffers alone (2
    # ranks x m floats) are above the limit.
    pytest.param(1664, 2048, True, 45, "stream", id="trinv-corner-1664x2048"),
    pytest.param(1664, 2048, False, 24, "stream",
                 id="inverse-corner-1664x2048"),
]


@pytest.mark.parametrize("n, m, triangular, active, form", ROUTES)
def test_dense_form_by_shape(stub, n, m, triangular, active, form):
    stub.active = active
    assert tk.dense_form(n, m, triangular) == form
    cluster = dense_cluster_bytes(n, m, triangular) <= H100_SMEM
    tail = dense_tail_bytes(n, m, triangular) <= H100_SMEM
    stream = dense_stream_bytes(n, m) <= H100_SMEM
    assert (form == "cluster") == (cluster and active > 0)
    assert (form == "tail") == (tail and active > 0 and not cluster)
    assert (form == "stream") == (stream and form not in ("cluster", "tail"))


@pytest.mark.parametrize("n, m, triangular, active, form", ROUTES)
def test_card_path_launches_the_chosen_dense_form(stub, n, m, triangular,
                                                  active, form):
    """The whole card path on stubbed libraries: one launch of the chosen
    form with the problem's dimensions, its layout argument (the
    cluster's rank count and the tail's resident rows: by shape) and
    operator kind, and the counters that say so."""
    stub.active = active
    out = tk._dense_on_card(None, zero_inputs(n, m), triangular=triangular,
                            **KW)
    assert [c[0] for c in stub.calls] == [form]
    args = stub.calls[0][1]
    assert args[24:28] == (1, n, m, KW["n_iters"])
    assert args[-2] == int(triangular)
    assert len(args) == 33 + (form != "stream")
    if form != "stream":
        assert args[28] == -1
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
    assert stub.calls == [] and counts() == (0, 0, 0, 0)


# form -> (n, cluster occupancy) of an inverse shape that routes to it
DENSE_ROUTED_TO = {"cluster": (500, 40), "tail": (1024, 40),
                   "stream": (500, 0)}


@pytest.mark.parametrize("triangular", [True, False])
@pytest.mark.parametrize("form", DENSE_FORMS)
def test_failed_dense_launch_raises_and_counts_nothing(stub, form,
                                                       triangular):
    """A launch the card refuses raises; no other form is tried. (No
    L^-1 shape routes to the tail form, which holds K^-1 only: L^-1 is
    launched there by name.)"""
    stub.rc = 1
    n, stub.active = DENSE_ROUTED_TO[form]
    named = form if (form, triangular) == ("tail", True) else None
    with pytest.raises(RuntimeError, match="launch failed"):
        tk._dense_on_card(named, zero_inputs(n, 1), triangular=triangular,
                          **KW)
    assert [c[0] for c in stub.calls] == [form]
    assert counts() == (0, 0, 0, 0)


@pytest.mark.parametrize("triangular", [True, False])
def test_failed_dense_occupancy_query_raises(stub, triangular):
    stub.active = -1
    with pytest.raises(RuntimeError, match="occupancy"):
        tk.dense_form(500, 1, triangular)
    with pytest.raises(RuntimeError, match="occupancy"):
        tk._dense_on_card(None, zero_inputs(500, 1), triangular=triangular,
                          **KW)
    assert stub.calls == [] and counts() == (0, 0, 0, 0)


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
    # A forced layout reaches the launcher; a form takes only its own.
    if form != "stream":
        forced = {"cluster": 16, "tail": 300}[form]
        tk._dense_on_card(form, inputs, triangular=True, layout=forced, **KW)
        assert stub.calls[-1][1][28] == forced
    with pytest.raises(ValueError, match="takes no"):
        tk._admm_segment_form(form, *inputs, **KW,
                              **({"rows": 3} if form != "tail"
                                 else {"ranks": 16}))


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
    assert stub.calls == [] and counts() == (0, 0, 0, 0)
