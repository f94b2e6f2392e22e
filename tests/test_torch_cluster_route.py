"""How the factored segment wrapper picks its CUDA kernel, on the CPU.

``admm_segment_factored`` chooses between two hand-written kernels by
shape before it launches: the 8-block cluster form where a block's
column slice fits the card's shared memory and the card can hold such a
cluster, else the streaming form where its block fits, else it raises.
Here ``_library`` is replaced by a stub that answers the size, limit
and occupancy queries from the C layouts (mirrored in
tests/test_torch_cuda.py, which holds the mirror to the C functions on
the card) and records which launcher was called. The file imports no
JAX.
"""

import contextlib

import numpy as np
import pytest
import torch

from porqua_tpu_torch.ops import admm_kernel as tk

from tests.test_torch_cuda import (cluster_bytes, dense_cluster_bytes,
                                   dense_stream_bytes, stream_bytes)

# cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100.
H100_SMEM = 232448


class StubLibrary:
    """The three kernel libraries at once: sizes from the layouts above,
    the limit and the cluster occupancy as given, and a log of
    launches."""

    def __init__(self, active=40, limit=H100_SMEM, rc=0):
        self.active, self.limit, self.rc = active, limit, rc
        self.calls = []

    def porqua_max_smem_optin(self):
        return self.limit

    def porqua_admm_cluster_smem_bytes(self, n, m, k, refine):
        return cluster_bytes(n, m, k, refine)

    def porqua_admm_cluster_max_active(self, n, m, k, refine):
        return self.active

    def porqua_admm_segment_smem_bytes(self, factored, n, m, k):
        return stream_bytes(n, m, k) if factored else dense_stream_bytes(n, m)

    def porqua_admm_dense_cluster_smem_bytes(self, n, m, triangular):
        return dense_cluster_bytes(n, m, bool(triangular))

    def porqua_admm_dense_cluster_max_active(self, n, m, triangular):
        return self.active

    def porqua_admm_segment_dense_cluster(self, *args):
        self.calls.append(("cluster", args))
        return self.rc

    def porqua_admm_segment_dense(self, *args):
        self.calls.append(("stream", args))
        return self.rc

    def porqua_admm_segment_factored_cluster(self, *args):
        self.calls.append(("cluster", args))
        return self.rc

    def porqua_admm_segment_factored(self, *args):
        self.calls.append(("stream", args))
        return self.rc

    def porqua_cuda_error_string(self, rc):
        return b"stub error"


@pytest.fixture
def stub(monkeypatch):
    """Install a StubLibrary in place of the built libraries, and run
    the card path on CPU tensors (no device switch, stream handle 0)."""
    lib = StubLibrary()
    monkeypatch.setattr(tk, "_library", lambda name=tk._LIB: lib)
    monkeypatch.setattr(tk, "_on_card",
                        lambda device: contextlib.nullcontext(0))
    for f in (tk.admm_segment_factored, tk.admm_segment):
        for name in ("launches", "cluster_launches", "stream_launches"):
            monkeypatch.setattr(f, name, 0)
    return lib


def counts():
    f = tk.admm_segment_factored
    return f.launches, f.cluster_launches, f.stream_launches


def zero_inputs(n, m, k, B=1):
    """Inputs of a factored call in the wrapper's order."""
    f = lambda *s: torch.zeros((B,) + s, dtype=torch.float32)
    # W inv_d Y0 Ginv V Dv C q l u lb ub rho rho_b l1w l1c x z w y mu
    return [f(k, n), f(n), f(n, m), f(m, m), f(k, n), f(n), f(m, n), f(n),
            f(m), f(m), f(n), f(n), f(m), f(n), f(n), f(n), f(n), f(m),
            f(n), f(m), f(n)]


KW = dict(sigma=1e-6, alpha=1.6, n_iters=35)

# (n, m, k, refine, cluster occupancy, expected form)
ROUTES = [
    pytest.param(500, 1, 252, 0, 40, "cluster", id="headline-refine0"),
    pytest.param(500, 1, 252, 1, 16, "cluster", id="headline-refine1"),
    pytest.param(500, 1, 252, 2, 16, "cluster", id="headline-refine2"),
    pytest.param(5, 3, 24, 1, 40, "cluster", id="ranks-without-columns"),
    pytest.param(500, 1, 252, 1, 0, "stream", id="no-resident-cluster"),
    pytest.param(512, 1, 1024, 0, 40, "stream", id="long-window"),
    pytest.param(2048, 1, 256, 0, 40, "stream", id="wide-2048"),
]


@pytest.mark.parametrize("n, m, k, refine, active, form", ROUTES)
def test_factored_form_by_shape(stub, n, m, k, refine, active, form):
    stub.active = active
    assert tk.factored_form(n, m, k, refine) == form
    fits = cluster_bytes(n, m, k, refine) <= H100_SMEM
    assert (form == "cluster") == (fits and active > 0)


@pytest.mark.parametrize("n, m, k, refine, active, form", ROUTES)
def test_card_path_launches_the_chosen_form(stub, n, m, k, refine, active,
                                            form):
    """The whole card path on stubbed libraries: one launch of the chosen
    form with the problem's dimensions, and the counters that say so."""
    stub.active = active
    inputs = zero_inputs(n, m, k)
    out = tk._factored_on_card(None, inputs, refine_steps=refine, **KW)
    assert [c[0] for c in stub.calls] == [form]
    args = stub.calls[0][1]
    assert args[29:34] == (1, n, m, k, KW["n_iters"])
    assert args[37] == refine
    assert counts() == (1, int(form == "cluster"), int(form == "stream"))
    shapes = [tuple(t.shape) for t in out]
    assert shapes == [(1, n), (1, m), (1, n), (1, m), (1, n), (1, n), (1, m),
                      (1, n)]


@pytest.mark.parametrize("n, k, limit", [
    pytest.param(60000, 1, H100_SMEM, id="60000-assets"),
    pytest.param(5000, 256, H100_SMEM, id="sketch-5000"),
    pytest.param(500, 252, 32 * 1024, id="32KB-card"),
])
def test_no_form_fits_raises(stub, n, k, limit):
    stub.limit = limit
    with pytest.raises(ValueError, match="shared memory"):
        tk.factored_form(n, 1, k, 0)
    with pytest.raises(ValueError, match="shared memory"):
        tk._factored_on_card(None, zero_inputs(n, 1, k), refine_steps=0,
                             **KW)
    assert stub.calls == [] and counts() == (0, 0, 0)


@pytest.mark.parametrize("form", ["cluster", "stream"])
def test_failed_launch_raises_and_counts_nothing(stub, form):
    """A launch the card refuses raises; the other form is not tried."""
    stub.rc = 1
    stub.active = 40 if form == "cluster" else 0
    with pytest.raises(RuntimeError, match="launch failed"):
        tk._factored_on_card(None, zero_inputs(500, 1, 252), refine_steps=0,
                             **KW)
    assert [c[0] for c in stub.calls] == [form]
    assert counts() == (0, 0, 0)


def test_failed_occupancy_query_raises(stub):
    stub.active = -1
    with pytest.raises(RuntimeError, match="occupancy"):
        tk.factored_form(500, 1, 252, 0)
    assert stub.calls == []


@pytest.mark.parametrize("form", ["cluster", "stream"])
def test_named_form_is_launched_as_named(stub, form):
    """The private entry launches the form it is given, whatever the
    shape would choose."""
    inputs = zero_inputs(500, 1, 252)
    with pytest.raises(ValueError, match="CUDA device"):
        tk._admm_segment_factored_form(form, *inputs, **KW)
    tk._factored_on_card(form, inputs, refine_steps=0, **KW)
    assert [c[0] for c in stub.calls] == [form]
    with pytest.raises(ValueError, match="no factored kernel form"):
        tk._admm_segment_factored_form("dense", *inputs, **KW)


@pytest.mark.parametrize("refine", [0, 1])
def test_cpu_tensors_run_the_twin_and_count_nothing(stub, refine):
    """CPU tensors go to the plain twin: no library query, no launch,
    no counter."""
    rng = np.random.default_rng(refine)
    B, n, m, k = 2, 13, 1, 6
    inputs = zero_inputs(n, m, k, B)
    for i in (0, 4, 16, 18):            # W V x w
        inputs[i] = torch.as_tensor(0.1 * rng.standard_normal(
            tuple(inputs[i].shape)).astype(np.float32))
    for i in (1, 5, 12, 13):            # inv_d Dv rho rho_b
        inputs[i] = torch.full_like(inputs[i], 0.5)
    inputs[10] -= 1.0                   # lb
    inputs[11] += 1.0                   # ub
    out = tk.admm_segment_factored(*inputs, refine_steps=refine, **KW)
    ref = tk.admm_segment_factored_ref(*inputs, refine_steps=refine, **KW)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert stub.calls == [] and counts() == (0, 0, 0)
