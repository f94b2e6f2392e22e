"""How the factored segment wrapper picks its CUDA kernel, on the CPU.

``admm_segment_factored`` chooses between three hand-written kernels by
shape before it launches: the 8-block cluster form where a block's
column slice fits the card's shared memory and the card can hold such a
cluster, else the streaming form where its block fits, else the
device-memory form (the same cluster with the operator, C, Y0 and Ginv
left in device memory) where a block's vector slices fit and its
cluster can be held, else it raises. Here ``_library`` is replaced by a
stub that answers the size, limit and occupancy queries from the C
layouts (mirrored in tests/test_torch_cuda.py, which holds the mirror
to the C functions on the card) and records which launcher was called.

``test_every_plan_kernel_shape_has_a_form`` holds the port's domain to
the JAX package's: at every rung of the service's default ladder where
``porqua_tpu/qp/admm.py::_segment_plan`` takes its Pallas kernel
without a VMEM footprint warning, the port chooses a form and launches
it. It is the one test here that imports JAX.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

from porqua_tpu_torch.ops import admm_kernel as tk
from porqua_tpu_torch.serve.bucketing import DEFAULT_M_RUNGS, DEFAULT_N_RUNGS

from tests.test_torch_cuda import (H100_SMEM, cluster_bytes,  # noqa: F401
                                   cluster_global_bytes, dense_cluster_bytes,
                                   dense_cluster_ranks, dense_stream_bytes,
                                   dense_tail_bytes, dense_tail_rows,
                                   stream_bytes)

FORMS = ("cluster", "stream", "global")
DENSE_FORMS = ("cluster", "tail", "stream")


class StubLibrary:
    """The three kernel libraries at once: sizes, rank counts and the
    tail's resident rows from the layouts above at the given limit, the
    cluster occupancies as given (``active`` for the cluster forms and
    the dense tail, ``global_active`` for the factored device-memory
    form), and a log of launches."""

    def __init__(self, active=40, limit=H100_SMEM, rc=0, global_active=40):
        self.active, self.limit, self.rc = active, limit, rc
        self.global_active = global_active
        self.calls = []

    def porqua_max_smem_optin(self):
        return self.limit

    def porqua_admm_cluster_smem_bytes(self, n, m, k, refine):
        return cluster_bytes(n, m, k, refine)

    def porqua_admm_cluster_max_active(self, n, m, k, refine):
        return self.active

    def porqua_admm_cluster_global_smem_bytes(self, n, m, k, refine):
        return cluster_global_bytes(n, m, k, refine)

    def porqua_admm_cluster_global_max_active(self, n, m, k, refine):
        return self.global_active

    def porqua_admm_segment_smem_bytes(self, factored, n, m, k):
        return stream_bytes(n, m, k) if factored else dense_stream_bytes(n, m)

    def porqua_admm_dense_cluster_ranks(self, n, m, triangular):
        return dense_cluster_ranks(n, m, bool(triangular), self.limit)

    def porqua_admm_dense_cluster_smem_bytes(self, n, m, triangular):
        return dense_cluster_bytes(n, m, bool(triangular), self.limit)

    def porqua_admm_dense_cluster_max_active(self, n, m, triangular):
        return self.active

    def porqua_admm_dense_tail_rows(self, n, m, triangular):
        return dense_tail_rows(n, m, bool(triangular), self.limit)

    def porqua_admm_dense_tail_smem_bytes(self, n, m, triangular):
        return dense_tail_bytes(n, m, bool(triangular), self.limit)

    def porqua_admm_dense_tail_max_active(self, n, m, triangular):
        return self.active if dense_tail_rows(
            n, m, bool(triangular), self.limit) >= 0 else 0

    def porqua_admm_segment_dense_cluster(self, *args):
        self.calls.append(("cluster", args))
        return self.rc

    def porqua_admm_segment_dense_tail(self, *args):
        self.calls.append(("tail", args))
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

    def porqua_admm_segment_factored_global(self, *args):
        self.calls.append(("global", args))
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
        monkeypatch.setattr(f, "launches", 0)
        for form in forms_of(f):
            monkeypatch.setattr(f, f"{form}_launches", 0)
    return lib


def forms_of(f):
    """The kernel forms of a wrapper, in the router's order."""
    return DENSE_FORMS if f is tk.admm_segment else FORMS


def counts_of(f):
    """A wrapper's launches, then its launches per form."""
    return (f.launches,) + tuple(getattr(f, f"{form}_launches")
                                 for form in forms_of(f))


def counts():
    return counts_of(tk.admm_segment_factored)


def one_launch_of(form, forms=FORMS):
    """The counters after one launch of ``form`` from zero."""
    return (1,) + tuple(int(form == f) for f in forms)


def zero_inputs(n, m, k, B=1):
    """Inputs of a factored call in the wrapper's order."""
    f = lambda *s: torch.zeros((B,) + s, dtype=torch.float32)
    # W inv_d Y0 Ginv V Dv C q l u lb ub rho rho_b l1w l1c x z w y mu
    return [f(k, n), f(n), f(n, m), f(m, m), f(k, n), f(n), f(m, n), f(n),
            f(m), f(m), f(n), f(n), f(m), f(n), f(n), f(n), f(n), f(m),
            f(n), f(m), f(n)]


KW = dict(sigma=1e-6, alpha=1.6, n_iters=35)

# (n, m, k, refine, cluster occupancy, shared-memory limit, expected form)
ROUTES = [
    pytest.param(500, 1, 252, 0, 40, H100_SMEM, "cluster",
                 id="headline-refine0"),
    pytest.param(500, 1, 252, 1, 16, H100_SMEM, "cluster",
                 id="headline-refine1"),
    pytest.param(500, 1, 252, 2, 16, H100_SMEM, "cluster",
                 id="headline-refine2"),
    pytest.param(5, 3, 24, 1, 40, H100_SMEM, "cluster",
                 id="ranks-without-columns"),
    pytest.param(500, 1, 252, 1, 0, H100_SMEM, "stream",
                 id="no-resident-cluster"),
    pytest.param(512, 1, 1024, 0, 40, H100_SMEM, "stream", id="long-window"),
    pytest.param(2048, 1, 256, 0, 40, H100_SMEM, "stream", id="wide-2048"),
    # The sketch-fed 5,000-asset north star: W's slice (256 x 625
    # floats) and the streaming form's n-vectors and Y0 (about 21 n
    # floats) are above the limit; the vector slices alone are not.
    pytest.param(5000, 1, 256, 0, 40, H100_SMEM, "global", id="sketch-5000"),
    pytest.param(1024, 128, 252, 0, 40, H100_SMEM, "global",
                 id="rung-1024x128"),
    pytest.param(2048, 8, 252, 1, 40, H100_SMEM, "global",
                 id="rung-2048x8-refine1"),
    # On a card with 32 KB a block, the headline shape fits neither the
    # cluster form (75 KB) nor the streaming one (43 KB), but the
    # device-memory form's 9.5 KB.
    pytest.param(500, 1, 252, 0, 40, 32 * 1024, "global", id="32KB-card"),
]


@pytest.mark.parametrize("n, m, k, refine, active, limit, form", ROUTES)
def test_factored_form_by_shape(stub, n, m, k, refine, active, limit, form):
    stub.active, stub.limit = active, limit
    assert tk.factored_form(n, m, k, refine) == form
    cluster = cluster_bytes(n, m, k, refine) <= limit and active > 0
    stream = stream_bytes(n, m, k) <= limit
    assert (form == "cluster") == cluster
    assert (form == "stream") == (stream and not cluster)
    assert (form == "global") == (not cluster and not stream)
    assert cluster_global_bytes(n, m, k, refine) <= limit


@pytest.mark.parametrize("n, m, k, refine, active, limit, form", ROUTES)
def test_card_path_launches_the_chosen_form(stub, n, m, k, refine, active,
                                            limit, form):
    """The whole card path on stubbed libraries: one launch of the chosen
    form with the problem's dimensions, and the counters that say so."""
    stub.active, stub.limit = active, limit
    inputs = zero_inputs(n, m, k)
    out = tk._factored_on_card(None, inputs, refine_steps=refine, **KW)
    assert [c[0] for c in stub.calls] == [form]
    args = stub.calls[0][1]
    assert args[29:34] == (1, n, m, k, KW["n_iters"])
    assert args[37] == refine
    assert counts() == one_launch_of(form)
    shapes = [tuple(t.shape) for t in out]
    assert shapes == [(1, n), (1, m), (1, n), (1, m), (1, n), (1, n), (1, m),
                      (1, n)]


@pytest.mark.parametrize("n, k, limit, global_active", [
    # Each rank's slices of the n-vectors alone (7,500 columns) exceed
    # a block.
    pytest.param(60000, 1, H100_SMEM, 40, id="60000-assets"),
    pytest.param(500, 252, 4 * 1024, 40, id="4KB-card"),
    pytest.param(5000, 256, H100_SMEM, 0, id="sketch-5000-no-resident-cluster"),
])
def test_no_form_fits_raises(stub, n, k, limit, global_active):
    stub.limit, stub.global_active = limit, global_active
    with pytest.raises(ValueError, match="shared memory"):
        tk.factored_form(n, 1, k, 0)
    with pytest.raises(ValueError, match="shared memory"):
        tk._factored_on_card(None, zero_inputs(n, 1, k), refine_steps=0,
                             **KW)
    assert stub.calls == [] and counts() == (0, 0, 0, 0)


# form -> (n, k, cluster occupancy) of a shape that routes to it
ROUTED_TO = {"cluster": (500, 252, 40), "stream": (500, 252, 0),
             "global": (5000, 256, 40)}


@pytest.mark.parametrize("form", FORMS)
def test_failed_launch_raises_and_counts_nothing(stub, form):
    """A launch the card refuses raises; no other form is tried."""
    n, k, stub.active = ROUTED_TO[form]
    stub.rc = 1
    with pytest.raises(RuntimeError, match="launch failed"):
        tk._factored_on_card(None, zero_inputs(n, 1, k), refine_steps=0,
                             **KW)
    assert [c[0] for c in stub.calls] == [form]
    assert counts() == (0, 0, 0, 0)


def test_failed_occupancy_query_raises(stub):
    stub.active = -1
    with pytest.raises(RuntimeError, match="occupancy"):
        tk.factored_form(500, 1, 252, 0)
    assert stub.calls == []


def test_failed_global_occupancy_query_raises(stub):
    """The device-memory form's occupancy query, at the sketch shape."""
    stub.global_active = -1
    with pytest.raises(RuntimeError, match="occupancy"):
        tk.factored_form(5000, 1, 256, 0)
    assert stub.calls == []


@pytest.mark.parametrize("form", FORMS)
def test_named_form_is_launched_as_named(stub, form):
    """The private entry launches the form it is given, whatever the
    shape would choose."""
    inputs = zero_inputs(500, 1, 252)
    with pytest.raises(ValueError, match="CUDA device"):
        tk._admm_segment_factored_form(form, *inputs, **KW)
    tk._factored_on_card(form, inputs, refine_steps=0, **KW)
    assert [c[0] for c in stub.calls] == [form]
    assert counts() == one_launch_of(form)
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
    assert stub.calls == [] and counts() == (0, 0, 0, 0)


def jax_plan_takes_kernel(n, m, k, refine, linsolve):
    """Whether the JAX package's ``_segment_plan(warn=True)`` runs its
    Pallas kernel (``backend="pallas"``, f32) at this shape without a
    VMEM footprint warning. The problem is a stand-in of shapes only:
    the plan reads no values."""
    import jax
    import jax.numpy as jnp
    from porqua_tpu.qp.admm import SolverParams, _segment_plan
    from porqua_tpu.qp.canonical import CanonicalQP

    f = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)
    qp = CanonicalQP(P=f(n, n), q=f(n), C=f(m, n), l=f(m), u=f(m), lb=f(n),
                     ub=f(n), var_mask=f(n), row_mask=f(m), constant=f(),
                     Pf=f(k, n) if linsolve == "woodbury" else None)
    params = SolverParams(backend="pallas", linsolve=linsolve,
                          woodbury_refine=refine)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plan = _segment_plan(qp, params, warn=True)
    footprint = any("VMEM footprint" in str(w.message) for w in caught)
    return plan.use_pallas and not footprint


# (linsolve, k, refine): the dense kinds, and the factored operator at a
# 24-day window, a year, the sketch's 256 rows and two years.
DOMAIN = ([("trinv", 0, 0), ("inverse", 0, 0)]
          + [("woodbury", k, r) for k in (24, 252, 256, 504) for r in (0, 1)])
# Shapes each family's grid must include (the gap the port had).
MUST_INCLUDE = {("trinv", 0, 0): [(1024, 128), (512, 512)],
                ("inverse", 0, 0): [(1024, 128), (512, 512)],
                ("woodbury", 252, 0): [(2048, 8), (2048, 512), (1024, 128)],
                ("woodbury", 252, 1): [(2048, 8)],
                ("woodbury", 256, 0): [(5000, 1)]}


@pytest.mark.parametrize("linsolve, k, refine", DOMAIN,
                         ids=[f"{ls}-k{k}-r{r}" if ls == "woodbury" else ls
                              for ls, k, r in DOMAIN])
def test_every_plan_kernel_shape_has_a_form(stub, linsolve, k, refine):
    """At every rung (n, m) of the port's copy of the default ladder (and
    at the 5,000-asset sketch shape for k = 256, refine 0) where the JAX
    plan takes its Pallas kernel with no footprint warning, the port's
    router returns a form and the card path launches it once. Shapes
    the JAX plan refuses are not asked of the port."""
    shapes = [(n, m) for n in DEFAULT_N_RUNGS for m in DEFAULT_M_RUNGS]
    if (linsolve, k, refine) == ("woodbury", 256, 0):
        shapes.append((5000, 1))
    taken = [s for s in shapes if jax_plan_takes_kernel(*s, k, refine,
                                                        linsolve)]
    assert set(MUST_INCLUDE.get((linsolve, k, refine), [])) <= set(taken)
    for n, m in taken:
        before = len(stub.calls)
        if linsolve == "woodbury":
            form = tk.factored_form(n, m, k, refine)
            tk._factored_on_card(None, zero_inputs(n, m, k),
                                 refine_steps=refine, **KW)
            wrapper = tk.admm_segment_factored
        else:
            triangular = linsolve == "trinv"
            form = tk.dense_form(n, m, triangular)
            f = lambda *s: torch.zeros((1,) + s, dtype=torch.float32)
            vn, vm = f(n), f(m)
            # Kinv C q l u lb ub rho rho_b l1w l1c x z w y mu
            inputs = [f(n, n), f(m, n), vn, vm, vm, vn, vn, vm, vn, vn, vn,
                      vn, vm, vn, vm, vn]
            tk._dense_on_card(None, inputs, triangular=triangular, **KW)
            wrapper = tk.admm_segment
        assert form in forms_of(wrapper), (n, m, form)
        assert [c[0] for c in stub.calls[before:]] == [form], (n, m)
    assert counts_of(wrapper)[0] == len(taken)
