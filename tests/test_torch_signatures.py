"""The port's public signatures against the JAX package's, and the calls
that the JAX package's scripts and serving path make, run on the port.

For every module of ``porqua_tpu/`` and its counterpart in
``porqua_tpu_torch/``, each public function and each public method (and
``__init__``) of each public class defined there is compared by
``inspect.signature``: a call written for the JAX package must bind the
same way in the port. So the reference's positional parameters come
first, in order and by name; every reference parameter is there, of the
same kind, with a default where the reference has one (and the same
default where both are plain constants); and a parameter the port adds
has a default and is keyword-only or placed after the reference's. The
named exceptions are the intended ones (ROADMAP section C): explicit
draws for ``key``, ``counted`` for ``compiled``, the numpy twins of
``synthetic_universe``, Flax's ``parent``/``name`` fields, and the op
traces that stand for jaxprs and HLO. An exception that no longer
matches a difference fails too, so the list stays true.
"""

import importlib
import inspect
import os
import warnings

import numpy as np
import pytest
import torch

from porqua_tpu import checkpoint as jck
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.canonical import stack_qps as jax_stack_qps

import porqua_tpu_torch as pt
from porqua_tpu_torch import checkpoint as tck
from porqua_tpu_torch.optimization import Optimization
from porqua_tpu_torch.qp.canonical import stack_qps

from tests.test_torch_checkpoint import (JaxParams, assert_bit_identical,
                                         jax_solve_qp_batch, random_parts)

HERE = os.path.dirname(os.path.abspath(__file__))
JAX_PKG = os.path.join(os.path.dirname(HERE), "porqua_tpu")

_DRAWS = "takes explicit draws (a torch.Generator or arrays) for the key"
_COUNTED = "takes the counted op trace for the compiled XLA executable"
_OP_TRACE = "the port's op trace stands for the jaxpr or the HLO module"
_FLAX = ("a torch module: Flax's parent/name fields give way to the "
         "input width")
# module -> {public name (Class.method for a method): why it differs}
EXCEPTIONS = {
    "tracking": {"synthetic_universe": "jax.random draws; the port has "
                 "the numpy twins (synthetic_universe_np)"},
    "qp.canonical": {"sketch_rows": _DRAWS},
    "qp.sketch": {"count_sketch": _DRAWS, "gram_rel_err": _DRAWS},
    "models.lstm": {"train_lstm": _DRAWS, "LSTMRanker.__init__": _FLAX,
                    "ReferenceLSTM.__init__": _FLAX},
    "obs.devprof": {name: _COUNTED for name in (
        "executable_cost", "executable_memory", "hlo_fingerprint",
        "cost_record")},
    "analysis.contracts": {name: _OP_TRACE for name in (
        "check_closed_jaxpr", "solve_batch_jaxpr", "serve_entry_jaxpr",
        "tracking_jaxpr", "compaction_step_jaxpr", "continuous_jaxprs",
        "run_batch_jaxpr")},
    "analysis.hlolint": {name: _OP_TRACE for name in (
        "HloInstruction", "HloComputation", "HloModule", "parse_hlo",
        # GC202's fusion-body size: an op trace has no fusion bodies
        "LintConfig.__init__", "check_redundant_materialization")},
    "analysis.lint": {name: "the AST lint reads torch code: no jnp or "
                      "jax.jit idiom to match" for name in (
                          "ModuleInfo.is_jnp_attr", "ModuleInfo.mentions_jnp",
                          "ModuleInfo.is_jit_constructor")},
}


def mirrored_modules():
    """Dotted names, relative to the package, of every module of the
    JAX package ('' for the package itself)."""
    out = []
    for root, dirs, names in os.walk(JAX_PKG):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(names):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, name), JAX_PKG)
                parts = rel[:-3].split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                out.append(".".join(parts))
    return out


_SIMPLE = (type(None), bool, int, float, str)
_P = inspect.Parameter
_POSITIONAL = (_P.POSITIONAL_ONLY, _P.POSITIONAL_OR_KEYWORD)


def _plain(v):
    return isinstance(v, _SIMPLE) or (
        isinstance(v, tuple) and all(isinstance(x, _SIMPLE) for x in v))


def signature_faults(ref, port):
    """Where a call written for ``ref`` (an inspect.Signature) would bind
    differently to ``port``, or fail."""
    faults = []
    rp, pp = list(ref.parameters.values()), list(port.parameters.values())
    rpos = [p for p in rp if p.kind in _POSITIONAL]
    ppos = [p for p in pp if p.kind in _POSITIONAL]
    for i, p in enumerate(rpos):
        if i >= len(ppos) or ppos[i].name != p.name:
            got = ppos[i].name if i < len(ppos) else None
            faults.append(f"positional {i}: {p.name} is {got} in the port")
    by_name = {p.name: p for p in pp}
    kinds = {p.kind for p in pp}
    for p in rp:
        q = by_name.get(p.name)
        if q is None:
            if p.kind in (_P.VAR_POSITIONAL, _P.VAR_KEYWORD):
                if p.kind not in kinds:
                    faults.append(f"no {p}")
            elif _P.VAR_KEYWORD not in kinds:
                faults.append(f"no parameter {p.name}")
            continue
        if p.default is not _P.empty and q.default is _P.empty:
            faults.append(f"{p.name} is required in the port")
        if (p.default is not _P.empty and q.default is not _P.empty
                and _plain(p.default) and _plain(q.default)
                and p.default != q.default):
            faults.append(f"{p.name} defaults to {q.default!r}, not "
                          f"{p.default!r}")
        if p.kind == _P.KEYWORD_ONLY and q.kind not in (
                _P.KEYWORD_ONLY, _P.POSITIONAL_OR_KEYWORD):
            faults.append(f"{p.name} cannot be passed by keyword")
    names = {p.name for p in rp}
    for i, q in enumerate(pp):
        if q.name in names or q.kind in (_P.VAR_POSITIONAL, _P.VAR_KEYWORD):
            continue
        if q.default is _P.empty:
            faults.append(f"the port adds {q.name} without a default")
        elif q.kind != _P.KEYWORD_ONLY and i < len(rpos):
            faults.append(f"the port adds {q.name} before the reference's "
                          f"parameters")
    return faults


def _function(obj):
    obj = obj.__func__ if isinstance(obj, (staticmethod, classmethod)) \
        else obj
    return obj if inspect.isfunction(obj) else None


def module_faults(rel):
    """{public name: faults} of the port module ``rel`` against the JAX
    package's (a name missing in the port: its one fault)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = importlib.import_module(f"porqua_tpu{'.' if rel else ''}{rel}")
        port = importlib.import_module(
            f"porqua_tpu_torch{'.' if rel else ''}{rel}")
    found = {}
    for name, obj in vars(ref).items():
        if name.startswith("_") or getattr(obj, "__module__", None) \
                != ref.__name__:
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        mine = getattr(port, name, None)
        if mine is None:
            found[name] = ["missing in the port"]
            continue
        pairs = []
        if inspect.isfunction(obj):
            pairs.append((name, obj, mine))
        else:
            for attr, member in vars(obj).items():
                f = _function(member)
                if f is None or (attr.startswith("_") and attr != "__init__"):
                    continue
                theirs = inspect.getattr_static(mine, attr, None)
                if theirs is None:
                    found[f"{name}.{attr}"] = ["missing in the port"]
                    continue
                if _function(theirs) is not None:
                    pairs.append((f"{name}.{attr}", f, _function(theirs)))
        for label, a, b in pairs:
            faults = signature_faults(inspect.signature(a),
                                      inspect.signature(b))
            if faults:
                found[label] = faults
    return found


@pytest.mark.parametrize("rel", mirrored_modules())
def test_public_signatures_bind_as_in_the_jax_package(rel):
    """Every public function and method of the JAX module has a port
    counterpart that binds a JAX-style call the same way, but for the
    named exceptions, each of which still names a real difference."""
    found = module_faults(rel)
    named = EXCEPTIONS.get(rel, {})
    assert {k: v for k, v in found.items() if k not in named} == {}
    assert sorted(set(named) - set(found)) == []


# ---------------------------------------------------------------------
# The calls the JAX package's scripts and serving path make
# ---------------------------------------------------------------------

def test_load_all_upto_is_positional_as_in_jax(tmp_path):
    """``mgr.load_all(start)`` loads the first ``start`` chunks, as the
    JAX manager's does (it used to bind ``start`` to the device)."""
    rng = np.random.default_rng(0)
    parts = random_parts(rng, 5)
    qp = stack_qps([pt.CanonicalQP.build(*p, dtype=torch.float64,
                                         device="cpu") for p in parts])
    jqp = jax_stack_qps([JaxQP.build(*p, dtype=np.float64) for p in parts])
    sol = pt.solve_qp_batch(qp, pt.SolverParams(), device="cpu")
    jsol = jax_solve_qp_batch(jqp, JaxParams())
    dates = [f"d{i}" for i in range(5)]
    mgr = tck.CheckpointManager.create(str(tmp_path / "run"), dates, 2,
                                       pt.SolverParams())
    jmgr = jck.CheckpointManager.create(str(tmp_path / "jrun"), dates, 2,
                                        JaxParams())
    for i, (lo, hi) in enumerate([(0, 2), (2, 4), (4, 5)]):
        mgr.save_chunk(i, pt.QPSolution(*(None if f is None else f[lo:hi]
                                          for f in sol)))
        jmgr.save_chunk(i, type(jsol)(*(None if f is None else f[lo:hi]
                                        for f in jsol)))
    got = mgr.load_all(2, device="cpu")
    want = jmgr.load_all(2)
    assert got.x.shape == want.x.shape == (4, 10)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               atol=1e-9, rtol=0)
    assert_bit_identical(got, pt.QPSolution(*(None if f is None else f[:4]
                                              for f in sol)))
    assert mgr.load_all(0, device="cpu") is None is jmgr.load_all(0)


def test_load_solution_takes_the_path_alone(tmp_path):
    """``load_solution(path)`` as the JAX package calls it: onto the
    card by default; with no card it raises (no CPU fallback), and a
    named device loads what the JAX package's loader reads."""
    rng = np.random.default_rng(1)
    parts = random_parts(rng, 3)
    jqp = jax_stack_qps([JaxQP.build(*p, dtype=np.float64) for p in parts])
    path = str(tmp_path / "sol.npz")
    jck.save_solution(path, jax_solve_qp_batch(jqp, JaxParams()))
    want = jck.load_solution(path)
    if torch.cuda.is_available():
        assert tck.load_solution(path).x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tck.load_solution(path)
    got = tck.load_solution(path, device="cpu")
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stack_qps_with_np_stack_as_the_serving_path_calls_it():
    """``stack_qps(qps, stack_fn=np.stack)`` (the JAX package's batcher):
    the stacking function sees the fields as numpy arrays, and the batch
    is what it returns, field for field the JAX package's."""
    rng = np.random.default_rng(2)
    parts = random_parts(rng, 4)
    port = stack_qps([pt.CanonicalQP.build(*p, dtype=torch.float64,
                                           device="cpu") for p in parts],
                     stack_fn=np.stack)
    ref = jax_stack_qps([JaxQP.build(*p, dtype=np.float64) for p in parts],
                        stack_fn=np.stack)
    for f in port._fields:
        a, b = getattr(port, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert isinstance(a, np.ndarray), f
            np.testing.assert_array_equal(a, b)
    seen = []
    stack_qps([pt.CanonicalQP.build(*parts[0], device="cpu")] * 2,
              stack_fn=lambda xs: seen.append(xs) or np.stack(xs))
    assert all(isinstance(xs, tuple) and len(xs) == 2
               and all(isinstance(x, np.ndarray) for x in xs)
               for xs in seen)


def test_build_as_the_jax_scripts_call_it():
    """``CanonicalQP.build(P, q, C=..., l=..., u=..., lb=..., ub=...)``
    with no device, as ``scripts/chaos_suite.py``, ``calibration_smoke.py``
    and ``tenant_smoke.py`` call it: the card by default (no CPU
    fallback: without a card it raises), and on a named device the JAX
    package's problem."""
    rng = np.random.default_rng(3)
    nv, m = 6, 3
    A = rng.standard_normal((2 * nv, nv))
    P = A.T @ A / (2 * nv) + np.eye(nv)
    q = rng.standard_normal(nv)
    C = np.concatenate([np.ones((1, nv)), rng.standard_normal((m - 1, nv))])
    kw = dict(C=C, l=np.full(m, -1.0), u=np.ones(m), lb=np.zeros(nv),
              ub=np.ones(nv))
    if torch.cuda.is_available():
        assert pt.CanonicalQP.build(P, q, **kw).q.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.CanonicalQP.build(P, q, **kw)
    got = pt.CanonicalQP.build(P, q, **kw, device="cpu")
    want = JaxQP.build(P, q, **kw)
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_solve_jax_is_the_ports_solve():
    """``Optimization.solve_jax`` is the port's ``solve_torch``, the same
    method object, so a JAX-style ``opt.solve_jax()`` runs the port's
    solve (on the card unless a device is named) and publishes the JAX
    package's weights."""
    from porqua_tpu import optimization as jopt

    from tests.test_torch_compare import least_squares, tracking_parts

    assert Optimization.solve_jax is Optimization.solve_torch
    _, X, y = tracking_parts()
    port = least_squares(pt, X, y, solver_name="ipm")
    ref = least_squares(jopt, X, y, solver_name="ipm")
    port.solve_jax(device="cpu")
    ref.solve_jax()
    assert port.results["status"] is True is ref.results["status"]
    got = np.array(list(port.results["weights"].values()), float)
    want = np.array(list(ref.results["weights"].values()), float)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
