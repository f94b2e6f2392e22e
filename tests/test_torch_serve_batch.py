"""The port's segment-stepped batch API (``qp/solve.py``:
``prepare_batch``, ``segment_step_batch``, ``finalize_batch``,
``continuous_entries``) and its shape buckets (``serve/bucketing.py``)
against the JAX package's, on the same numpy inputs in the same process.

Inputs: the reference loadgen's grid requests (24 assets under a
252-day window, f32), padded to bucket 32 x 8 by the JAX package's
ladder. The solver config is the repo's lane-freeze one
(tests/test_torch_tracking.py): check_interval 3 at eps 1e-5, so lanes
finish after different numbers of segments.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from porqua_tpu.qp import solve as jsolve
from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
from porqua_tpu.qp.canonical import stack_qps as jax_stack_qps
from porqua_tpu.qp.solve import SolverParams as JaxParams
from porqua_tpu.serve import bucketing as jbucketing
from porqua_tpu.serve.continuous import _neutral_qp as jax_neutral_qp
from porqua_tpu.serve.loadgen import (
    build_tracking_requests as jax_tracking_requests)

import porqua_tpu_torch as pt
from porqua_tpu_torch.qp import solve as tsolve
from porqua_tpu_torch.serve import bucketing as tbucketing
from porqua_tpu_torch.serve.continuous import _neutral_qp

KINDS = {
    "dense": (False, dict(linsolve="auto")),
    "factored": (True, dict(linsolve="woodbury", woodbury_refine=0,
                            scaling_mode="factored")),
}
LANE_FREEZE = dict(max_iter=2000, eps_abs=1e-5, eps_rel=1e-5, polish=False,
                   scaling_iters=2, check_interval=3, backend="xla")
# Per lane, f32: dense x within X_ATOL of JAX (seen 1.7e-6); the
# factored requests' refine-0 Woodbury f32 iterates differ by up to
# 8.6e-5 in the two packages, each rounding away from the f64 answer,
# so there the port's distance to the f64 answer may be at most
# TWIN_RATIO times XLA-CPU's (tests/test_torch_serve.py).
X_ATOL = 1e-5
TWIN_RATIO = 4.0
SOL_KEYS = ("x", "y", "status", "iters", "prim_res", "dual_res", "obj_val")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pt.qp.canonical.HP.apply()
    yield
    torch.set_num_threads(n)


def params_of(kind):
    jp = JaxParams(**{**LANE_FREEZE, **KINDS[kind][1]})
    return jp, pt.SolverParams(**{**dataclasses.asdict(jp),
                                  "backend": "pallas"})


def lanes(kind, n=3, dtype=np.float32):
    """``n`` bucket-padded grid requests as one batch: (JAX, port)."""
    reqs = jax_tracking_requests(n, n_assets=24, seed=5,
                                 factor=KINDS[kind][0])
    stack = jax_stack_qps([jbucketing.BucketLadder().pad(q)[1] for q in reqs],
                          stack_fn=np.stack)
    arrays = [None if a is None else np.asarray(a, dtype) for a in stack]
    return (JaxQP(*(None if a is None else jnp.asarray(a) for a in arrays)),
            pt.CanonicalQP(*(None if a is None else torch.as_tensor(a)
                             for a in arrays)))


def assert_x(kind, x_port, x_jax, f64_x):
    if kind == "dense":
        np.testing.assert_allclose(x_port, x_jax, atol=X_ATOL, rtol=0)
        return
    x64 = f64_x()
    e_port, e_jax = np.abs(x_port - x64).max(), np.abs(x_jax - x64).max()
    assert e_port <= TWIN_RATIO * e_jax, (e_port, e_jax)


def jax_f64(kind):
    jp, _ = params_of(kind)
    return lambda: np.asarray(jsolve.solve_qp_batch(
        lanes(kind, dtype=np.float64)[0], jp).x)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stepped_batch_matches_jax_and_the_fused_solve(kind):
    """prepare -> segment steps (lanes frozen once they leave RUNNING)
    -> finalize on 3 lanes: equal status and iterations with the JAX
    functions, x by the limits above; and bit-identical to the port's
    own fused ``solve_qp_batch``."""
    jp, tp = params_of(kind)
    jqp, tqp = lanes(kind)

    jprep = jax.jit(lambda q: jsolve.prepare_batch(q, jp)[:3])
    jstep = jax.jit(lambda s, sc, c: jsolve.segment_step_batch(s, sc, c, jp))
    jfin = jax.jit(lambda q, s, sc, st: jsolve.finalize_batch(q, s, sc, st,
                                                              jp))
    scaled, scaling, carry = jprep(jqp)
    while True:
        st = carry.state
        active = (st.status == 0) & (st.iters < jp.max_iter)
        if not bool(active.any()):
            break
        carry = jsolve.select_lanes(active, jstep(scaled, scaling, carry),
                                    carry)
    want = jfin(jqp, scaled, scaling, carry.state)

    scaled, scaling, carry, l1w, l1c = tsolve.prepare_batch(tqp, tp)
    assert l1w is None and l1c is None
    segments = 0
    while True:
        st = carry.state
        active = (st.status == 0) & (st.iters < tp.max_iter)
        if not bool(active.any()):
            break
        carry = tsolve.select_lanes(
            active, tsolve.segment_step_batch(scaled, scaling, carry, tp),
            carry)
        segments += 1
    got = tsolve.finalize_batch(tqp, scaled, scaling, carry.state, tp)

    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert segments == int(got.iters.max()) // tp.check_interval
    assert_x(kind, got.x.numpy(), np.asarray(want.x), jax_f64(kind))
    fused = tsolve.solve_qp_batch(tqp, tp, device="cpu")
    for k in SOL_KEYS:
        assert torch.equal(getattr(got, k), getattr(fused, k)), k


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_continuous_entries_freeze_and_match_jax(kind):
    """``admit`` with lane 2 masked out keeps lane 2's state; ``step``
    with lane 2 inactive leaves it bit-for-bit frozen; ``finalize`` of
    the admitted lanes equals the JAX package's entries."""
    jp, tp = params_of(kind)
    jqp, tqp = lanes(kind)
    B, n, m = 3, tqp.n, tqp.m
    r = None if tqp.Pf is None else tqp.Pf.shape[-2]
    mask = np.array([True, True, False])

    def run_jax():
        admit, step, fin = (jax.jit(f) for f in jsolve.continuous_entries(jp))
        neutral = jax_stack_qps([jax_neutral_qp(
            jbucketing.Bucket(n, m, r),
            np.float32)] * B, stack_fn=np.stack)
        zx, zy = np.zeros((B, n), np.float32), np.zeros((B, m), np.float32)
        old = jsolve.prepare_batch(jax.tree.map(jnp.asarray, neutral), jp,
                                   zx, zy)[:3]
        q, scaled, scaling, carry = admit(jqp, zx, zy, mask, *old)
        while True:
            st = carry.state
            active = mask & np.asarray((st.status == 0)
                                       & (st.iters < jp.max_iter))
            if not active.any():
                break
            carry = step(scaled, scaling, carry, active)[0]
        return fin(q, scaled, scaling, carry.state)

    admit, step, fin = tsolve.continuous_entries(tp)
    neutral = pt.qp.stack_qps([_neutral_qp(
        tbucketing.Bucket(n, m, r),
        torch.float32)] * B)
    zx, zy = torch.zeros((B, n)), torch.zeros((B, m))
    old = tsolve.prepare_batch(neutral, tp, zx, zy)[:3]
    tmask = torch.as_tensor(mask)
    q, scaled, scaling, carry = admit(tqp, zx, zy, tmask, *old)

    def lane2(tree):
        out = []
        tsolve.map_tensors(lambda t: out.append(t[2].clone()), tree)
        return out

    frozen = lane2((scaled, scaling, carry))
    assert all(torch.equal(a, b) for a, b in zip(frozen, lane2(old)))
    steps = 0
    while True:
        st = carry.state
        active = tmask & (st.status == 0) & (st.iters < tp.max_iter)
        if not bool(active.any()):
            break
        carry, status, iters = step(scaled, scaling, carry, active)
        assert torch.equal(status, carry.state.status)
        assert all(torch.equal(a, b) for a, b in
                   zip(frozen, lane2((scaled, scaling, carry))))
        steps += 1
    assert steps >= 2
    got = fin(q, scaled, scaling, carry.state)
    want = run_jax()
    np.testing.assert_array_equal(got.status.numpy()[:2],
                                  np.asarray(want.status)[:2])
    np.testing.assert_array_equal(got.iters.numpy()[:2],
                                  np.asarray(want.iters)[:2])
    assert_x(kind, got.x.numpy()[:2], np.asarray(want.x)[:2],
             lambda: jax_f64(kind)()[:2])


def _problem(n, m, factor_rows, seed=0):
    """A random f32 QP at its natural shape, as (JAX, port)
    CanonicalQPs; ``factor_rows`` adds the factor ``P = 2 Pf'Pf``."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    Pf = rng.standard_normal((factor_rows or 2 * n, n))
    fields = dict(
        P=f32(2 * Pf.T @ Pf), q=f32(rng.standard_normal(n)),
        C=f32(rng.standard_normal((m, n))), l=f32(-np.ones(m)),
        u=f32(np.ones(m)), lb=f32(np.zeros(n)), ub=f32(np.ones(n)),
        var_mask=f32(np.ones(n)), row_mask=f32(np.ones(m)),
        constant=np.float32(0.5),
        Pf=None if factor_rows is None else f32(Pf))
    return (JaxQP(**fields),
            pt.CanonicalQP(**{k: None if v is None else torch.as_tensor(v)
                              for k, v in fields.items()}))


SHAPES = [(6, 2, None), (32, 8, None), (33, 9, None), (24, 1, 252),
          (500, 1, 252), (500, 40, None), (2048, 2048, None), (130, 1, 5)]


@pytest.mark.parametrize("n, m, factor_rows", SHAPES)
def test_bucket_select_and_pad_match_jax(n, m, factor_rows):
    jqp, tqp = _problem(n, m, factor_rows)
    jl, tl = jbucketing.BucketLadder(), tbucketing.BucketLadder()
    jb, jpad = jl.pad(jqp)
    tb, tpad = tl.pad(tqp)
    assert tuple(tb) == tuple(jb)
    for name, a, b in zip(pt.CanonicalQP._fields, jpad, tpad):
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)


@pytest.mark.parametrize("n, m", [(2049, 1), (10, 2049)])
def test_bucket_overflow_matches_jax(n, m):
    jqp, tqp = _problem(n, m, None)
    with pytest.raises(jbucketing.BucketOverflow):
        jbucketing.BucketLadder().select(jqp)
    with pytest.raises(tbucketing.BucketOverflow):
        tbucketing.BucketLadder().select(tqp)


def test_slot_count_and_ladder_match_jax():
    for cap in (1, 4, 6, 8, 100, 256):
        assert tbucketing.slot_ladder(cap) == jbucketing.slot_ladder(cap)
        for k in range(1, 300):
            assert (tbucketing.slot_count(k, cap)
                    == jbucketing.slot_count(k, cap)), (k, cap)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            tbucketing.slot_count(bad, 8)


def test_shape_struct_and_neutral_batch():
    """``batch_shape_struct`` has no data (meta tensors) and the
    reference's shapes; the neutral batch solves at once to x = 0."""
    s = tsolve.batch_shape_struct(4, 32, 8, factor_rows=5)
    j = jsolve.batch_shape_struct(4, 32, 8, factor_rows=5)
    for name, a, b in zip(pt.CanonicalQP._fields, s, j):
        assert a.device.type == "meta" and tuple(a.shape) == b.shape, name
    _, tp = params_of("factored")
    sol = tsolve.solve_qp_batch(tsolve.neutral_batch(s, "cpu"), tp,
                                device="cpu")
    assert sol.status.tolist() == [pt.Status.SOLVED] * 4
    assert torch.equal(sol.x, torch.zeros(4, 32))


def test_compiled_entries_check_their_shape():
    """An entry runs only the shape it was compiled for, and the
    continuous triple's warm-up leaves its structs on ``meta``."""
    _, tp = params_of("dense")
    struct = tsolve.batch_shape_struct(2, 32, 8)
    entry = tsolve.aot_compile_batch(struct, tp, device="cpu")
    _, tqp = lanes("dense", n=3)
    with pytest.raises(ValueError, match="does not match"):
        entry(tqp, torch.zeros(3, 32), torch.zeros(3, 8))
    two = pt.CanonicalQP(*(None if f is None else f[:2] for f in tqp))
    assert entry(two, torch.zeros(2, 32), torch.zeros(2, 8)).x.shape == (2, 32)
    *_, structs = tsolve.aot_compile_continuous(struct, tp, device="cpu")
    tsolve.map_tensors(lambda t: (t.device.type == "meta") or pytest.fail(),
                       structs)
