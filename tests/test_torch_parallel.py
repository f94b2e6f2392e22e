"""The port's device mesh (``porqua_tpu_torch.parallel``) against the
JAX package's on the same numpy inputs: every test of
``tests/test_parallel.py``, on virtual CPU slots (``device="cpu"``),
float64 pinned on both sides.

The two-process test runs this file's ``__main__`` block as its worker
(two ``gloo`` processes on a free localhost port); the worker writes its
gathered solution to a file that the test holds against the JAX
package's solve computed in the test process.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import porqua_tpu_torch as pt
from porqua_tpu_torch.parallel import (make_mesh, pad_batch_to_mesh,
                                       shard_qp_batch, solve_qp_sharded)
from porqua_tpu_torch.parallel.mesh import (batch_sharding, init_distributed,
                                            make_multihost_mesh)
from porqua_tpu_torch.qp.canonical import CanonicalQP, stack_qps

TIGHT = dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=10000)


def portfolio_np(rng, n):
    X = rng.standard_normal((50, n)) * 0.01
    P = 2 * X.T @ X + 1e-4 * np.eye(n)
    q = -0.01 * rng.random(n)
    return dict(P=P, q=q, C=np.ones((1, n)), l=np.ones(1), u=np.ones(1),
                lb=np.zeros(n), ub=np.ones(n))


def port_batch(parts):
    return stack_qps([CanonicalQP.build(
        p["P"], p["q"], C=p["C"], l=p["l"], u=p["u"], lb=p["lb"],
        ub=p["ub"], dtype=torch.float64, device="cpu") for p in parts])


def jax_batch(parts):
    import jax.numpy as jnp

    from porqua_tpu.qp import stack_qps as jstack
    from porqua_tpu.qp.canonical import CanonicalQP as JQP

    return jstack([JQP.build(
        p["P"], p["q"], C=p["C"], l=p["l"], u=p["u"], lb=p["lb"],
        ub=p["ub"], dtype=jnp.float64) for p in parts])


def port_params(**kw):
    return pt.SolverParams(**{**TIGHT, **kw})


def jax_params(**kw):
    from porqua_tpu.qp import SolverParams

    return SolverParams(**{**TIGHT, **kw})


@pytest.fixture
def parts(rng):
    return [portfolio_np(rng, 10) for _ in range(11)]


def test_mesh_has_8_slots_and_no_silent_cpu_mesh(monkeypatch):
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.shape == (8,)
    assert mesh.axis_names == ("dates",)
    assert [d.type for d in mesh.devices.flat] == ["cpu"] * 8
    assert len({str(d) for d in mesh.devices.flat}) == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_pad_batch_to_mesh(parts):
    padded, n_real = pad_batch_to_mesh(port_batch(parts), 8)
    assert n_real == 11
    assert padded.P.shape[0] == 16


def test_sharded_solve_matches_single_device_and_jax(parts):
    from porqua_tpu.parallel import make_mesh as jmesh
    from porqua_tpu.parallel import solve_qp_sharded as jsharded

    batch = port_batch(parts)
    mesh = make_mesh(8, axis_names=("dates",), device="cpu")
    sharded = solve_qp_sharded(batch, mesh, port_params())
    single = pt.solve_qp_batch(batch, port_params(), device="cpu")
    assert sharded.x.shape[0] == 11
    assert torch.all(sharded.status == pt.Status.SOLVED)
    np.testing.assert_allclose(sharded.x.numpy(), single.x.numpy(),
                               atol=1e-8)
    ref = jsharded(jax_batch(parts), jmesh(8, axis_names=("dates",)),
                   jax_params())
    np.testing.assert_array_equal(sharded.status.numpy(),
                                  np.asarray(ref.status))
    np.testing.assert_allclose(sharded.x.numpy(), np.asarray(ref.x),
                               atol=1e-8)


def test_2d_mesh_benchmarks_by_dates(rng):
    """A (benchmarks x dates) grid split over a 2-D mesh: each slot's
    shard solved on its slot equals the flat batch solve."""
    parts = [portfolio_np(rng, 8) for _ in range(8)]
    flat = port_batch(parts)
    grid = CanonicalQP(*(None if a is None
                         else a.reshape((2, 4) + tuple(a.shape[1:]))
                         for a in flat))
    mesh = make_mesh(8, axis_names=("bench", "dates"), shape=(2, 4),
                     device="cpu")
    shards = shard_qp_batch(grid, mesh, n_batch_axes=2)
    assert len(shards) == 8 and shards[0].P.shape == (1, 1, 8, 8)
    assert batch_sharding(mesh, 4, 2).spec == ("bench", "dates", None, None)
    sols = [pt.solve_qp_batch(CanonicalQP(*(
        None if a is None else a.reshape((1,) + tuple(a.shape[2:]))
        for a in s)), port_params(), device=d)
        for s, d in zip(shards, mesh.devices.flat)]
    x = torch.cat([s.x for s in sols])
    ref = pt.solve_qp_batch(flat, port_params(), device="cpu")
    np.testing.assert_allclose(x.numpy(), ref.x.numpy(), atol=1e-8)
    from porqua_tpu.qp import solve_qp_batch as jsolve

    jref = jsolve(jax_batch(parts), jax_params())
    np.testing.assert_allclose(x.numpy(), np.asarray(jref.x), atol=1e-8)


def test_pad_batch_smaller_than_mesh(rng):
    """A batch smaller than half the mesh still pads to a full
    multiple."""
    parts = [portfolio_np(rng, 6) for _ in range(3)]
    small = port_batch(parts)
    padded, n_real = pad_batch_to_mesh(small, 8)
    assert n_real == 3
    assert padded.P.shape[0] == 8
    mesh = make_mesh(8, axis_names=("dates",), device="cpu")
    sol = solve_qp_sharded(small, mesh, port_params())
    ref = pt.solve_qp_batch(small, port_params(), device="cpu")
    np.testing.assert_allclose(sol.x.numpy(), ref.x.numpy(), atol=1e-8)


def test_pad_slots_are_trivial(rng):
    """Filler slots are near-free pinned-to-zero problems, not
    duplicated real solves, with the same filler as the JAX package's."""
    from porqua_tpu.parallel import pad_batch_to_mesh as jpad

    parts = [portfolio_np(rng, 6) for _ in range(3)]
    padded, n_real = pad_batch_to_mesh(port_batch(parts), 8)
    sol = pt.solve_qp_batch(padded, port_params(), device="cpu")
    filler_iters = sol.iters.numpy()[n_real:]
    real_iters = sol.iters.numpy()[:n_real]
    assert np.all(sol.x.numpy()[n_real:] == 0.0)
    assert filler_iters.max() <= real_iters.min()
    jpadded, _ = jpad(jax_batch(parts), 8)
    for mine, theirs in zip(padded, jpadded):
        if mine is None:
            assert theirs is None
            continue
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_factored_filler_keeps_the_objective_invariant(rng):
    parts = [portfolio_np(rng, 6) for _ in range(3)]
    qps = []
    for p in parts:
        Pf = rng.standard_normal((4, 6)) * 0.1
        qps.append(CanonicalQP.build(
            2 * Pf.T @ Pf + np.diag(np.full(6, 1e-3)), p["q"], C=p["C"],
            l=p["l"], u=p["u"], lb=p["lb"], ub=p["ub"], Pf=Pf,
            Pdiag=np.full(6, 1e-3), dtype=torch.float64, device="cpu"))
    padded, _ = pad_batch_to_mesh(stack_qps(qps), 4)
    P = 2 * padded.Pf.transpose(-1, -2) @ padded.Pf + torch.diag_embed(
        padded.Pdiag)
    torch.testing.assert_close(P, padded.P, rtol=1e-12, atol=1e-12)


def grid_np(rng, B, T, n):
    cols = []
    for _ in range(B):
        dates = []
        for _ in range(T):
            X = rng.standard_normal((40, n)) * 0.01
            y = X @ rng.dirichlet(np.ones(n))
            dates.append(dict(P=2 * X.T @ X, q=-2 * X.T @ y,
                              C=np.ones((1, n)), l=np.ones(1), u=np.ones(1),
                              lb=np.zeros(n), ub=np.ones(n)))
        cols.append(dates)
    return cols


def test_scan_l1_grid_sharded_matches_per_column_and_jax(rng):
    """The grid engine with its columns split over the mesh equals the
    unsharded grid and the single-column scan per benchmark, and the JAX
    package's sharded grid."""
    import jax
    import jax.numpy as jnp

    from porqua_tpu.batch import FIXED_UNIVERSE as jfixed
    from porqua_tpu.batch import solve_scan_l1_grid as jgrid
    from porqua_tpu.parallel import make_mesh as jmesh

    B, T, n, tc = 4, 6, 8, 0.002
    cols = grid_np(rng, B, T, n)
    port_cols = [port_batch(c) for c in cols]
    grid = CanonicalQP(*(None if f[0] is None else torch.stack(f)
                         for f in zip(*port_cols)))
    params = port_params(max_iter=20000)
    w_init = np.full((B, n), 1.0 / n)
    fixed = pt.FIXED_UNIVERSE
    mesh = make_mesh(4, axis_names=("bench",), device="cpu")
    sharded = pt.solve_scan_l1_grid(grid, n, w_init, tc, params, mesh=mesh,
                                    universes=fixed)
    unsharded = pt.solve_scan_l1_grid(grid, n, w_init, tc, params,
                                      universes=fixed, device="cpu")
    np.testing.assert_allclose(sharded.x.numpy(), unsharded.x.numpy(),
                               atol=1e-10)
    for b in range(B):
        ref = pt.solve_scan_l1(port_cols[b], n, w_init[b], tc, params,
                               universes=fixed, device="cpu")
        assert torch.all(ref.status == pt.Status.SOLVED)
        np.testing.assert_allclose(sharded.x[b].numpy(), ref.x.numpy(),
                                   atol=1e-9)
    jcols = [jax_batch(c) for c in cols]
    jg = jax.tree.map(lambda *a: jnp.stack(a), *jcols)
    jref = jgrid(jg, n, w_init, tc, params=jax_params(max_iter=20000),
                 mesh=jmesh(4, axis_names=("bench",)),
                 universes=jfixed)
    np.testing.assert_array_equal(sharded.status.numpy(),
                                  np.asarray(jref.status))
    np.testing.assert_allclose(sharded.x.numpy(), np.asarray(jref.x),
                               atol=1e-8)


def test_scan_l1_grid_rejects_uneven_mesh():
    n = 4
    qp = CanonicalQP.build(np.eye(n), np.zeros(n), dtype=torch.float64,
                           device="cpu")
    grid = CanonicalQP(*(None if a is None
                         else a.expand((3, 2) + tuple(a.shape))
                         for a in qp))
    mesh = make_mesh(8, axis_names=("bench",), device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        pt.solve_scan_l1_grid(grid, n, np.zeros((3, n)), 0.001, mesh=mesh,
                              universes=pt.FIXED_UNIVERSE)


def tracking_parts(seed, n_dates, window, n_assets):
    Xs, ys = pt.synthetic_universe_np(seed, n_dates, window, n_assets)
    return Xs.astype(np.float64), ys.astype(np.float64)


def test_multihost_mesh_single_process_degenerates():
    """One process: the hosts x dates mesh collapses to (1, n_local) and
    solves like the 1-D one; init_distributed() is a no-op returning 1
    and refuses an explicit fleet that the group does not match."""
    from porqua_tpu.qp.solve import solve_qp_batch as jsolve
    from porqua_tpu.tracking import build_tracking_qp as jbuild
    import jax

    assert init_distributed(device="cpu") == 1
    mesh = make_multihost_mesh(device="cpu", local_devices=8)
    assert mesh.shape == (1, 8)
    assert mesh.axis_names == ("hosts", "dates")
    with pytest.raises(ValueError, match="must divide"):
        make_multihost_mesh(device="cpu", local_devices=8, ici_per_host=3)
    Xs, ys = tracking_parts(2, 8, 24, 12)
    qp = pt.build_tracking_qp(torch.as_tensor(Xs), torch.as_tensor(ys))
    params = port_params(max_iter=2000)
    sol = solve_qp_sharded(qp, mesh, params)
    assert torch.all(sol.status == 1)
    ref = pt.solve_qp_batch(qp, params, device="cpu")
    np.testing.assert_allclose(sol.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-12)
    jref = jsolve(jax.vmap(jbuild)(Xs, ys), jax_params(max_iter=2000))
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(jref.x), atol=1e-8)


WORKER_TIMEOUT_S = 120


def test_two_process_gloo(tmp_path):
    """Two processes, each with 4 virtual CPU slots, joined through a
    gloo group on a free localhost port: init_distributed's consistency
    check, the (2, 4) hosts x dates mesh, each process solving its own
    rows and one all_gather; both processes' gathered solutions equal
    the JAX package's solve of the same batch."""
    from porqua_tpu.qp.solve import solve_qp_batch as jsolve
    from porqua_tpu.tracking import build_tracking_qp as jbuild
    import jax

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(i), "2", str(port),
         str(tmp_path / f"w{i}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {i} rc={rc}\n{err[-2000:]}"
        assert f"MULTIHOST OK pid={i} procs=2 shard_rows=8" in out, out
    Xs, ys = tracking_parts(5, 16, 24, 12)
    jref = jsolve(jax.vmap(jbuild)(Xs, ys), jax_params(max_iter=2000))
    for i in range(2):
        got = np.load(tmp_path / f"w{i}.npz")
        np.testing.assert_array_equal(got["status"], np.asarray(jref.status))
        np.testing.assert_allclose(got["x"], np.asarray(jref.x), atol=1e-8)


def _worker(pid, nproc, port, out_path):
    """One process of the two-process test: join the group, build the
    (nproc, 4) mesh, solve the shared batch through it, check this
    process's rows against its own unsharded solve, write the gathered
    solution."""
    torch.set_num_threads(1)
    got = init_distributed(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid,
                           device="cpu")
    assert got == nproc, (got, nproc)
    try:
        mesh = make_multihost_mesh(device="cpu", local_devices=4)
        assert mesh.shape == (nproc, 4), mesh.shape
        assert mesh.axis_names == ("hosts", "dates")
        assert len(mesh.local_devices) == 4
        Xs, ys = tracking_parts(5, 16, 24, 12)
        qp = pt.build_tracking_qp(torch.as_tensor(Xs), torch.as_tensor(ys))
        params = port_params(max_iter=2000)
        sol = solve_qp_sharded(qp, mesh, params)
        ref = pt.solve_qp_batch(qp, params, device="cpu")
        rows = slice(pid * 8, (pid + 1) * 8)
        assert torch.equal(sol.x[rows], ref.x[rows])
        assert sol.x.shape == ref.x.shape
        np.savez(out_path, x=sol.x.numpy(), status=sol.status.numpy())
        print(f"MULTIHOST OK pid={pid} procs={nproc} shard_rows=8",
              flush=True)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
