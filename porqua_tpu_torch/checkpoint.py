"""Checkpoint / resume for batched backtests (the port of
``porqua_tpu/checkpoint.py``).

The whole backtest is a device solve over a stacked problem batch, so a
checkpoint is the solution's tensors serialized to compressed ``.npz``
(portable, no code objects, safe to load) plus a small JSON manifest,
and *resume* means: skip the date chunks already solved and warm-start
the next chunk from the last solved primal/dual point. The chained
scan's runner also saves its carry at each segment boundary, so a
resumed run is bit-identical to an uninterrupted one.

Layout on disk (one directory per run; the JAX package's, field for
field):

    manifest.json     — rebdates, chunk size, solver params key
    chunk_0000.npz    — QPSolution arrays for dates [0, chunk)
    chunk_0001.npz    — ... and so on
    carry_0000.npz    — the scan's (w, x, y) carry after chunk 0
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from porqua_tpu_torch.batch import (_holdings, _l1_weight, _lanes,
                                    _on_device, _one_lane,
                                    _require_fixed_universe, _scan_l1_core,
                                    assemble_backtest, build_problems)
from porqua_tpu_torch.qp.canonical import CanonicalQP, as_torch_dtype
from porqua_tpu_torch.qp.solve import (QPSolution, SolverParams,
                                       resolve_device, solve_qp_batch)
from porqua_tpu_torch.resilience import faults as _faults
from porqua_tpu_torch.utils.helpers import to_numpy

_SOLUTION_FIELDS = list(QPSolution._fields)


def save_solution(path: str, sol: QPSolution) -> None:
    """Serialize a (possibly batched) QPSolution to compressed npz; the
    optional leaves that are None are left out."""
    arrays = {f: to_numpy(getattr(sol, f)) for f in _SOLUTION_FIELDS
              if getattr(sol, f) is not None}
    np.savez_compressed(path, **arrays)


def load_solution(path: str, *, device=None) -> QPSolution:
    """Load :func:`save_solution`'s file onto ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    with np.load(path) as data:
        return QPSolution(**{f: torch.as_tensor(data[f]).to(dev)
                             for f in _SOLUTION_FIELDS if f in data})


def _concat_solutions(sols: List[QPSolution]) -> QPSolution:
    def cat(f):
        leaves = [getattr(s, f) for s in sols]
        if any(v is None for v in leaves):
            # Optional leaves concatenate only when every chunk has
            # them; a mix means corrupted state: drop, do not invent.
            return None
        return torch.cat([torch.atleast_1d(v) for v in leaves], dim=0)

    return QPSolution(*[cat(f) for f in _SOLUTION_FIELDS])


def _dtype_name(dtype) -> Optional[str]:
    """``"float32"``/``"float64"``: the JAX package's manifest spelling."""
    if dtype is None:
        return None
    return str(as_torch_dtype(dtype)).removeprefix("torch.")


@dataclasses.dataclass
class CheckpointManager:
    """Chunk-granular checkpoint store for one backtest run.

    ``params_key`` guards against resuming with different solver
    settings (a changed tolerance silently mixing old and new chunks).
    """

    directory: str
    rebdates: List[str]
    chunk_size: int
    params_key: str

    @staticmethod
    def _key(params: SolverParams, dtype=None, has_l1: bool = False,
             extra: Optional[dict] = None) -> str:
        # dtype and the l1 configuration change a chunk's numbers, so
        # they are part of the run identity; `extra` folds in the
        # caller's own (the scan's transaction cost, initial holdings).
        key = dataclasses.asdict(params)
        key["dtype"] = _dtype_name(dtype)
        key["has_l1"] = bool(has_l1)
        if extra:
            key["extra"] = {k: extra[k] for k in sorted(extra)}
        return json.dumps(key, sort_keys=True)

    @classmethod
    def create(cls, directory: str, rebdates: List[str], chunk_size: int,
               params: SolverParams, dtype=None,
               has_l1: bool = False,
               extra: Optional[dict] = None) -> "CheckpointManager":
        os.makedirs(directory, exist_ok=True)
        mgr = cls(directory, [str(d) for d in rebdates], int(chunk_size),
                  cls._key(params, dtype, has_l1, extra))
        manifest_path = os.path.join(directory, "manifest.json")
        manifest = {
            "rebdates": mgr.rebdates,
            "chunk_size": mgr.chunk_size,
            "params_key": mgr.params_key,
        }
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                existing = json.load(f)
            if existing != manifest:
                raise ValueError(
                    f"checkpoint directory {directory} holds a different run "
                    "(rebdates/chunk_size/solver params mismatch); use a "
                    "fresh directory or delete the old checkpoints"
                )
        else:
            with open(manifest_path, "w") as f:
                json.dump(manifest, f)
        return mgr

    @property
    def n_chunks(self) -> int:
        return (len(self.rebdates) + self.chunk_size - 1) // self.chunk_size

    def chunk_path(self, idx: int) -> str:
        return os.path.join(self.directory, f"chunk_{idx:04d}.npz")

    def carry_path(self, idx: int) -> str:
        return os.path.join(self.directory, f"carry_{idx:04d}.npz")

    def completed_chunks(self, require_carry: bool = False) -> int:
        """Number of leading chunks already on disk (a gap stops the
        count). ``require_carry=True`` counts a chunk only when its
        carry file exists too: the scan's resume needs the exact
        boundary state, so a crash between the chunk write and the
        carry write rolls that chunk back."""
        done = 0
        while done < self.n_chunks and os.path.exists(self.chunk_path(done)):
            if require_carry and not os.path.exists(self.carry_path(done)):
                break
            done += 1
        return done

    def save_chunk(self, idx: int, sol: QPSolution) -> None:
        # Write, then rename: a crash mid-write never leaves a torn
        # chunk that a resume would trust.
        tmp = self.chunk_path(idx) + ".tmp.npz"
        save_solution(tmp, sol)
        os.replace(tmp, self.chunk_path(idx))

    def save_carry(self, idx: int, carry: dict) -> None:
        """Persist one segment boundary's scan carry (named tensors),
        written and renamed like a chunk."""
        tmp = self.carry_path(idx) + ".tmp.npz"
        np.savez_compressed(tmp, **{k: to_numpy(v)
                                    for k, v in carry.items()})
        os.replace(tmp, self.carry_path(idx))

    def load_carry(self, idx: int) -> dict:
        with np.load(self.carry_path(idx)) as data:
            return {k: np.array(data[k]) for k in data.files}

    def load_all(self, upto: Optional[int] = None, *, device=None
                 ) -> Optional[QPSolution]:
        """The first ``upto`` chunks' solutions (default: every completed
        chunk), concatenated on ``device`` (default: the card)."""
        upto = self.completed_chunks() if upto is None else upto
        if upto == 0:
            return None
        return _concat_solutions(
            [load_solution(self.chunk_path(i), device=device)
             for i in range(upto)])


def run_batch_checkpointed(bs,
                           directory: str,
                           chunk_size: int = 64,
                           params: Optional[SolverParams] = None,
                           dtype=torch.float32,
                           device=None):
    """``run_batch`` with chunk-granular checkpoint/resume, on
    ``device`` (default: the card).

    Splits the dates into ``chunk_size`` sub-batches, solves them in
    order, saves each, and on a rerun resumes after the last complete
    chunk, warm-starting every problem of the next chunk from the last
    solved date's primal/dual point. Returns the same ``Backtest`` as
    :func:`porqua_tpu_torch.batch.run_batch`.
    """
    dev = resolve_device(device)
    # The strategy's own solver configuration for the solved dtype, as
    # run_batch defaults to (a bare SolverParams() would drop e.g.
    # LAD's LP overlay).
    problems = build_problems(bs, dtype=dtype)
    if params is None:
        params = bs.optimization.solver_params(solve_dtype=dtype)
    mgr = CheckpointManager.create(
        directory, problems.rebdates, chunk_size, params,
        dtype=dtype, has_l1=problems.l1_weight is not None,
    )

    start = mgr.completed_chunks()
    sols: List[QPSolution] = []
    if start:
        sols.append(mgr.load_all(start, device=dev))

    warm_x = warm_y = None
    if sols:
        warm_x, warm_y = sols[-1].x[-1], sols[-1].y[-1]

    for idx in range(start, mgr.n_chunks):
        lo = idx * chunk_size
        hi = min(lo + chunk_size, len(problems.rebdates))
        qp_chunk = CanonicalQP(*(None if f is None else f[lo:hi]
                                 for f in problems.qp))
        bsz = hi - lo
        x0 = None if warm_x is None else warm_x.expand(bsz, -1)
        y0 = None if warm_y is None else warm_y.expand(bsz, -1)
        l1w = None if problems.l1_weight is None else problems.l1_weight[lo:hi]
        l1c = None if problems.l1_center is None else problems.l1_center[lo:hi]
        sol = solve_qp_batch(qp_chunk, params, x0, y0, l1w, l1c, device=dev)
        mgr.save_chunk(idx, sol)
        if _faults.enabled():
            # backtest.chunk seam: an injected crash ends the run right
            # after this chunk was saved.
            _faults.fire("backtest.chunk", idx=idx)
        sols.append(sol)
        warm_x, warm_y = sol.x[-1], sol.y[-1]

    solution = _concat_solutions(sols) if len(sols) > 1 else sols[0]
    backtest = assemble_backtest(problems, solution)
    backtest.output["checkpoint"] = {
        "directory": directory,
        "resumed_chunks": start,
        "total_chunks": mgr.n_chunks,
    }
    return backtest


def solve_scan_l1_checkpointed(qp,
                               n_assets: int,
                               w_init,
                               transaction_cost: float,
                               directory: str,
                               params: SolverParams = SolverParams(),
                               segment_size: int = 64,
                               harvest=None,
                               *,
                               universes,
                               device=None):
    """:func:`porqua_tpu_torch.batch.solve_scan_l1` with crash-resume,
    on ``device`` (default: the card).

    The chained scan carries ``(w_prev, x_prev, y_prev)`` from date to
    date, so a resume needs the exact boundary state. This runner cuts
    the dates into ``segment_size`` segments, runs each through the
    scan's own loop seeded with the previous boundary's carry, and
    saves both the segment's solutions and the boundary carry (each
    written, then renamed; a segment counts only once its carry is on
    disk too). A split run executes the same per-date steps on the same
    values, so a run killed at any boundary and resumed is bit-identical
    to an uninterrupted one and to :func:`solve_scan_l1`.

    Returns ``(QPSolution, info)``, ``info`` holding
    ``resumed_segments`` / ``total_segments`` / ``directory``.
    ``universes`` is the scans' positional-carry attestation.
    ``harvest`` (a :class:`porqua_tpu_torch.obs.HarvestSink`) appends
    one SolveRecord per date of each segment this run solved (source
    ``backtest.scan``); resumed segments were harvested by the run that
    solved them.
    """
    _require_fixed_universe(universes)
    qp = _on_device(qp, device)
    dtype, dev = qp.q.dtype, qp.q.device
    T, nvar = qp.q.shape
    m = qp.l.shape[-1]
    l1w = _l1_weight(nvar, n_assets, transaction_cost, dtype, dev)
    w0 = _holdings(w_init, n_assets, 1, nvar, dtype, dev)

    mgr = CheckpointManager.create(
        directory, [str(i) for i in range(T)], segment_size, params,
        dtype=dtype, has_l1=True,
        extra={
            "kind": "scan_l1",
            "transaction_cost": float(transaction_cost),
            "n_assets": int(n_assets),
            # The initial holdings are run identity too: a resume with
            # another w_init would chain costs from the wrong book.
            "w_init_sha": _array_fingerprint(w0[0]),
        })

    start = mgr.completed_chunks(require_carry=True)
    sols: List[QPSolution] = []
    if start:
        sols.append(mgr.load_all(start, device=dev))
        boundary = mgr.load_carry(start - 1)
        carry_w, carry_x, carry_y = (
            torch.as_tensor(boundary[k], dtype=dtype).to(dev).reshape(1, -1)
            for k in ("w", "x", "y"))
    else:
        carry_w = w0
        carry_x = torch.zeros((1, nvar), dtype=dtype, device=dev)
        carry_y = torch.zeros((1, m), dtype=dtype, device=dev)

    for idx in range(start, mgr.n_chunks):
        lo = idx * mgr.chunk_size
        hi = min(lo + mgr.chunk_size, T)
        qp_seg = CanonicalQP(*(None if f is None else f[lo:hi] for f in qp))
        t_seg0 = time.perf_counter()
        sol, (carry_w, carry_x, carry_y) = _scan_l1_core(
            _lanes(qp_seg), carry_w, l1w, params,
            x_init=carry_x, y_init=carry_y, return_carry=True)
        sol = _one_lane(sol)
        mgr.save_chunk(idx, sol)
        mgr.save_carry(idx, {"w": carry_w[0], "x": carry_x[0],
                             "y": carry_y[0]})
        if harvest is not None:
            from porqua_tpu_torch.obs.harvest import (device_label_of,
                                                      harvest_solution)

            # save_chunk copied the segment to the host, so the wall
            # covers the solve and its completion. Date 0 of a fresh
            # run solves from the cold initial carry: its record stays
            # out of the warm population.
            mask = None
            if lo == 0:
                mask = [False] + [True] * (hi - lo - 1)
            harvest_solution(
                harvest, sol, params, "backtest.scan",
                wall_s=time.perf_counter() - t_seg0,
                device=device_label_of(sol),
                warm=True, warm_src="scan_carry", warm_mask=mask,
                date_offset=lo)
        if _faults.enabled():
            # backtest.chunk seam: the injected crash fires after the
            # boundary was saved, the worst point a resume must cover.
            _faults.fire("backtest.chunk", idx=idx)
        sols.append(sol)

    solution = _concat_solutions(sols) if len(sols) > 1 else sols[0]
    return solution, {
        "directory": directory,
        "resumed_segments": start,
        "total_segments": mgr.n_chunks,
    }


def _array_fingerprint(a) -> str:
    import hashlib

    arr = np.ascontiguousarray(to_numpy(a))
    return hashlib.blake2b(arr.tobytes(), digest_size=8).hexdigest()
