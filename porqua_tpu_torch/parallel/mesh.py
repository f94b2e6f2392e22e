"""Multi-device scaling: split the problem batch over a device mesh
(the port of ``porqua_tpu/parallel/mesh.py``).

Every QP of a batch is independent, so the mesh is pure data
parallelism: :func:`solve_qp_sharded` splits the stacked
:class:`~porqua_tpu_torch.qp.canonical.CanonicalQP` batch along its
leading axis, solves each shard with the same batched solve as one
device (:func:`porqua_tpu_torch.qp.solve.solve_qp_batch`) on its own
device, and gathers the results onto the mesh's first device. There are
no collectives in the segment loop; the gather is the counterpart of
the JAX program's implicit final all-gather. Across processes
(:func:`init_distributed`, :func:`make_multihost_mesh`) each process
solves the rows it owns and one ``all_gather`` of the results is the
only collective.

A :class:`Mesh` is a grid of ``torch.device`` with named axes. By
default it takes the visible CUDA devices and raises when there is
none; with ``device="cpu"`` it takes ``n_devices`` virtual CPU slots
(``cpu:0``, ``cpu:1``, ...; they all compute on the CPU, one after
another), the counterpart of the JAX tests'
``--xla_force_host_platform_device_count``. On CUDA each device's shard
runs on a host thread of its own, because the segment loop reads one
scalar per segment and a single host thread would serialize the
devices; a one-device mesh runs inline.
"""

from __future__ import annotations

import dataclasses
import socket
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from porqua_tpu_torch.qp.canonical import CanonicalQP
from porqua_tpu_torch.qp.solve import QPSolution, SolverParams, solve_qp_batch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices with named axes. ``devices`` is an object
    ndarray of ``torch.device`` with the mesh's shape. A mesh over
    ``n_processes`` processes splits its leading axis evenly between
    them; ``process_index`` is this process's rank there (``None`` for
    a mesh of one process)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    process_index: Optional[int] = None
    n_processes: int = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_devices(self) -> List[torch.device]:
        """The devices this process computes on, in mesh order."""
        if self.process_index is None:
            return list(self.devices.flat)
        rows = self.shape[0] // self.n_processes
        mine = self.devices[self.process_index * rows:
                            (self.process_index + 1) * rows]
        return list(mine.flat)


def _visible_devices(device, n_devices: Optional[int]) -> List[torch.device]:
    """The devices a mesh is built from: every visible CUDA device (the
    default; none raises), or ``n_devices`` virtual CPU slots when the
    caller asks for the CPU."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu", i) for i in range(n_devices or 1)]
    if kind != "cuda":
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu', not {kind!r}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "no CUDA device is available for a mesh; pass device='cpu' "
            "for a mesh of virtual CPU slots")
    devices = [torch.device("cuda", i) for i in range(count)]
    if n_devices is not None:
        if n_devices > count:
            raise ValueError(f"n_devices={n_devices} exceeds the {count} "
                             "visible CUDA devices")
        devices = devices[:n_devices]
    return devices


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("dates",),
              shape: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """A 1-D (dates) or 2-D (benchmarks x dates) device mesh over the
    visible CUDA devices (default), or over ``n_devices`` virtual CPU
    slots with ``device="cpu"``."""
    listed = _visible_devices(device, n_devices)
    devices = np.empty(len(listed), dtype=object)
    devices[:] = listed
    if shape is None:
        shape = (len(listed),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("explicit `shape` required for a multi-axis mesh")
    return Mesh(devices.reshape(tuple(shape)), tuple(axis_names))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> int:
    """Join (or no-op into) a process group; returns the world size.

    With no arguments and no group, this is one process and returns 1.
    Otherwise it runs ``torch.distributed.init_process_group`` at
    ``tcp://<coordinator_address>`` (``host:port``; one process may
    leave it out and gets a free localhost port) with ``nccl`` on the
    card (the default) or ``gloo`` when the caller asks for the CPU.
    Safe to call again on an initialized group. An explicit
    ``num_processes > 1`` that the group does not match raises: N
    independent single-process runs would each solve the full batch
    alone, a silently degraded fleet."""
    import torch.distributed as dist

    explicit_multihost = num_processes is not None and num_processes > 1
    if not dist.is_initialized() and (num_processes is not None
                                      or coordinator_address is not None):
        world = 1 if num_processes is None else int(num_processes)
        if coordinator_address is None:
            if world > 1:
                raise ValueError("a group of several processes needs a "
                                 "coordinator_address (host:port)")
            coordinator_address = f"localhost:{_free_port()}"
        kind = "cuda" if device is None else torch.device(device).type
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for an nccl group; pass "
                "device='cpu' for a gloo group")
        dist.init_process_group(
            backend="nccl" if kind == "cuda" else "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=world, rank=int(process_id or 0))
    count = dist.get_world_size() if dist.is_initialized() else 1
    if explicit_multihost and count != num_processes:
        raise RuntimeError(
            f"requested num_processes={num_processes} but the group "
            f"reports {count}: refusing to run a silently-degraded fleet")
    return count


def make_multihost_mesh(axis_names: Tuple[str, ...] = ("hosts", "dates"),
                        ici_per_host: Optional[int] = None,
                        device=None,
                        local_devices: Optional[int] = None) -> Mesh:
    """Mesh for a fleet of processes: ``(processes, devices per
    process)``, the leading axis over processes. Every process is
    assumed to hold the same devices: the visible CUDA devices, or
    ``local_devices`` virtual CPU slots with ``device="cpu"``. With one
    process this is a ``(1, n_local)`` mesh running the same solve as a
    1-D one."""
    import torch.distributed as dist

    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mine = _visible_devices(device, local_devices)
    n_total = len(mine) * n_proc
    local = ici_per_host or max(1, n_total // n_proc)
    if n_total % local:
        raise ValueError(
            f"ici_per_host={local} must divide the device count "
            f"({n_total}) evenly")
    if ici_per_host is None and local * n_proc != n_total:
        raise ValueError(
            f"{n_total} devices across {n_proc} processes is not "
            "rectangular; pass ici_per_host explicitly")
    if local > n_total // n_proc:
        raise ValueError(
            f"ici_per_host={local} exceeds the {n_total // n_proc} "
            "devices attached to each process")
    # Each process's devices in order, process by process; a process
    # with more devices than ici_per_host spans several rows.
    rows = n_total // local
    grid = np.empty((rows, local), dtype=object)
    for r in range(rows):
        for c in range(local):
            grid[r, c] = mine[(r * local + c) % len(mine)]
    if n_proc == 1:
        return Mesh(grid, tuple(axis_names))
    return Mesh(grid, tuple(axis_names), process_index=rank,
                n_processes=n_proc)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """How one field lies on a mesh: the leading ``n_batch_axes`` axes
    split over the mesh's axes of the same names (``spec``), the rest
    replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def shard(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t``'s pieces, one per mesh device in row-major order, each
        on its device."""
        split = [a for a in self.spec if a is not None]
        mesh_shape = self.mesh.shape[:len(split)]
        pieces = np.empty(mesh_shape, dtype=object)
        for idx in np.ndindex(*mesh_shape):
            part = t
            for ax, (i, k) in enumerate(zip(idx, mesh_shape)):
                size = t.shape[ax]
                if size % k:
                    raise ValueError(
                        f"axis {ax} of length {size} does not divide "
                        f"evenly over {k} devices")
                step = size // k
                part = part.narrow(ax, i * step, step)
            pieces[idx] = part
        out = []
        for idx in np.ndindex(*self.mesh.shape):
            out.append(pieces[idx[:len(split)]].to(self.mesh.devices[idx]))
        return out


def batch_sharding(mesh: Mesh, rank: int,
                   n_batch_axes: int = 1) -> BatchSharding:
    """Sharding for one field: batch axes on the mesh, the rest
    replicated."""
    spec = (tuple(mesh.axis_names[:n_batch_axes])
            + (None,) * (rank - n_batch_axes))
    return BatchSharding(mesh, spec)


def shard_qp_batch(qp: CanonicalQP, mesh: Mesh,
                   n_batch_axes: int = 1) -> List[CanonicalQP]:
    """Split a stacked problem batch along its batch axes over the mesh:
    one :class:`CanonicalQP` per mesh device (row-major), each on its
    device. The leading axes must divide evenly (pad with
    :func:`pad_batch_to_mesh`)."""
    fields = [None if a is None
              else batch_sharding(mesh, a.dim(), n_batch_axes).shard(a)
              for a in qp]
    return [CanonicalQP(*(None if f is None else f[i] for f in fields))
            for i in range(mesh.size)]


def _trivial_problem_like(qp: CanonicalQP) -> CanonicalQP:
    """One near-free filler problem with the batch's shapes: identity
    objective, all constraint rows masked out, bounds pinning every
    variable to zero; ADMM converges on it in a handful of iterations,
    so mesh padding costs almost nothing."""
    n, m = qp.n, qp.m
    like = dict(dtype=qp.P.dtype, device=qp.P.device)
    zeros_n = torch.zeros((1, n), **like)
    # The filler keeps the batch's P == 2 Pf'Pf + diag(Pdiag) invariant:
    # with Pf present the filler factor is 0, so the dense P is
    # diag(Pdiag) when a diagonal completion exists (identity), else 0;
    # the lb = ub = 0 box pins the solution regardless.
    Pdiag_fill = None if qp.Pdiag is None else torch.ones((1, n), **like)
    if qp.Pf is not None and qp.Pdiag is None:
        P_fill = torch.zeros((1, n, n), **like)
    else:
        P_fill = torch.eye(n, **like)[None]
    return CanonicalQP(
        P=P_fill,
        q=zeros_n,
        C=torch.zeros((1, m, n), **like),
        l=torch.zeros((1, m), **like),
        u=torch.zeros((1, m), **like),
        lb=zeros_n,
        ub=zeros_n,
        var_mask=torch.ones((1, n), **like),
        row_mask=torch.zeros((1, m), **like),
        constant=torch.zeros((1,), **like),
        Pf=(None if qp.Pf is None
            else torch.zeros((1,) + tuple(qp.Pf.shape[-2:]), **like)),
        Pdiag=Pdiag_fill,
    )


def pad_batch_to_mesh(qp: CanonicalQP,
                      mesh_size: int) -> Tuple[CanonicalQP, int]:
    """Pad the leading axis to a multiple of the mesh size; returns
    ``(padded batch, real count)``. Filler slots are trivial
    pinned-to-zero problems, not copies of real ones: re-solving
    duplicated QPs would waste a full solve per padded slot."""
    n_real = qp.P.shape[0]
    rem = (-n_real) % mesh_size
    if rem == 0:
        return qp, n_real
    filler = _trivial_problem_like(qp)
    pad = CanonicalQP(*(
        None if a is None else torch.cat(
            [a, f.expand((rem,) + tuple(f.shape[1:]))], dim=0)
        for a, f in zip(qp, filler)))
    return pad, n_real


def run_on_devices(fn: Callable, jobs: Sequence[tuple],
                   devices: Sequence[torch.device]) -> list:
    """``[fn(*job) for job in jobs]``, job ``i`` on ``devices[i]``: on a
    host thread per device where several CUDA devices take part (each
    job's segment loop syncs on its own device), else inline in order."""
    def one(job, dev):
        if dev.type != "cuda":
            return fn(*job)
        with torch.cuda.device(dev):
            return fn(*job)

    cuda = {d for d in devices if d.type == "cuda"}
    if len(cuda) < 2:
        return [one(job, dev) for job, dev in zip(jobs, devices)]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(one, job, dev)
                   for job, dev in zip(jobs, devices)]
        return [f.result() for f in futures]


def gather(parts: Sequence, device: torch.device, dim: int = 0):
    """Concatenate per-device outputs (tensors or named tuples of them,
    ``None`` leaves kept) along ``dim`` on ``device``."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts], dim=dim)
    fields = [gather(list(f), device, dim) for f in zip(*parts)]
    return type(first)(*fields)


def _all_gather(sol: QPSolution, device: torch.device) -> QPSolution:
    """Every process's rows of the solution, in process order: one
    ``all_gather`` per field, the only collective of a multi-process
    solve."""
    import torch.distributed as dist

    world = dist.get_world_size()
    fields = []
    for t in sol:
        if t is None:
            fields.append(None)
            continue
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        fields.append(torch.cat(parts, dim=0).to(device))
    return QPSolution(*fields)


def solve_qp_sharded(qp: CanonicalQP,
                     mesh: Mesh,
                     params: SolverParams = SolverParams()) -> QPSolution:
    """Solve a stacked batch with its leading axis split over the mesh:
    pad it to a multiple of the mesh size, solve each device's rows
    with :func:`solve_qp_batch` on that device, gather the results on
    the mesh's first device and drop the filler slots. On a
    multi-process mesh this process solves its own rows and the rows
    of every process are gathered with one ``all_gather``."""
    qp, n_real = pad_batch_to_mesh(qp, mesh.size)
    devices = mesh.local_devices
    if mesh.process_index is not None:
        per = qp.P.shape[0] // mesh.size
        start = mesh.process_index * len(devices) * per
        rows = slice(start, start + len(devices) * per)
        qp = CanonicalQP(*(None if a is None else a[rows] for a in qp))
    per = qp.P.shape[0] // len(devices)
    shards = [CanonicalQP(*(None if a is None else a[i * per:(i + 1) * per]
                            for a in qp)) for i in range(len(devices))]
    sols = run_on_devices(
        lambda shard, dev: solve_qp_batch(shard, params, device=dev),
        [(s, d) for s, d in zip(shards, devices)], devices)
    sol = gather(sols, devices[0])
    if mesh.process_index is not None:
        sol = _all_gather(sol, devices[0])
    return QPSolution(*(None if a is None else a[:n_real] for a in sol))
