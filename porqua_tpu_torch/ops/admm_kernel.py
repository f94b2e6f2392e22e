"""Fused ADMM segment: the hand-written CUDA kernels, their plain
PyTorch twins, and the wrappers that choose between them.

What the kernels replace: the two Pallas TPU kernels of
``porqua_tpu/ops/admm_kernel.py``: ``admm_segment`` (a dense operator,
``L^-1`` applied twice with ``triangular=True`` or the refined explicit
``K^-1`` once) and ``admm_segment_factored`` (the Woodbury capacitance
operator ``W, inv_d, Y0, Ginv``, plus ``V, Dv`` for in-kernel
refinement). Each runs ``n_iters`` OSQP iterations for every problem of
a batch in one launch and returns ``(x, z, w, y, mu, dx, dy, dmu)``:
the final state and the increments between the last two iterates.

The forms, in three sources:

- ``"cluster"``: ``csrc/admm_segment_cluster.cu`` (the factored form on
  a cluster of 8 blocks per problem: the columns of W, and V, C and Y0,
  split across the blocks' shared memory, read from device memory once
  per launch; the three reductions of an iteration go through
  distributed shared memory) and ``csrc/admm_segment_dense_cluster.cu``
  (the dense forms on a cluster per problem: L^-1's lower columns
  interleaved across 8 blocks, or 16 where a rank's share does not fit
  at 8, or K^-1's columns across 16, held in shared memory and read
  once per launch; one n-long and one m-long exchange per iteration).
- ``"tail"``, the dense cluster with a streamed tail
  (``admm_segment_dense_cluster.cu``, K^-1 only): where a 16th of K^-1
  does not fit a block, each rank keeps the first rows of its slice in
  shared memory and reads the others from device memory (through L2)
  on every iteration, through a ring of asynchronous copies.
- ``"stream"``: ``csrc/admm_segment.cu``, one block per problem, the
  operator (L^-1's lower half twice, K^-1 once, W twice; V twice more
  per refinement round) streamed from device memory on every
  iteration. The dense form reads C from device memory beside it and
  keeps only O(n + m) floats in shared memory; the factored form keeps
  C, Y0 and Ginv there too.
- ``"grid"``, the factored form on G clusters of 8 blocks per problem
  (``admm_segment_cluster.cu``, ``cluster_kernel<Form::grid>``): the
  cluster form's resident column slices over 8 G blocks, each
  reduction summed over the cluster and then over the G clusters
  through a zeroed scratch buffer in device memory; all B G clusters
  must be resident at once, so the router reads the batch width.
- ``"global"``, the factored device-memory form, for the shapes where
  none of the others fits: the cluster kernel with W, V, C, Y0 and
  Ginv read from device memory on every iteration
  (``admm_segment_cluster.cu``, ``cluster_kernel<Form::device>``), a
  block's slices of the vectors alone in shared memory.

:func:`factored_form` and :func:`dense_form` choose a kernel by shape
(and, for the grid form, batch width), before the launch, in that
order: the cluster form where its shared memory fits a block and the
card can hold such a cluster, else (dense) the cluster with a streamed
tail where that fits and can be held, else the streaming form where
that fits, else (factored) the grid form where its slices fit at some
G and the card can hold B G of its clusters at once, else the
device-memory form where it fits and its cluster can be held, else
they raise. The dense streaming form and the factored device-memory
form cover every shape at which the JAX package's ``_segment_plan``
takes its Pallas kernel without a VMEM footprint warning
(tests/test_torch_cluster_route.py).

Each is built by :mod:`porqua_tpu_torch.ops._build` on first use. The
wrappers take the plain twin only for tensors on the CPU; for CUDA
tensors they launch a kernel or raise. Each wrapper counts its launches
in a plain int attribute, ``launches``, and each form's own
(``cluster_launches``, ``stream_launches``, the dense wrapper's
``tail_launches`` and the factored wrapper's ``grid_launches`` and
``global_launches``), and
keeps them by batch width in a dict, ``widths`` (width -> launches).
Each launch also reports its :func:`launch_cost` to the device-cost
counter that ``obs/devprof.py`` has active on the calling thread, if
any.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from porqua_tpu_torch.ops import _build
from porqua_tpu_torch.qp.admm import (_make_iteration, _mv, _vm,
                                      factored_solve_from_pieces)

_LIB = "admm_segment"
_CLUSTER_LIB = "admm_segment_cluster"
_DENSE_LIB = "admm_segment_dense_cluster"
LIBRARIES = (_LIB, _CLUSTER_LIB, _DENSE_LIB)


# --------------------------------------------------------------------------
# Plain PyTorch twins
# --------------------------------------------------------------------------

def _run_segment(one_iteration, n_iters, carry0):
    """``n_iters`` iterations, then the final state and the increments
    between the last two iterates."""
    carry = carry0
    for _ in range(n_iters - 1):
        carry = one_iteration(carry)
    x, z, w, y, mu = one_iteration(carry)
    return x, z, w, y, mu, x - carry[0], y - carry[3], mu - carry[4]


def admm_segment_ref(Kinv, C, q, l, u, lb, ub, rho, rho_b, l1w, l1c,
                     x, z, w, y, mu, *, sigma: float, alpha: float,
                     n_iters: int, triangular: bool = False):
    """Plain version of :func:`admm_segment`: the same batched
    arithmetic in eager torch. With ``triangular`` ``Kinv`` holds
    ``L^-1`` and ``xt = L^-T (L^-1 rhs)``; otherwise ``xt = rhs @ Kinv``."""
    if triangular:
        def solve_fn(rhs):
            return _vm(_mv(Kinv, rhs), Kinv)
    else:
        def solve_fn(rhs):
            return _vm(rhs, Kinv)
    one_iteration = _make_iteration(solve_fn, C, q, l, u, lb, ub, rho,
                                    rho_b, l1w, l1c, sigma, alpha)
    return _run_segment(one_iteration, n_iters, (x, z, w, y, mu))


def admm_segment_factored_ref(W, inv_d, Y0, Ginv, V, Dv, C, q, l, u, lb,
                              ub, rho, rho_b, l1w, l1c, x, z, w, y, mu, *,
                              sigma: float, alpha: float, n_iters: int,
                              refine_steps: int = 0):
    """Plain version of :func:`admm_segment_factored`:

        base(r) = inv_d * r - (W r) W   (+ refine_steps rounds against
                                         K = diag(Dv) + V'V)
        xt = x0 - Y0 (Ginv (C x0))
    """
    psolve0 = factored_solve_from_pieces(Dv, V, inv_d, W, refine_steps)

    def solve_fn(rhs):
        x0 = psolve0(rhs)
        return x0 - _mv(Y0, _vm(_mv(C, x0), Ginv))

    one_iteration = _make_iteration(solve_fn, C, q, l, u, lb, ub, rho,
                                    rho_b, l1w, l1c, sigma, alpha)
    return _run_segment(one_iteration, n_iters, (x, z, w, y, mu))


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

_FACTORED_ARGS = [ctypes.c_void_p] * 29 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]
_DENSE_ARGS = [ctypes.c_void_p] * 24 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# The dense cluster launchers take one more int after n_iters: the rank
# count (cluster) or resident rows (tail) to force, or -1 for the ones
# the shape takes.
_DENSE_CLUSTER_ARGS = _DENSE_ARGS[:28] + [ctypes.c_int] + _DENSE_ARGS[28:]
# The factored grid launcher takes one more pointer (its zeroed scratch)
# and one more int after n_iters (the group count G).
_GRID_ARGS = ([ctypes.c_void_p] + _FACTORED_ARGS[:34] + [ctypes.c_int]
              + _FACTORED_ARGS[34:])
_SIGNATURES = {
    _LIB: {
        "porqua_admm_segment_dense": _DENSE_ARGS,
        "porqua_admm_segment_factored": _FACTORED_ARGS,
        "porqua_admm_segment_smem_bytes": [ctypes.c_int] * 4,
        "porqua_max_smem_optin": [],
        "porqua_cuda_error_string": [ctypes.c_int],
    },
    _CLUSTER_LIB: {
        "porqua_admm_segment_factored_cluster": _FACTORED_ARGS,
        "porqua_admm_segment_factored_global": _FACTORED_ARGS,
        "porqua_admm_segment_factored_grid": _GRID_ARGS,
        "porqua_admm_cluster_smem_bytes": [ctypes.c_int] * 4,
        "porqua_admm_cluster_max_active": [ctypes.c_int] * 4,
        "porqua_admm_cluster_global_smem_bytes": [ctypes.c_int] * 4,
        "porqua_admm_cluster_global_max_active": [ctypes.c_int] * 4,
        "porqua_admm_cluster_grid_smem_bytes": [ctypes.c_int] * 5,
        "porqua_admm_cluster_grid_max_active": [ctypes.c_int] * 5,
        "porqua_admm_cluster_grid_groups": [ctypes.c_int] * 5,
        "porqua_admm_cluster_grid_scratch_floats": [ctypes.c_int] * 3,
    },
    _DENSE_LIB: {
        "porqua_admm_segment_dense_cluster": _DENSE_CLUSTER_ARGS,
        "porqua_admm_segment_dense_tail": _DENSE_CLUSTER_ARGS,
        "porqua_admm_dense_cluster_ranks": [ctypes.c_int] * 3,
        "porqua_admm_dense_cluster_smem_bytes": [ctypes.c_int] * 3,
        "porqua_admm_dense_cluster_max_active": [ctypes.c_int] * 3,
        "porqua_admm_dense_tail_rows": [ctypes.c_int] * 3,
        "porqua_admm_dense_tail_smem_bytes": [ctypes.c_int] * 3,
        "porqua_admm_dense_tail_max_active": [ctypes.c_int] * 3,
    },
}
# form -> (library, launcher)
_FACTORED_LAUNCHER = {
    "cluster": (_CLUSTER_LIB, "porqua_admm_segment_factored_cluster"),
    "stream": (_LIB, "porqua_admm_segment_factored"),
    "grid": (_CLUSTER_LIB, "porqua_admm_segment_factored_grid"),
    "global": (_CLUSTER_LIB, "porqua_admm_segment_factored_global"),
}
_DENSE_LAUNCHER = {
    "cluster": (_DENSE_LIB, "porqua_admm_segment_dense_cluster"),
    "tail": (_DENSE_LIB, "porqua_admm_segment_dense_tail"),
    "stream": (_LIB, "porqua_admm_segment_dense"),
}


def _library(name: str = _LIB) -> ctypes.CDLL:
    lib = _build.library(name)
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = (ctypes.c_char_p if fn_name.endswith("error_string")
                      else ctypes.c_int)
    return lib


def _check(tensors, shapes):
    """Validate a call: one device, one dtype, contiguous, the expected
    shapes. CUDA tensors must be float32 (the kernels' only type)."""
    ref = tensors[0]
    for t, shape in zip(tensors, shapes):
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(
                "fused segment inputs must share one device and dtype; got "
                f"{t.device}/{t.dtype} beside {ref.device}/{ref.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused segment input of shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError("fused segment inputs must be contiguous")
    if ref.device.type == "cuda" and ref.dtype != torch.float32:
        raise TypeError(f"the CUDA fused segment takes float32, got {ref.dtype}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused segment for device {ref.device}")


@contextlib.contextmanager
def _on_card(device):
    """Make ``device`` current; yields its current stream's handle."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def _cuda_error(code: int) -> str:
    text = _library().porqua_cuda_error_string(code).decode()
    return f"CUDA error {code} ({text})"


def _launch(lib, fn_name, stream, inputs, outs, ints, sigma, alpha, flag):
    ptrs = [t.data_ptr() for t in inputs + outs]
    rc = getattr(lib, fn_name)(*ptrs, *ints, sigma, alpha, 1.0 - alpha, flag,
                               stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: {_cuda_error(rc)}")


def _smem_refusal(form, need, limit, n, m, k):
    return (f"the {form} fused segment needs {need} bytes of shared memory "
            f"per block (n={n}, m={m}, k={k}); the card allows {limit}")


def _occupancy(active):
    """``active``, the answer of a cluster occupancy query; raises where
    it is a CUDA error code (negative)."""
    if active < 0:
        raise RuntimeError("cluster occupancy query failed: "
                           f"{_cuda_error(-active)}")
    return active


def _choose_form(kind, candidates, n, m, k):
    """The first of ``candidates`` (an iterable, read lazily), ``(form,
    bytes of shared memory per block, occupancy query or None, clusters
    needed at once)`` in order of preference, whose bytes fit a block
    of the card and whose query (the clusters the card can hold at
    once) is at least the clusters it needs; raises ValueError where
    none fits."""
    limit = _library(_LIB).porqua_max_smem_optin()
    least = None
    for form, need, active_clusters, clusters in candidates:
        least = need if least is None else min(least, need)
        if need > limit:
            continue
        if (active_clusters is not None
                and _occupancy(active_clusters()) < clusters):
            continue
        return form
    raise ValueError(_smem_refusal(kind, least, limit, n, m, k))


def launch_cost(name, args, kw):
    """(flops, bytes) one launch's function needs: every matvec of
    every iteration, each input read once (L^-1: its lower triangle, V
    and Dv only when refining), each output written once. Elementwise
    updates (~30 flops per entry) are left out: under 1%. ``name``
    starting with ``admm_segment_factored`` is K1, any other K2 or K3;
    ``args``/``kw`` are the wrapper's. These counts are the bound of
    ``chip_smoke.py``'s kernel rows and the kernel part of a
    CostRecord (``obs/devprof.py``)."""
    if name.startswith("admm_segment_factored"):
        W, inv_d, Y0, Ginv, V, Dv, C = args[:7]
        B, k, n = W.shape
        m = C.shape[-2]
        r = kw["refine_steps"]
        per_iter = 4 * k * n * (1 + 2 * r) + 2 * m * n * 3 + 2 * m * m + 2 * n * m
        inputs = [a for i, a in enumerate(args) if r or i not in (4, 5)]
        nbytes = sum(a.numel() for a in inputs) * 4
    else:
        op, C = args[:2]
        B, n, _ = op.shape
        m = C.shape[-2]
        if kw["triangular"]:
            per_iter = 2 * n * (n + 1) + 4 * m * n
            op_bytes = B * n * (n + 1) // 2 * 4
        else:
            per_iter = 2 * n * n + 4 * m * n
            op_bytes = op.numel() * 4
        nbytes = op_bytes + sum(a.numel() for a in args[1:]) * 4
    nbytes += B * (5 * n + 3 * m) * 4     # x z w y mu dx dy dmu
    return B * kw["n_iters"] * per_iter, nbytes


def launch_traffic(name, args, kw, form, level="device"):
    """Bytes the kernel ``form`` moves per launch by a model of its
    access pattern (not a measurement), through device memory
    (``level="device"``) or through L2 (``"l2"``). The cluster forms
    read each input once. The dense cluster with a streamed tail reads
    each input once and the rows of K^-1 past those each rank keeps (the
    card's library says how many at this shape) again on every
    iteration. The other forms read their operator on every
    iteration (W twice, V twice more per refinement round, L^-1's lower
    triangle twice, K^-1 once) and, where it is not in shared memory,
    C: twice in the dense streaming form; three times in the factored
    device-memory form, with Y0 once and Ginv once per block. Through
    L2 all of that counts. From device memory the model counts the
    matrices read again once where they fit together in the L2 of the
    inputs' card (its ``L2_cache_size``), else as through L2. The grid
    form reads each input once from device memory; through L2 it also
    moves, on every iteration, its 3 + 2 refine_steps exchanges (k long
    for W r and V x0, 2 m floats for the f64 C x0, m for C xt): G
    partials written and read by each of its 8 G blocks, at the
    router's G for this batch width. All write each output once."""
    once = launch_cost(name, args, kw)[1]
    if form == "cluster" or (form == "grid" and level == "device"):
        return once
    if form == "grid":
        W, C = args[0], args[6]
        (B, k, n), m, r = W.shape, C.shape[-2], kw["refine_steps"]
        groups = _grid_groups(_library(_CLUSTER_LIB), (n, m, k, r), B)
        floats = (1 + 2 * r) * k + 3 * m
        return (once + kw["n_iters"] * B * groups * floats * 4
                * (1 + 8 * groups))
    op, n_iters = args[0], kw["n_iters"]
    if form == "tail":
        B, n, _ = op.shape
        rows = _library(_DENSE_LIB).porqua_admm_dense_tail_rows(
            n, args[1].shape[-2], int(kw["triangular"]))
        per_iter = again = B * (n - rows) * n * 4
    elif name.startswith("admm_segment_factored"):
        Y0, Ginv, C = args[2], args[3], args[6]
        r = kw["refine_steps"]
        per_iter = (2 + 4 * r) * op.numel() * 4
        mats = [op] + ([args[4]] if r else [])       # W (and V)
        if form == "global":
            per_iter += (3 * C.numel() + Y0.numel() + 8 * Ginv.numel()) * 4
            mats += [Y0, Ginv, C]
        again = sum(a.numel() for a in mats) * 4
    else:
        C = args[1]
        B, n, _ = op.shape
        op_bytes = (B * n * (n + 1) // 2 * 4 if kw["triangular"]
                    else op.numel() * 4)
        per_iter = ((2 if kw["triangular"] else 1) * op_bytes
                    + 2 * C.numel() * 4)
        again = op_bytes + C.numel() * 4
    if (level == "device" and again
            <= torch.cuda.get_device_properties(op.device).L2_cache_size):
        return once
    return once + n_iters * per_iter - again


def _count(wrapper, form, width, inputs, kw):
    wrapper.launches += 1
    wrapper.widths[width] = wrapper.widths.get(width, 0) + 1
    if form == "cluster":
        wrapper.cluster_launches += 1
    elif form == "stream":
        wrapper.stream_launches += 1
    elif form == "tail":
        wrapper.tail_launches += 1
    elif form == "grid":
        wrapper.grid_launches += 1
    else:
        wrapper.global_launches += 1
    # Local import: the obs package imports the solver, which imports
    # this module.
    from porqua_tpu_torch.obs import devprof

    counter = devprof.active_counter()
    if counter is not None:
        name = wrapper.__name__
        counter.kernel(name, form, *launch_cost(name, inputs, kw))


def dense_form(n: int, m: int, triangular: bool) -> str:
    """Which hand-written kernel runs a dense segment of this shape on
    the current card: ``"cluster"`` where one problem's operator slice
    (L^-1's packed lower columns over 8 blocks, else over 16, or K^-1's
    columns over 16; the library's
    ``porqua_admm_dense_cluster_ranks`` says which) fits the shared
    memory of a block and the card can hold such a cluster, else
    ``"tail"`` (K^-1 only) where the slice's first rows, C's slice and
    the vectors fit and the card can hold that cluster, else
    ``"stream"`` where the streaming form's vectors fit one block.
    Raises ValueError where none fits."""
    lib, stream_lib = _library(_DENSE_LIB), _library(_LIB)
    tri = int(triangular)
    return _choose_form("dense", [
        ("cluster", lib.porqua_admm_dense_cluster_smem_bytes(n, m, tri),
         lambda: lib.porqua_admm_dense_cluster_max_active(n, m, tri), 1),
        ("tail", lib.porqua_admm_dense_tail_smem_bytes(n, m, tri),
         lambda: lib.porqua_admm_dense_tail_max_active(n, m, tri), 1),
        ("stream", stream_lib.porqua_admm_segment_smem_bytes(0, n, m, 0),
         None, 1)], n, m, 0)


def _dense_inputs(Kinv, C, q, l, u, lb, ub, rho, rho_b, l1w, l1c, x, z, w,
                  y, mu, n_iters):
    """Validate a dense call; returns its inputs as a list."""
    B, n = x.shape
    m = z.shape[-1]
    if n_iters < 1:
        raise ValueError("n_iters must be at least 1")
    vn, vm = (B, n), (B, m)
    inputs = [Kinv, C, q, l, u, lb, ub, rho, rho_b, l1w, l1c, x, z, w, y, mu]
    _check(inputs, [(B, n, n), (B, m, n), vn, vm, vm, vn, vn, vm, vn, vn,
                    vn, vn, vm, vn, vm, vn])
    return inputs


def _dense_on_card(form, inputs, *, sigma: float, alpha: float,
                   n_iters: int, triangular: bool, layout=None):
    """Launch one dense kernel on validated inputs: the one ``form``
    names, or with ``form=None`` the one :func:`dense_form` picks.
    ``layout`` forces a cluster form's rank count or a tail form's
    resident rows (None: the ones the shape takes)."""
    x, z = inputs[11], inputs[12]
    (B, n), m = x.shape, z.shape[-1]
    # x z w y mu, then the increments dx dy dmu
    outs = [torch.empty_like(inputs[i]) for i in (11, 12, 13, 14, 15, 11,
                                                  14, 15)]
    with _on_card(x.device) as stream:
        if form is None:
            form = dense_form(n, m, triangular)
        lib_name, fn_name = _DENSE_LAUNCHER[form]
        ints = (B, n, m, n_iters)
        if form != "stream":
            ints += (-1 if layout is None else layout,)
        _launch(_library(lib_name), fn_name, stream, inputs, outs, ints,
                sigma, alpha, int(triangular))
    _count(admm_segment, form, B, inputs,
           dict(sigma=sigma, alpha=alpha, n_iters=n_iters,
                triangular=triangular))
    return tuple(outs)


def admm_segment(Kinv, C, q, l, u, lb, ub, rho, rho_b, l1w, l1c,
                 x, z, w, y, mu, *, sigma: float, alpha: float,
                 n_iters: int, triangular: bool = False):
    """Run ``n_iters`` fused ADMM iterations on a batch of scaled
    problems with a dense operator: ``Kinv`` (B, n, n) holds ``L^-1``
    (``triangular=True``) or the explicit ``K^-1``. ``C`` is (B, m, n),
    the vectors (B, n) or (B, m). On the card the kernel is chosen by
    :func:`dense_form`. Returns ``(x, z, w, y, mu, dx, dy, dmu)``."""
    inputs = _dense_inputs(Kinv, C, q, l, u, lb, ub, rho, rho_b, l1w, l1c,
                           x, z, w, y, mu, n_iters)
    kw = dict(sigma=sigma, alpha=alpha, n_iters=n_iters,
              triangular=triangular)
    if x.device.type == "cpu":
        return admm_segment_ref(*inputs, **kw)
    return _dense_on_card(None, inputs, **kw)


admm_segment.launches = 0          # every form
admm_segment.widths = {}           # batch width -> launches
admm_segment.cluster_launches = 0
admm_segment.tail_launches = 0
admm_segment.stream_launches = 0


def _admm_segment_form(form: str, *args, sigma: float, alpha: float,
                       n_iters: int, triangular: bool = False,
                       ranks: int | None = None, rows: int | None = None):
    """:func:`admm_segment` on the card through the kernel ``form``
    names ("cluster", "tail" or "stream") instead of the one chosen by
    shape, so that every form can be held against the plain twin and
    timed on the same inputs. ``ranks`` (cluster: 8 or 16 blocks) and
    ``rows`` (tail: the rows each rank keeps, 0 to n) force a layout
    the shape would not take, so that each can be held at any width."""
    if form not in _DENSE_LAUNCHER:
        raise ValueError(f"no dense kernel form {form!r}")
    if (ranks is not None and form != "cluster") or (
            rows is not None and form != "tail"):
        raise ValueError(f"the {form} form takes no "
                         f"{'ranks' if ranks is not None else 'rows'}")
    inputs = _dense_inputs(*args, n_iters)
    if inputs[0].device.type != "cuda":
        raise ValueError("a named kernel form runs on a CUDA device only")
    return _dense_on_card(form, inputs, sigma=sigma, alpha=alpha,
                          n_iters=n_iters, triangular=triangular,
                          layout=ranks if ranks is not None else rows)


def factored_form(n: int, m: int, k: int, refine_steps: int, *,
                  batch: int) -> str:
    """Which hand-written kernel runs a factored segment of ``batch``
    problems of this shape on the current card: ``"cluster"`` where one
    problem's column slices fit the shared memory of a block and the
    card can hold such an 8-block cluster, else ``"stream"`` where the
    streaming form's state fits one block, else ``"grid"`` where the
    slices fit over G clusters and the card can hold ``batch`` G of
    them at once, else ``"global"`` where a block's slices of the
    vectors alone fit and the card can hold its cluster. Raises
    ValueError where none fits.

    The grid's G (the library's ``porqua_admm_cluster_grid_groups``) is
    the fewest groups, up to 16, whose slices fit a block and of which
    the card holds ``batch`` G clusters at once. Raced against as many
    groups as the card holds for one problem
    (``scripts/torch_form_race.py``, H100 80GB HBM3 at 700 W, B = 1,
    refine 0), it takes 0.743-0.807 ms (G = 7) against 0.765-0.861
    (G = 16) at 5,000 x 504 and 0.606-0.623 (G = 4) against
    0.619-0.624 at 5,000 x 256: as fast within the noise, on fewer
    SMs."""
    return _factored_route(n, m, k, refine_steps, batch)[0]


def _grid_groups(lib, shape, batch):
    """The grid form's G for ``batch`` problems of ``shape`` (0 where it
    has none); raises where the occupancy query fails."""
    return _occupancy(lib.porqua_admm_cluster_grid_groups(*shape, batch))


def _factored_route(n, m, k, refine_steps, batch):
    """(form, G) of :func:`factored_form`; G is None but for the grid."""
    lib = _library(_CLUSTER_LIB)
    shape = (n, m, k, refine_steps)
    groups = []

    def candidates():
        yield ("cluster", lib.porqua_admm_cluster_smem_bytes(*shape),
               lambda: lib.porqua_admm_cluster_max_active(*shape), 1)
        yield ("stream",
               _library(_LIB).porqua_admm_segment_smem_bytes(1, n, m, k),
               None, 1)
        g = _grid_groups(lib, shape, batch)
        if g:
            groups.append(g)
            yield ("grid", lib.porqua_admm_cluster_grid_smem_bytes(*shape, g),
                   lambda: lib.porqua_admm_cluster_grid_max_active(*shape, g),
                   batch * g)
        yield ("global", lib.porqua_admm_cluster_global_smem_bytes(*shape),
               lambda: lib.porqua_admm_cluster_global_max_active(*shape), 1)

    form = _choose_form("factored", candidates(), n, m, k)
    return form, (groups[0] if form == "grid" else None)


def _factored_inputs(W, inv_d, Y0, Ginv, V, Dv, C, q, l, u, lb, ub, rho,
                     rho_b, l1w, l1c, x, z, w, y, mu, n_iters, refine_steps):
    """Validate a factored call; returns its inputs as a list."""
    B, n = x.shape
    m = z.shape[-1]
    k = W.shape[-2]
    if n_iters < 1 or refine_steps < 0:
        raise ValueError("n_iters must be at least 1 and refine_steps >= 0")
    vn, vm = (B, n), (B, m)
    inputs = [W, inv_d, Y0, Ginv, V, Dv, C, q, l, u, lb, ub, rho, rho_b,
              l1w, l1c, x, z, w, y, mu]
    _check(inputs, [(B, k, n), vn, (B, n, m), (B, m, m), (B, k, n), vn,
                    (B, m, n), vn, vm, vm, vn, vn, vm, vn, vn, vn, vn, vm,
                    vn, vm, vn])
    return inputs


def _grid_scratch(lib, shape, batch, groups, device):
    """The grid form's zeroed scratch for ``batch`` problems on ``groups``
    groups, after checking that its slices fit a block and that the card
    holds ``batch`` ``groups`` of its clusters at once (a group that is
    not resident would never be waited for): ValueError otherwise."""
    n, m, k, refine = shape
    if not 1 <= groups <= 16:
        raise ValueError(f"the grid fused segment takes 1 to 16 groups, "
                         f"not {groups} (n={n}, m={m}, k={k})")
    need = lib.porqua_admm_cluster_grid_smem_bytes(*shape, groups)
    limit = _library(_LIB).porqua_max_smem_optin()
    if need > limit:
        raise ValueError(_smem_refusal(f"grid (G={groups})", need, limit,
                                       n, m, k))
    active = _occupancy(lib.porqua_admm_cluster_grid_max_active(*shape,
                                                                groups))
    if batch * groups > active:
        raise ValueError(f"the grid fused segment needs {batch * groups} "
                         f"clusters resident at once (B={batch}, "
                         f"G={groups}); the card holds {active}")
    floats = lib.porqua_admm_cluster_grid_scratch_floats(m, k, groups)
    return torch.zeros(batch * floats, dtype=torch.float32, device=device)


def _factored_on_card(form, inputs, *, sigma: float, alpha: float,
                      n_iters: int, refine_steps: int, groups=None):
    """Launch one factored kernel on validated inputs: the one ``form``
    names, or with ``form=None`` the one :func:`factored_form` picks.
    ``groups`` forces the grid form's G (None: the router's)."""
    W, x, z = inputs[0], inputs[16], inputs[17]
    (B, n), m, k = x.shape, z.shape[-1], W.shape[-2]
    shape = (n, m, k, refine_steps)
    # x z w y mu, then the increments dx dy dmu
    outs = [torch.empty_like(inputs[i])
            for i in (16, 17, 18, 19, 20, 16, 19, 20)]
    with _on_card(x.device) as stream:
        if form is None:
            form, groups = _factored_route(*shape, B)
        lib_name, fn_name = _FACTORED_LAUNCHER[form]
        lib = _library(lib_name)
        ints = (B, n, m, k, n_iters)
        if form == "grid":
            if groups is None:
                groups = _grid_groups(lib, shape, B)
            ints += (groups,)
            outs.append(_grid_scratch(lib, shape, B, groups, x.device))
        _launch(lib, fn_name, stream, inputs, outs, ints, sigma, alpha,
                int(refine_steps))
    _count(admm_segment_factored, form, B, inputs,
           dict(sigma=sigma, alpha=alpha, n_iters=n_iters,
                refine_steps=refine_steps))
    return tuple(outs[:8])


def admm_segment_factored(W, inv_d, Y0, Ginv, V, Dv, C, q, l, u, lb, ub,
                          rho, rho_b, l1w, l1c, x, z, w, y, mu, *,
                          sigma: float, alpha: float, n_iters: int,
                          refine_steps: int = 0):
    """Run ``n_iters`` fused ADMM iterations on a batch of scaled
    problems with the factored (capacitance/Woodbury) operator: ``W``
    and ``V`` (B, k, n), ``inv_d`` and ``Dv`` (B, n), ``Y0`` (B, n, m),
    ``Ginv`` (B, m, m). ``V``/``Dv`` are read only when
    ``refine_steps > 0``. On the card the kernel is chosen by
    :func:`factored_form`. Returns ``(x, z, w, y, mu, dx, dy, dmu)``."""
    inputs = _factored_inputs(W, inv_d, Y0, Ginv, V, Dv, C, q, l, u, lb, ub,
                              rho, rho_b, l1w, l1c, x, z, w, y, mu, n_iters,
                              refine_steps)
    kw = dict(sigma=sigma, alpha=alpha, n_iters=n_iters,
              refine_steps=refine_steps)
    if x.device.type == "cpu":
        return admm_segment_factored_ref(*inputs, **kw)
    return _factored_on_card(None, inputs, **kw)


admm_segment_factored.launches = 0          # every form
admm_segment_factored.widths = {}           # batch width -> launches
admm_segment_factored.cluster_launches = 0
admm_segment_factored.stream_launches = 0
admm_segment_factored.grid_launches = 0
admm_segment_factored.global_launches = 0


def _admm_segment_factored_form(form: str, *args, sigma: float, alpha: float,
                                n_iters: int, refine_steps: int = 0,
                                groups: int | None = None):
    """:func:`admm_segment_factored` on the card through the kernel
    ``form`` names ("cluster", "stream", "grid" or "global") instead of
    the one chosen by shape, so that every form can be held against the
    plain twin and timed on the same inputs. ``groups`` (grid: 1 to 16
    clusters per problem) forces a G the router would not take; it
    raises where those clusters cannot all be resident at once."""
    if form not in _FACTORED_LAUNCHER:
        raise ValueError(f"no factored kernel form {form!r}")
    if groups is not None and form != "grid":
        raise ValueError(f"the {form} form takes no groups")
    inputs = _factored_inputs(*args, n_iters, refine_steps)
    if inputs[0].device.type != "cuda":
        raise ValueError("a named kernel form runs on a CUDA device only")
    return _factored_on_card(form, inputs, sigma=sigma, alpha=alpha,
                             n_iters=n_iters, refine_steps=refine_steps,
                             groups=groups)
