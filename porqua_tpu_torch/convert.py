"""Carry problems, solver settings and solver state across from the
JAX package: plain numpy arrays and dicts in, the port's types out.
Callers convert a JAX ``NamedTuple`` with
``{k: np.asarray(v) for k, v in t._asdict().items() if v is not None}``
and a ``SolverParams`` with ``dataclasses.asdict``."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from porqua_tpu_torch.qp.admm import ADMMState, SolverParams
from porqua_tpu_torch.qp.canonical import CanonicalQP


def _tensors(cls, fields: Mapping[str, np.ndarray], device):
    unknown = set(fields) - set(cls._fields)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**{k: None if v is None else torch.tensor(
        np.asarray(v), device=device) for k, v in fields.items()})


def qp_from_numpy(fields: Mapping[str, np.ndarray], device) -> CanonicalQP:
    """A :class:`CanonicalQP` from a JAX ``CanonicalQP._asdict()`` whose
    arrays went through ``np.asarray``; dtypes are kept."""
    return _tensors(CanonicalQP, fields, device)


def params_from_dict(d: Mapping) -> SolverParams:
    """A :class:`SolverParams` from ``dataclasses.asdict`` of the JAX
    one; an unknown field raises ``TypeError``."""
    return SolverParams(**d)


def state_from_numpy(fields: Mapping[str, np.ndarray], device) -> ADMMState:
    """An :class:`ADMMState` from a JAX ``ADMMState._asdict()`` whose
    arrays went through ``np.asarray``; dtypes are kept."""
    return _tensors(ADMMState, fields, device)


def batch_from_numpy(qp_fields: Mapping[str, np.ndarray], device="cpu",
                     l1_weight=None, l1_center=None, **meta):
    """A :class:`porqua_tpu_torch.batch.BatchProblems` from the JAX
    package's ``BatchProblems``: its stacked ``CanonicalQP._asdict()``
    through ``np.asarray``, its ``l1_weight``/``l1_center`` (arrays or
    None) and its host fields (``rebdates``, ``universes``,
    ``n_assets_max``, ``turnover_rows``, ``constants``) as keywords
    (an unknown one raises ``TypeError``); dtypes are kept."""
    from porqua_tpu_torch.batch import BatchProblems

    as_t = lambda a: None if a is None else torch.tensor(np.asarray(a),
                                                         device=device)
    return BatchProblems(qp=qp_from_numpy(qp_fields, device),
                         l1_weight=as_t(l1_weight),
                         l1_center=as_t(l1_center), **meta)


# --------------------------------------------------------------------------
# Model weights: the JAX package's MLP list, Flax's LSTM tree and Flax's
# msgpack bytes
# --------------------------------------------------------------------------

_GATES = "ifgo"
_MSGPACK_NDARRAY = 1    # Flax's msgpack extension code for an ndarray


def mlp_params_from_jax(params, device="cpu"):
    """The ranker's MLP from the JAX package's layout: a list of
    ``{"w": (d_in, d_out), "b": (d_out,)}`` arrays (or tensors) in, the
    same list of new float32 tensors on ``device`` out."""
    def copy(v):
        if torch.is_tensor(v):
            return v.detach().to(device=device, dtype=torch.float32,
                                 copy=True)
        return torch.tensor(np.asarray(v), dtype=torch.float32,
                            device=device)

    return [{k: copy(layer[k]) for k in ("w", "b")} for layer in params]


def lstm_params_from_flax(tree, device="cpu"):
    """An LSTM's state dict (``porqua_tpu_torch.models.lstm``'s fused
    layout) from Flax's parameter tree.

    Flax's ``OptimizedLSTMCell_0`` keeps one input kernel per gate
    (``ii/if/ig/io``, no bias) and one recurrent kernel per gate
    (``hi/hf/hg/ho``, carrying the bias); the port stacks them along the
    last axis in the order ``[i, f, g, o]``: ``kernel_i`` (in, 4H),
    ``kernel_h`` (H, 4H), ``bias`` (4H,). ``Dense_0`` becomes
    ``dense_kernel`` (H, out) and ``dense_bias`` (out,)."""
    cell, dense = tree["OptimizedLSTMCell_0"], tree["Dense_0"]

    def cat(prefix, leaf):
        return np.concatenate([np.asarray(cell[f"{prefix}{g}"][leaf])
                               for g in _GATES], axis=-1)

    arrays = {"kernel_i": cat("i", "kernel"), "kernel_h": cat("h", "kernel"),
              "bias": cat("h", "bias"),
              "dense_kernel": np.asarray(dense["kernel"]),
              "dense_bias": np.asarray(dense["bias"])}
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in arrays.items()}


def lstm_params_to_flax(state):
    """Flax's parameter tree (numpy arrays, keys sorted, as a trained
    tree comes out of ``jax.tree.map`` and as ``model/`` holds it) from
    an LSTM state dict in the port's layout; the
    inverse of :func:`lstm_params_from_flax`."""
    arr = {k: v.detach().cpu().numpy() for k, v in state.items()}
    H = arr["kernel_h"].shape[0]
    cell = {}
    for j, g in enumerate(_GATES):
        cols = slice(j * H, (j + 1) * H)
        cell[f"i{g}"] = {"kernel": arr["kernel_i"][:, cols]}
        cell[f"h{g}"] = {"bias": arr["bias"][cols],
                         "kernel": arr["kernel_h"][:, cols]}
    return {"Dense_0": {"bias": arr["dense_bias"],
                        "kernel": arr["dense_kernel"]},
            "OptimizedLSTMCell_0": dict(sorted(cell.items()))}


def flax_msgpack_restore(data: bytes):
    """A parameter tree from the bytes of ``flax.serialization.to_bytes``:
    msgpack maps of string keys whose leaves are Flax's ndarray
    extension (code 1: the msgpack of ``(shape, dtype name, raw
    C-order bytes)``). Needs ``msgpack``, imported here."""
    import msgpack

    def ext_hook(code, payload):
        if code != _MSGPACK_NDARRAY:
            raise ValueError(f"unsupported Flax msgpack extension {code}")
        shape, dtype, raw = msgpack.unpackb(payload, raw=True)
        return np.frombuffer(raw, dtype=np.dtype(dtype.decode())).reshape(
            shape, order="C")

    tree = msgpack.unpackb(data, ext_hook=ext_hook, raw=False)
    if not isinstance(tree, dict):
        raise ValueError("not a Flax parameter tree")
    return tree


def flax_msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for a tree of
    numpy arrays (the inverse of :func:`flax_msgpack_restore`). Needs
    ``msgpack``, imported here."""
    import msgpack

    def ext_pack(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(_MSGPACK_NDARRAY, msgpack.packb(
                (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))
        raise TypeError(f"cannot serialize {type(x).__name__}")

    return msgpack.packb(tree, default=ext_pack, strict_types=True)
