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
