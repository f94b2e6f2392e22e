"""Positive-semidefinite checks and projections on tensors.

One symmetric eigendecomposition projects onto the PSD cone by flooring
eigenvalues (the Frobenius-nearest PSD matrix, Higham 1988), plus a
small diagonal jitter so downstream Cholesky factorizations succeed in
finite precision. Every function takes a matrix or a batch of them
(leading axes).
"""

from __future__ import annotations

import torch


def _sym(mat):
    return 0.5 * (mat + mat.transpose(-1, -2))


def is_psd(mat, tol: float = 0.0) -> torch.Tensor:
    """True (per matrix) when the symmetrized input has all eigenvalues
    >= -tol."""
    return torch.all(torch.linalg.eigvalsh(_sym(mat)) >= -tol, dim=-1)


def _clip(mat, floor):
    eigvals, eigvecs = torch.linalg.eigh(_sym(mat))
    eigvals = torch.maximum(eigvals, floor)
    return torch.matmul(eigvecs * eigvals.unsqueeze(-2),
                        eigvecs.transpose(-1, -2))


def project_psd(mat, jitter: float = 0.0) -> torch.Tensor:
    """Frobenius-nearest PSD projection: symmetrize, eigendecompose,
    floor eigenvalues at ``jitter`` (positive definite for
    ``jitter > 0``)."""
    return _clip(mat, torch.as_tensor(jitter, dtype=mat.dtype,
                                      device=mat.device))


def nearest_psd(mat, jitter_scale: float = 1e-8) -> torch.Tensor:
    """PSD repair with a jitter relative to the largest eigenvalue, so
    the output passes a Cholesky check at working precision."""
    eigvals = torch.linalg.eigvalsh(_sym(mat))
    big = torch.clamp_min(eigvals.abs().amax(dim=-1), 1.0)
    return _clip(mat, (jitter_scale * big).unsqueeze(-1))
