"""Batched small-matrix Cholesky factor, triangular inverse and solve.

PyTorch counterpart of mjlab_tpu/phys/linalg.py (``chol_factor_blocked``,
``tri_inv``, ``chol_solve_inv``). The factor is the same matrix as the JAX
package's: the Cholesky factor of the Jacobi-equilibrated matrix with the
same relative ridge, scaled back to the original. It is computed by
torch.linalg's batched factor and triangular solve (a few launches per
call) instead of the JAX package's blocked, unrolled schedule, which was
shaped for the TPU's vector unit. chol_solve_inv keeps the single
refinement step against H. Matrices are (..., n, n) with any leading batch
axes.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _default_ridge(dtype: torch.dtype) -> float:
    return 1e-6 if dtype == torch.float32 else 1e-14


def chol_factor(H: torch.Tensor, ridge: float | None = None) -> torch.Tensor:
    """Lower-triangular L with L L^T = H + ridge diag(H) for SPD H:
    the factor of the Jacobi-equilibrated (unit diagonal) matrix plus the
    relative ridge, scaled back to H."""
    if ridge is None:
        ridge = _default_ridge(H.dtype)
    n = H.shape[-1]
    scale = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=_EPS))
    A = H * scale[..., :, None] * scale[..., None, :]
    A = A + ridge * torch.eye(n, dtype=H.dtype, device=H.device)
    L, _ = torch.linalg.cholesky_ex(A)
    return L / scale[..., :, None]


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular L."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def chol_solve_inv(Linv: torch.Tensor, g: torch.Tensor,
                   H: torch.Tensor | None = None) -> torch.Tensor:
    """Solve (L L^T) x = g from Linv = L^-1 with two matrix-vector products;
    with H, one step of iterative refinement against H (the explicit
    inverse alone loses about cond(H) ulps in float32)."""

    def solve2(r):
        y = torch.einsum("...ij,...j->...i", Linv, r)
        return torch.einsum("...ji,...j->...i", Linv, y)

    x = solve2(g)
    if H is not None:
        x = x + solve2(g - torch.einsum("...ij,...j->...i", H, x))
    return x
