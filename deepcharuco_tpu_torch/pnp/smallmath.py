"""Small fixed-size linear algebra (``deepcharuco_tpu.pnp.smallmath``),
batch-first: matrices are (..., n, n) with any leading dimensions.

The Cholesky factorization clamps every pivot at ``1e-12`` before its
square root, so a singular or indefinite matrix (coincident or collinear
points in the pose solver) gives finite or non-finite numbers that the
caller tests, never an exception: ``torch.linalg.cholesky`` raises there.
It is the right-looking form on the matrix augmented with its right-hand
sides: each column is a handful of tensor operations over the whole batch,
the forward substitution comes out of the same pass, and every sum is
subtracted term by term in the order of the JAX package's unrolled loops.
No host synchronisation.
"""

from __future__ import annotations

import math

import torch

from deepcharuco_tpu_torch.pnp.projection import matmul_small

_EPS = 1e-12


def cholesky_factor(A: torch.Tensor, B: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """Factor symmetric ``A + jitter·I = L Lᵀ`` (..., n, n), each pivot
    clamped at 1e-12, and solve ``L Y = B`` (..., n, m) in the same pass.
    Returns (..., n, n + m): ``Lᵀ`` in the upper triangle of the first n
    columns (what lies below the diagonal is scratch), ``Y`` in the rest.
    ``jitter`` is a float or a (...,) tensor."""
    n = A.shape[-1]
    M = torch.cat([A, B], dim=-1)
    if torch.is_tensor(jitter) or jitter:
        if torch.is_tensor(jitter):
            jitter = jitter[..., None]
        M.diagonal(dim1=-2, dim2=-1).add_(jitter)
    for j in range(n):
        M[..., j, j] = torch.sqrt(M[..., j, j].clamp_min(_EPS))
        M[..., j, j + 1:] /= M[..., j, j, None]         # row j of Lᵀ, then Y's row j
        if j + 1 < n:
            M[..., j + 1:, j + 1:] -= M[..., j, j + 1:n, None] * M[..., j, None, j + 1:]
    return M


def _backward_sub(M: torch.Tensor, n: int) -> torch.Tensor:
    """Solve ``Lᵀ X = Y`` on :func:`cholesky_factor`'s result, in place;
    returns X (..., n, m)."""
    X = M[..., n:]
    for i in reversed(range(n)):
        X[..., i, :] /= M[..., i, i, None]
        if i:
            X[..., :i, :] -= M[..., :i, i, None] * X[..., i, None, :]
    return X


def cholesky_solve(A: torch.Tensor, b: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """Solve ``(A + jitter·I) x = b`` for symmetric positive-definite A
    (..., n, n), b (..., n), by the clamped Cholesky factorization."""
    return _backward_sub(cholesky_factor(A, b[..., None], jitter), A.shape[-1])[..., 0]


def smallest_eigvec(S: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Unit eigenvector (..., n) of symmetric PSD S (..., n, n) for its
    smallest eigenvalue, by inverse power iteration x ← (S + εI)⁻¹ x with ε
    scaled to the matrix. S + εI is factored once, with the identity as the
    right-hand side, which gives L⁻¹; each iteration is then two small
    products and a normalization."""
    n = S.shape[-1]
    scale = torch.diagonal(S, dim1=-2, dim2=-1).sum(dim=-1) / n + _EPS
    eye = torch.eye(n, dtype=S.dtype, device=S.device).expand(*S.shape)
    Linv = cholesky_factor(S, eye, 1e-9 * scale)[..., n:]
    LinvT = Linv.transpose(-1, -2)
    x = torch.full(S.shape[:-1] + (1,), 1.0 / math.sqrt(n), dtype=S.dtype,
                   device=S.device)
    for _ in range(iters):
        x = matmul_small(LinvT, matmul_small(Linv, x))
        x = x / (torch.linalg.vector_norm(x, dim=-2, keepdim=True) + _EPS)
    return x[..., 0]


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3×3 inverse (adjugate / determinant), (..., 3, 3)."""
    c0, c1, c2 = M[..., :, 0], M[..., :, 1], M[..., :, 2]
    # rows of the adjugate are the cross products of M's columns
    adj = torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0),
                       torch.linalg.cross(c0, c1)], dim=-2)
    det = (c0 * adj[..., 0, :]).sum(dim=-1)
    det = det + torch.where(det.abs() < _EPS, _EPS, 0.0)
    return adj / det[..., None, None]


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by the triple product of its columns."""
    return (M[..., :, 0] * torch.linalg.cross(M[..., :, 1], M[..., :, 2])).sum(dim=-1)


def polar_rotation(Q: torch.Tensor, iters: int = 9) -> torch.Tensor:
    """Nearest rotation matrix to (..., 3, 3) Q (its orthogonal polar
    factor) by the Newton iteration X ← ½(X + X⁻ᵀ). A negative determinant
    is fixed up front by flipping the last column."""
    flip = torch.where(det3(Q) < 0, -1.0, 1.0)
    Q = torch.cat([Q[..., :2], Q[..., 2:] * flip[..., None, None]], dim=-1)
    fro = torch.linalg.matrix_norm(Q, ord="fro")
    X = Q / (fro / math.sqrt(3.0) + _EPS)[..., None, None]
    for _ in range(iters):
        X = 0.5 * (X + inv3(X).transpose(-1, -2))
    return X
