"""Linear algebra ops (``paddle_tpu/ops/linalg.py``; parity:
python/paddle/tensor/linalg.py).

Decompositions follow the JAX package's conventions: ``lu``'s pivots are
1-based int32 (LAPACK's), ``eigh`` symmetrizes its input, ``lstsq`` is
the SVD solution with JAX's residual rule, ``histogram`` counts in the
input's float dtype.  Eigen and singular vectors are defined up to sign
or phase, so only their products are comparable across packages."""

from __future__ import annotations

import itertools
import math

import torch

from paddle_tpu_torch.core.dispatch import eager_op


@eager_op
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x:
        x = torch.swapaxes(x, -1, -2) if x.ndim > 1 else x
    if transpose_y:
        y = torch.swapaxes(y, -1, -2) if y.ndim > 1 else y
    return torch.matmul(x, y)


@eager_op
def mm(x, y):
    return torch.matmul(x, y)


@eager_op
def bmm(x, y):
    return torch.bmm(x, y)


@eager_op
def dot(x, y):
    return torch.sum(x * y, dim=-1)


@eager_op
def mv(x, vec):
    return torch.matmul(x, vec)


@eager_op
def dist(x, y, p=2.0):
    d = torch.abs(x - y).reshape(-1)
    if p == 0:
        return torch.sum(d != 0).to(x.dtype)
    if math.isinf(p):
        return torch.amax(d) if p > 0 else torch.amin(d)
    return torch.sum(d ** p) ** (1.0 / p)


@eager_op
def norm(x, p=None, axis=None, keepdim=False):
    if isinstance(axis, (list, tuple)) and len(axis) == 1:
        axis = axis[0]
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2.0
    if p == "fro":
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        if ax is None:
            ax = tuple(range(x.ndim))
        return torch.sqrt(torch.sum(torch.square(torch.abs(x)), dim=ax,
                                    keepdim=keepdim))
    if p == "nuc":
        s = torch.linalg.svdvals(x)
        return torch.sum(s, dim=-1, keepdim=keepdim)
    if isinstance(axis, (list, tuple)):
        return torch.linalg.norm(x, ord=p, dim=tuple(axis), keepdim=keepdim)
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    if isinstance(p, (int, float)) and math.isinf(p):
        f = torch.amax if p > 0 else torch.amin
        return f(torch.abs(x), dim=axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=axis, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=axis,
                     keepdim=keepdim) ** (1.0 / p)


@eager_op
def cross(x, y, axis=9):
    if axis == 9:  # paddle default: first axis with dim 3
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


@eager_op
def cholesky(x, upper=False):
    L = torch.linalg.cholesky(x)
    return torch.swapaxes(L, -1, -2).conj() if upper else L


@eager_op
def cholesky_solve(x, y, upper=False):
    return torch.cholesky_solve(x, y, upper=upper)


@eager_op
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    a = torch.swapaxes(x, -1, -2) if transpose else x
    return torch.linalg.solve_triangular(
        a, y, upper=bool(upper) != bool(transpose),
        unitriangular=bool(unitriangular))


@eager_op
def solve(x, y):
    return torch.linalg.solve(x, y)


@eager_op
def lstsq(x, y, rcond=None, driver=None):
    """``jnp.linalg.lstsq``: the SVD solution; singular values below
    ``rcond * s_max`` (eps * max(m, n) by default) are dropped; the
    residuals are the squared column norms of ``y - x @ sol`` when the
    rank is n and m > n, else empty."""
    m, n = x.shape[-2], x.shape[-1]
    b = y[..., None] if y.ndim == 1 else y
    if rcond is None:
        rcond = torch.finfo(x.dtype).eps * max(m, n)
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    keep = s >= rcond * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    sol = vh.mH @ (s_inv[..., :, None] * (u.mH @ b))
    rank = keep.sum(-1)
    if int(rank) == n and m > n:
        resid = torch.sum(torch.abs(b - x @ sol) ** 2, dim=-2)
    else:
        resid = torch.zeros((0,), dtype=x.dtype, device=x.device)
    if y.ndim == 1:
        sol = sol[..., 0]
        resid = resid.reshape(resid.shape[:-1]) if resid.numel() else resid
    return sol, resid, rank, s


@eager_op
def inverse(x):
    return torch.linalg.inv(x)


@eager_op
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@eager_op
def det(x):
    return torch.linalg.det(x)


@eager_op
def slogdet(x):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


@eager_op
def matrix_rank(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(x, rtol=tol)


@eager_op
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


@eager_op
def qr(x, mode="reduced"):
    return tuple(torch.linalg.qr(x, mode=mode))


@eager_op
def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


@eager_op
def eig(x):
    w, v = torch.linalg.eig(x)
    return w, v


@eager_op
def eigh(x, UPLO="L"):
    w, v = torch.linalg.eigh((x + x.mH) / 2)
    return w, v


@eager_op
def eigvals(x):
    return torch.linalg.eigvals(x)


@eager_op
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x)


@eager_op
def lu(x, pivot=True, get_infos=False):
    lu_, pivots = torch.linalg.lu_factor(x)
    pivots = pivots.to(torch.int32)
    if get_infos:
        info = torch.zeros(x.shape[:-2], dtype=torch.int32, device=x.device)
        return lu_, pivots, info
    return lu_, pivots


@eager_op
def multi_dot(tensors):
    return torch.linalg.multi_dot(list(tensors))


@eager_op
def histogram(input, bins=100, min=0, max=0, weight=None, density=False):
    """``jnp.histogram`` over the flattened input: ``bins`` equal bins
    over [min, max] (the data's range when both are 0), the last closed;
    counts in the input's dtype (the weights')."""
    flat = input.reshape(-1)
    if min == 0 and max == 0:
        lo, hi = flat.min().item(), flat.max().item()
    else:
        lo, hi = float(min), float(max)
    edges = torch.linspace(lo, hi, bins + 1, dtype=flat.dtype,
                           device=flat.device)
    w = torch.ones_like(flat) if weight is None else weight.reshape(-1)
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], bins, idx)
    inside = (idx >= 1) & (idx <= bins)
    counts = torch.zeros(bins + 2, dtype=w.dtype, device=flat.device)
    counts = counts.index_add(0, torch.where(inside, idx, bins + 1), w)
    hist = counts[1:bins + 1]
    if density:
        return hist / (torch.diff(edges) * hist.sum())
    return hist


@eager_op
def bincount(x, weights=None, minlength=0):
    return torch.bincount(x, weights=weights, minlength=minlength)


@eager_op
def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.T)


@eager_op
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


@eager_op
def einsum(equation, *operands):
    return torch.einsum(equation, *operands)


@eager_op
def tensordot(x, y, axes=2):
    if hasattr(axes, "__len__") and not isinstance(axes, int):
        axes = [list(a) if hasattr(a, "__len__") else [a] for a in axes]
    return torch.tensordot(x, y, dims=axes)


@eager_op
def vecdot(x, y, axis=-1):
    """Vector dot along `axis` with broadcasting; conjugates x for
    complex inputs (array-API semantics)."""
    if x.is_complex():
        x = torch.conj(x)
    return torch.sum(x * y, dim=axis)


@eager_op
def cartesian_prod(*tensors):
    """Cartesian product of 1-D tensors → [prod(n_i), len(tensors)]."""
    if len(tensors) == 1 and isinstance(tensors[0], (list, tuple)):
        tensors = tuple(tensors[0])
    if len(tensors) == 1:
        return torch.reshape(tensors[0], (-1,))  # paddle: 1-D stays 1-D
    grids = torch.meshgrid(*tensors, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


@eager_op
def combinations(x, r=2, with_replacement=False):
    """r-length combinations of a 1-D tensor's elements, in
    ``itertools`` order."""
    n = x.shape[0]
    picker = itertools.combinations_with_replacement if with_replacement \
        else itertools.combinations
    idx = list(picker(range(n), r))
    if not idx:
        return torch.zeros((0, r), dtype=x.dtype, device=x.device)
    return x[torch.tensor(idx, dtype=torch.long, device=x.device)]


@eager_op
def pdist(x, p=2.0):
    """Condensed pairwise distances of rows: the upper triangle (i < j)
    of cdist, flattened."""
    n = x.shape[0]
    d = torch.sum(torch.abs(x[:, None, :] - x[None, :, :]) ** p,
                  dim=-1) ** (1.0 / p)
    iu = torch.triu_indices(n, n, 1, device=x.device)
    return d[iu[0], iu[1]]


@eager_op
def matrix_exp(x):
    return torch.linalg.matrix_exp(x)


__all__ = [_n for _n, _v in list(globals().items())
           if not _n.startswith("_") and callable(_v)
           and (hasattr(_v, "__wrapped_pure__")
                or getattr(_v, "__module__", None) == __name__)]
