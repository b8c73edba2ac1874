"""Coherence analysis of field stacks.

Port of the reference package's ``coherence.py``: the 1D degree of
coherence and coherent fraction, both degrees of transverse coherence
(from the mutual intensity and from the field stack's Gram matrix), the
eigenmodes of either, and the blocked forms of the mutual intensity that
never hold the (n, n) matrix (``j4d_block``, ``j4d_apply``,
``degree_of_coherence_map``).  Plain functions on tensors: the
decompositions are ``torch.linalg.eigh`` (ascending eigenvalues) and the
contractions ``torch.matmul``.  Two selections are made on the host, as in
the reference: the local minima of the 1D degree of coherence and the
intensity peak of the coherence map.
"""
from __future__ import annotations

import numpy as np
import torch


def calc_1D_coherent_fraction(U, axisName, axis, p=0):
    """1D degree of coherence and coherent fraction of a field stack *U*
    shaped (repeats, nx, ny), along x (the middle row in z) or z.  Returns
    (J, I, DoC, varI, varDoC, limDoC, cohFraction); limDoC is the first
    local minimum of DoC below 0.5 on the positive side, or None."""
    U = torch.as_tensor(U)
    repeats, binsx, binsz = U.shape
    if axisName == 'x':
        Uc = U[:, :, binsz // 2]
    elif axisName in ('y', 'z'):
        Uc = U[:, binsx // 2, :]
    else:
        raise ValueError('unknown axis')
    J = (Uc.T.conj() @ Uc) / repeats
    if p > 0:
        J = J / p ** 2
    II = torch.abs(torch.diagonal(J))
    sq = torch.sqrt(II)
    J = J / (sq * sq[:, None])
    Jd = torch.abs(torch.diagonal(torch.fliplr(J)))

    axis = torch.as_tensor(axis, dtype=II.dtype, device=II.device)
    varI = torch.sum(II * axis ** 2) / torch.sum(II)
    axisEx = 2 * axis

    # local minima of DoC, selected on the host
    Jd_np = Jd.detach().cpu().numpy()
    ax_np = axisEx.detach().cpu().numpy()
    interior = np.r_[False, (Jd_np[1:-1] < Jd_np[:-2]) &
                     (Jd_np[1:-1] < Jd_np[2:]), False]
    lm = np.where(interior & (ax_np > 0) & (Jd_np < 0.5))[0]
    if len(lm) > 0:
        cond = np.abs(ax_np) <= ax_np[lm[0]]
        limJd = float(ax_np[lm[0]])
    else:
        cond = np.ones_like(ax_np, dtype=bool)
        limJd = None
    condj = torch.as_tensor(cond, device=Jd.device)
    zero = torch.zeros_like(Jd)
    varJd = torch.sum(torch.where(condj, Jd * axisEx ** 2, zero)) / \
        torch.sum(torch.where(condj, Jd, zero))
    cohFr = (4 * varI / varJd + 1) ** (-0.5)
    return J, II, Jd, varI, varJd, limJd, cohFr


def calc_degree_of_transverse_coherence_4D(J):
    """DoTC = Tr(J^2) / Tr(J)^2 of a mutual intensity *J*."""
    J = torch.as_tensor(J)
    return (torch.trace(J @ J) / torch.trace(J) ** 2).real


def _gram(U):
    """(D, D^H D) of a stack (repeats, ...): D holds one flattened field a
    column."""
    U = torch.as_tensor(U)
    D = U.reshape(U.shape[0], -1).T
    return D, D.T.conj() @ D


def calc_degree_of_transverse_coherence_PCA(U):
    """DoTC from the field stack through its (repeats x repeats) Gram
    matrix: Tr(G^2) / Tr(G)^2 equals the 4D definition."""
    _, DTD = _gram(U)
    return (torch.trace(DTD @ DTD) / torch.trace(DTD) ** 2).real


def calc_eigen_modes_4D(J, eigenN=4):
    """The *eigenN* largest eigenvalues of the trace-normalized mutual
    intensity and their eigenvectors (columns), ascending."""
    J = torch.as_tensor(J)
    J = J / torch.trace(J)
    w, v = torch.linalg.eigh(J)
    if eigenN:
        return w[-eigenN:], v[:, -eigenN:]
    return w, v


def calc_eigen_modes_PCA(U, eigenN=4, maxRepeats=None, normalize=False):
    """PCA eigenmodes of a field stack (repeats, nx, ny): the
    *eigenN* largest eigenvalues of the trace-normalized Gram matrix,
    ascending, and the modes as columns (nx * ny, eigenN), flattened in
    Fortran order as the reference does."""
    U = torch.as_tensor(U)
    if maxRepeats is not None:
        U = U[:maxRepeats]
    repeats = U.shape[0]
    if eigenN is None:
        eigenN = repeats
    eigenN = min(eigenN, repeats)
    D, DTD = _gram(U.permute(0, 2, 1))
    DTD = DTD / torch.trace(DTD).real
    wPCA, vPCA = torch.linalg.eigh(DTD)
    modes = []
    for i in range(eigenN):
        # the reference's projection D @ outer(v, v^H), column 0, is
        # (D @ v) * conj(v[0])
        vv = (D @ vPCA[:, -1 - i]) * torch.conj(vPCA[0, -1 - i])
        if normalize:
            vv = vv / torch.sqrt(torch.vdot(vv, vv).real)
        modes.append(vv)
    return wPCA[-eigenN:], torch.stack(modes[::-1], dim=1)


calc_eigen_modes = calc_eigen_modes_PCA


def j4d_block(U, rows):
    """Rows ``J[rows, :]`` of the mutual intensity of the field stack *U*
    (repeats, n): one (block x r) @ (r x n) product, never the (n, n)
    matrix."""
    U = torch.as_tensor(U)
    return (U[:, rows].T @ torch.conj(U)) / U.shape[0]


def j4d_apply(U, v):
    """J @ v without forming J: U^T (conj(U) @ v) / r."""
    U = torch.as_tensor(U)
    v = torch.as_tensor(v, dtype=U.dtype, device=U.device)
    return (U.T @ (torch.conj(U) @ v)) / U.shape[0]


def degree_of_coherence_map(U, ref=None):
    """(|gamma(r, r_ref)| for every point r, ref): |J(r, r_ref)| /
    sqrt(I(r) I(r_ref)) against the point *ref* (default: the intensity
    peak, read on the host).  O(n r) memory and work."""
    U = torch.as_tensor(U)
    r = U.shape[0]
    I = torch.mean(torch.abs(U) ** 2, dim=0)
    if ref is None:
        ref = int(torch.argmax(I))
    Jcol = (U.T @ torch.conj(U[:, ref])) / r
    return torch.abs(Jcol) / torch.sqrt(torch.clamp(I * I[ref],
                                                    min=1e-300)), ref
