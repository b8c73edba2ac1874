"""Multilayer reflectivity and transmittivity by the recursive Parratt
method with Nevot-Croce interdiffusion factors.

Port of the reference package's ``materials/multilayer.py``:
``Multilayer`` (periodic or depth-graded pairs of a top and a bottom
layer on a substrate, 'reflected' or 'transmitted'), ``GradedMultilayer``
and ``Coated`` (one coating on a substrate).  The recursion runs from the
substrate up over the 2 nPairs layers (one more, the substrate slab, in
transmission) as a Python loop over (N,) complex tensors that keeps only
the carry; which interface a layer has is known on the host, so each step
is a handful of element-wise operations.  The phase factor's square is a
product (ROADMAP C12: PyTorch takes a complex ``z ** 2`` through exp and
log).  As in the reference, an infinitely thick substrate makes the
transmitted amplitude NaN (its phase is inf times a complex number).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..physconsts import CH, CHBAR
from .crystal import _mul_i, _over


def _graded_thicknesses(tHigh, tLow, nPairs, power):
    """d_n = A / (B + n)^power from *tHigh* (top) to *tLow* (bottom), or
    *tHigh* for every pair when *tLow* is 0."""
    if tLow:
        layers = np.arange(1, nPairs + 1)
        qRoot = (tHigh / tLow) ** (1.0 / power)
        qB = (nPairs - qRoot) / (qRoot - 1.0)
        qA = tHigh * (qB + 1) ** power
        return qA * (qB + layers) ** (-power)
    return np.ones(nPairs) * float(tHigh)


class Multilayer:
    """Periodic or depth-graded multilayer of (tLayer, bLayer) pairs on a
    substrate; thicknesses in Angstrom.  *geom* is 'reflected' or
    'transmitted'.  The per-pair thicknesses ``dti``, ``dbi`` and the
    roughnesses are tensors of the multilayer's dtype on its device."""

    def __init__(self, tLayer, bLayer, substrate, dti, dbi, idThickness,
                 substRoughness, substThickness, nPairs=0,
                 geom='reflected', kind='multilayer', name=''):
        self.tLayer, self.bLayer, self.substrate = tLayer, bLayer, substrate
        self.dti, self.dbi = dti, dbi
        self.idThickness = idThickness
        self.substRoughness = substRoughness
        self.substThickness = substThickness
        self.nPairs = int(nPairs)
        self.geom = geom
        self.kind = kind
        self.name = name

    @classmethod
    def create(cls, tLayer=None, tThickness=0.0, bLayer=None, bThickness=0.0,
               nPairs=0, substrate=None, tThicknessLow=0.0,
               bThicknessLow=0.0, idThickness=0.0, power=2.0,
               substRoughness=0.0, substThickness=np.inf, name='',
               geom='reflected', kind='multilayer', dtype=None,
               device=None):
        """The reference's constructor arguments; *tThicknessLow* /
        *bThicknessLow* grade the pairs from the top value to the bottom
        one."""
        dt = config.resolve_dtype(dtype)
        dev = config.resolve_device(device)

        def T(v):
            return torch.as_tensor(np.asarray(v, np.float64), dtype=dt,
                                   device=dev)
        return cls(tLayer, bLayer, substrate,
                   T(_graded_thicknesses(tThickness, tThicknessLow, nPairs,
                                         power)),
                   T(_graded_thicknesses(bThickness, bThicknessLow, nPairs,
                                         power)),
                   T(idThickness), T(substRoughness), T(substThickness),
                   nPairs=int(nPairs), geom=geom, kind=kind, name=name)

    @property
    def d(self):
        """The period, tThickness + bThickness (the top pair's if graded)."""
        return self.dti[0] + self.dbi[0]

    def resolved_kind(self, default='mirror') -> str:
        return self.kind

    def _T(self, v):
        if isinstance(v, (int, float)):
            return config.scalar(v, self.dti.dtype, self.dti.device)
        return torch.as_tensor(v, dtype=self.dti.dtype,
                               device=self.dti.device)

    def get_sin_Bragg_angle(self, E, order=1):
        a = _over(order * CH, 2 * self.d * self._T(E))
        return torch.clamp(a, -1 + 1e-16, 1 - 1e-16)

    def get_Bragg_angle(self, E, order=1):
        return torch.arcsin(self.get_sin_Bragg_angle(E, order))

    def get_dtheta(self, E, order=1):
        return self.get_dtheta_symmetric_Bragg(E, order)

    def get_dtheta_symmetric_Bragg(self, E, order=1):
        """theta_B - arcsin(sqrt(m^2 lambda^2 + 8 d^2 delta_mean) / 2d)."""
        E = self._T(E)
        nt = self.tLayer.get_refractive_index(E).real if self.tLayer \
            else 1.0
        nb = self.bLayer.get_refractive_index(E).real if self.bLayer \
            else 1.0
        d_ = torch.abs((nt - 1) * self.dti[0] + (nb - 1) * self.dbi[0]) / \
            self.d
        lam = _over(order * CH, E)
        return self.get_Bragg_angle(E, order) - torch.arcsin(
            sqrt_rn(lam * lam + self.d ** 2 * 8 * d_) / (2 * self.d))

    def _index(self, layer, E, one):
        return layer.get_refractive_index(E).conj() if layer else one

    def get_amplitude(self, E, beamInDotNormal, x=None, y=None):
        """(rs, rp, 0, 0) in 'reflected' geometry, (ts, tp, 0, 0) in
        'transmitted': the absorption is in the layers' indices."""
        E = self._T(E)
        beamInDotNormal = self._T(beamInDotNormal)
        k = E / self._T(CHBAR)
        cdt = config.cdtype(E.dtype)
        one = torch.ones(E.shape, dtype=cdt, device=E.device)
        nt = self._index(self.tLayer, E, one)
        nb = self._index(self.bLayer, E, one)
        ns = self._index(self.substrate, E, one)

        Q = 2 * k * torch.abs(beamInDotNormal)
        Q2 = Q * Q
        k28 = 8 * k * k
        Qt = torch.sqrt(Q2 + (nt - 1) * k28)
        Qb = torch.sqrt(Q2 + (nb - 1) * k28)
        Qs = torch.sqrt(Q2 + (ns - 1) * k28)
        id2 = self.idThickness * self.idThickness
        tran = 'tran' in self.geom

        roughvt = torch.exp(-0.5 * Q * Qt * id2)
        rvt_s = (Q - Qt) / (Q + Qt) * roughvt
        rvt_p = (Q * nt - Qt / nt) / (Q * nt + Qt / nt) * roughvt

        roughtb = torch.exp(-0.5 * Qt * Qb * id2)
        rtb_s = (Qt - Qb) / (Qt + Qb) * roughtb
        rtb_p = (Qt / nt * nb - Qb / nb * nt) / \
            (Qt / nt * nb + Qb / nb * nt) * roughtb
        rbt_s = -rtb_s
        rbt_p = -rtb_p

        rmsbs = id2 if self.tLayer else \
            self.substRoughness * self.substRoughness
        roughbs = torch.exp(-0.5 * Qb * Qs * rmsbs)
        rbs_s = (Qb - Qs) / (Qb + Qs) * roughbs
        rbs_p = (Qb / nb * ns - Qs / ns * nb) / \
            (Qb / nb * ns + Qs / ns * nb) * roughbs

        if tran:
            rsv_s = (Qs - Q) / (Qs + Q) * roughbs
            rsv_p = (Qs / ns - Q * ns) / (Qs / ns + Q * ns) * roughbs
            tvt_s = 2 * Q / (Q + Qt) * roughvt
            tvt_p = 2 * Q * nt / (Q * nt + Qt / nt) * roughvt
            ttb_s = 2 * Qt / (Qt + Qb) * roughtb
            ttb_p = 2 * Qt / nt * nb / (Qt / nt * nb + Qb / nb * nt) * \
                roughtb
            tbt_s = 2 * Qb / (Qt + Qb) * roughtb
            tbt_p = 2 * Qb / nb * nt / (Qt / nt * nb + Qb / nb * nt) * \
                roughtb
            tbs_s = 2 * Qb / (Qb + Qs) * roughbs
            tbs_p = 2 * Qb / nb * ns / (Qb / nb * ns + Qs / ns * nb) * \
                roughbs
            tsv_s = 2 * Qs / (Qs + Q) * roughbs
            tsv_p = 2 * Qs / ns / (Qs / ns + Q * ns) * roughbs
            rj_s, rj_p, tj_s, tj_p = rsv_s, rsv_p, tsv_s, tsv_p
        else:
            rj_s, rj_p = rbs_s, rbs_p
            tj_s = tj_p = None

        nSub = 2 * self.nPairs
        nLayers = nSub + (1 if tran else 0)
        last = self.dti.shape[0] - 1
        for i in range(nLayers - 1, -1, -1):
            pair = min(i // 2, last)
            # the interface above layer i and the layer's optical path
            if i % 2:
                rij = (rtb_s, rtb_p)
                iQT = Qb * self.dbi[pair]
                tij = (ttb_s, ttb_p) if tran else None
            elif i == 0:
                rij = (rvt_s, rvt_p)
                iQT = Qt * self.dti[pair]
                tij = (tvt_s, tvt_p) if tran else None
            elif i == nSub:         # the substrate slab, in transmission
                rij = (rbs_s, rbs_p)
                iQT = Qs * self.substThickness
                tij = (tbs_s, tbs_p)
            else:
                rij = (rbt_s, rbt_p)
                iQT = Qt * self.dti[pair]
                tij = (tbt_s, tbt_p) if tran else None
            p1i = torch.exp(_mul_i(0.5 * iQT))
            p2i = p1i * p1i
            rj2i_s = rj_s * p2i
            rj2i_p = rj_p * p2i
            den_s = 1 + rij[0] * rj2i_s
            den_p = 1 + rij[1] * rj2i_p
            if tran:
                tj_s = tij[0] * tj_s * p1i / den_s
                tj_p = tij[1] * tj_p * p1i / den_p
            rj_s = (rij[0] + rj2i_s) / den_s
            rj_p = (rij[1] + rj2i_p) / den_p

        zero = torch.zeros_like(E)
        if tran:
            return tj_s, tj_p, zero, zero
        # delta may be < 0 for some tabulations
        flip = (nt.real - 1) > 0
        rj_s = torch.where(flip, rj_s.conj(), rj_s)
        rj_p = torch.where(flip, rj_p.conj(), rj_p)
        return rj_s, rj_p, zero, zero


class GradedMultilayer(Multilayer):
    """A multilayer with graded layer thicknesses (the same class; the
    grading is given by *tThicknessLow* / *bThicknessLow*)."""


def Coated(coating=None, cThickness=0.0, surfaceRoughness=0.0,
           substrate=None, substRoughness=0.0, name='', **kwargs):
    """One reflective coating on a substrate: a one-pair multilayer with a
    vacuum top layer, of kind 'mirror'."""
    return Multilayer.create(
        bLayer=coating, bThickness=cThickness, idThickness=surfaceRoughness,
        nPairs=1, substrate=substrate, substRoughness=substRoughness,
        name=name, kind='mirror', **kwargs)

