"""Dynamical x-ray diffraction by perfect and mosaic crystals.

Port of the reference package's ``materials/crystal.py``: the
Belyakov-Dmitrienko two-beam amplitudes (``two_beam_amplitude``) in Bragg
and Laue geometry, thick and of finite thickness; the susceptibilities,
Bragg angles, refraction corrections and Darwin widths
(``_CrystalMethods``); mosaic crystals after Bacon and Lowde; and the
crystal classes ``Crystal``, ``CrystalFcc``, ``CrystalDiamond``,
``CrystalSi`` and ``CrystalFromCell``.  Everything is element-wise torch
on the material's device, in its dtype: the lattice spacing ``d``, the cell
volume ``V``, ``factDW`` and the mosaicity are 0-dim tensors, so a Bragg
angle taken at creation has the dtype's rounding, as in the reference.

Geometry strings follow the reference: the first word is 'Bragg' or
'Laue', the second 'reflected' or 'transmitted'.

Float32: the deviation parameter is formed as
(H/k)(H/(2k) - |beamIn . H|), a difference of numbers near sin(theta_B)
that comes out near 1e-5 on a Bragg peak; float32 unit vectors carry ~6e-8,
so a rocking curve in float32 is off by a few 0.1% (the reference's formula
is kept).  The 1e-100 guards of the thick-Bragg branch flush to zero in
float32, as in the reference; a NaN branch is then replaced by the other.

Bent crystals (``useTT=True``, ``get_amplitude_pytte``) take their
amplitudes from the Takagi-Taupin integration of ``materials/tt.py``; an
unbent crystal and Bragg-transmitted geometry keep the two-beam forms.
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..physconsts import AVOGADRO, CH, PI, PI2, R0, SQRT2PI
from .element import Element
from .material import Material


def _over(c, t):
    """The Python number *c* over *t* as one correctly rounded division:
    PyTorch takes number / tensor as a reciprocal times the number, two
    roundings, which the float32 deviation parameter cannot afford."""
    if not isinstance(t, torch.Tensor):
        return c / t
    return config.scalar(c, t.dtype, t.device) / t


def _mul_i(z):
    """i z, built from the parts: no complex scalar enters the device."""
    return torch.complex(-z.imag, z.real)


def _expi(arg):
    """exp(i arg) of a complex *arg*."""
    return torch.exp(_mul_i(arg))


def two_beam_amplitude(E, beamInDotNormal, beamOutDotNormal,
                       beamInDotHNormal, crystd, chi0, chih, chih_,
                       thetaB, t, geom):
    """The Belyakov-Dmitrienko two-beam amplitudes (s, p) from given
    susceptibilities; all inputs broadcast.  The |b|^(-1/2) flux factor is
    included for the reflected geometries."""
    waveLength = _over(CH, E)
    k = _over(PI2, waveLength)
    k0s = -beamInDotNormal * k
    if beamOutDotNormal is None:
        beamOutDotNormal = -beamInDotNormal
    kHs = -beamOutDotNormal * k
    if beamInDotHNormal is None:
        beamInDotHNormal = beamInDotNormal
    HoverK = waveLength / crystd                      # H/k0 = lambda/d
    kHs0 = kHs == 0
    kHs = torch.where(kHs0, torch.ones_like(kHs), kHs)
    b = torch.where(kHs0, -torch.ones_like(kHs), k0s / kHs)
    # the well-conditioned form of (H^2/2 - k0 H) / k0^2
    alpha = HoverK * (0.5 * HoverK - torch.abs(beamInDotHNormal)) + \
        chi0 / 2 * (1 / b - 1)
    k02 = k ** 2

    def for_one_polarization(polFactor):
        # alpha * alpha, not alpha ** 2: a complex power is taken through
        # exp and log, which costs float32 digits
        delta = torch.sqrt(alpha * alpha +
                           polFactor ** 2 * chih * chih_ / b)
        if t is None:  # thick Bragg
            apd = alpha + delta
            amd = alpha - delta
            amd = torch.where(amd == 0, torch.full_like(amd, 1e-100), amd)
            apd = torch.where(apd == 0, torch.full_like(apd, 1e-100), apd)
            ra = chih * polFactor / apd
            rb = chih * polFactor / amd
            ra = torch.where(torch.isnan(torch.abs(ra)) |
                             (torch.abs(rb) < torch.abs(ra)), rb, ra)
            return ra / sqrt_rn(torch.abs(b))
        tA = t * 1e7  # mm -> A
        lg = tA * delta * k02 / 2.0 / kHs
        if geom.startswith('Bragg'):
            if geom.endswith('transmitted'):
                ra = 1 / (torch.cos(lg) - _mul_i(alpha * torch.sin(lg) /
                                                 delta)) * \
                    _expi(k02 * tA * (chi0 - alpha * b) / 2 / k0s)
            else:
                ra = chih * polFactor / \
                    (alpha + _mul_i(delta / torch.tan(lg)))
        else:  # Laue
            if geom.endswith('transmitted'):
                ra = (torch.cos(lg) + _mul_i(alpha * torch.sin(lg) /
                                             delta)) * \
                    _expi(k02 * tA * (chi0 - alpha * b) / 2 / k0s)
            else:
                ra = chih * polFactor * torch.sin(lg) / delta * \
                    _expi(k02 * tA * (chi0 - alpha * b) / 2 / k0s)
        if not geom.endswith('transmitted'):
            ra = ra / sqrt_rn(torch.abs(b))
        return ra

    curveS = for_one_polarization(1.0)
    curveP = for_one_polarization(torch.cos(2.0 * thetaB))
    return curveS, curveP


class _CrystalMethods:
    """Dynamical-diffraction methods shared by the crystal classes; a
    subclass provides ``get_structure_factor(E, sinThetaOverLambda)``
    returning (F0, Fhkl, Fhkl_bar).  An energy *E* is a tensor or a Python
    number; a number reaches the scattering factors as a number (see
    ``Element.get_f1f2``)."""

    def _T(self, v):
        """*v* as a tensor of the crystal's dtype on its device (a number
        by a fill on the device, see ``config.scalar``)."""
        if isinstance(v, (int, float)):
            return config.scalar(v, self.d.dtype, self.d.device)
        return torch.as_tensor(v, dtype=self.d.dtype, device=self.d.device)

    # ---- susceptibilities -----------------------------------------------
    @property
    def chiToF(self):
        return -R0 / PI / self.V

    @property
    def chiToFd2(self):
        return torch.abs(self.chiToF) * self.d ** 2

    def get_F_chi(self, E, sinThetaOverLambda):
        """(F0, Fhkl, Fhkl_, chi0, chih, chih_), with the conjugation the
        Belyakov-Dmitrienko formulas need."""
        F0, Fhkl, Fhkl_ = self.get_structure_factor(E, sinThetaOverLambda)
        waveLength = _over(CH, E)
        chiToFlambdaSquare = self.chiToF * waveLength ** 2
        chi0 = torch.conj(F0) * chiToFlambdaSquare
        chih = torch.conj(Fhkl) * chiToFlambdaSquare
        chih_ = torch.conj(Fhkl_) * chiToFlambdaSquare
        return F0, Fhkl, Fhkl_, chi0, chih, chih_

    # ---- angles ---------------------------------------------------------
    def get_sin_Bragg_angle(self, E, order=1):
        a = _over(order * CH, 2 * self.d * self._T(E))
        return torch.clamp(a, -1 + 1e-16, 1 - 1e-16)

    def get_Bragg_angle(self, E, order=1):
        return torch.arcsin(self.get_sin_Bragg_angle(E, order))

    def get_backscattering_energy(self):
        return _over(CH, 2 * self.d)

    def get_dtheta_symmetric_Bragg(self, E):
        """delta-theta = chi0 / sin(2 theta_B)."""
        F0, _, _ = self.get_structure_factor(E, 0.5 / self.d)
        waveLength = _over(CH, E)
        chi0 = F0 * self.chiToF * waveLength ** 2
        thetaB = self.get_Bragg_angle(E)
        return (chi0 / torch.sin(2 * thetaB)).real

    def get_dtheta(self, E, alpha=None):
        """The angle correction for the general asymmetric case, Authier
        Eq. (8.3)."""
        if alpha is None:
            alpha = 0.0
        thetaB = self.get_Bragg_angle(E)
        pm = -1.0 if self.geom.startswith('Bragg') else 1.0
        gamma0 = torch.sin(thetaB + alpha)
        gammah = pm * torch.sin(thetaB - alpha)
        symm_dt = self.get_dtheta_symmetric_Bragg(E)
        osqg0 = sqrt_rn(1.0 - gamma0 ** 2)
        dtheta0 = (pm * gamma0 - pm * sqrt_rn(
            gamma0 ** 2 + pm * (gamma0 - gammah) * osqg0 * symm_dt)) / osqg0
        return -dtheta0

    def get_dtheta_regular(self, E, alpha=None):
        """(1 - b) / 2 * chi0 / sin(2 theta_B)."""
        E = self._T(E)
        if alpha is not None:
            thetaB = self.get_Bragg_angle(E)
            b = torch.sin(thetaB + alpha) / torch.sin(thetaB - alpha)
            if self.geom.startswith('Bragg'):
                b = -b
            return (1 - b) / 2 * self.get_dtheta_symmetric_Bragg(E)
        if self.geom.startswith('Bragg'):
            return self.get_dtheta_symmetric_Bragg(E)
        return torch.zeros_like(E)

    def get_Darwin_width(self, E, b=1.0, polarization='s'):
        """2 delta = |C| sqrt(chih chih_ / b) / sin(2 theta)."""
        theta0 = self.get_Bragg_angle(E)
        sin2theta = torch.sin(2 * theta0)
        waveLength = _over(CH, E)
        sinThetaOverL = torch.sin(theta0) / waveLength
        _, _, _, chi0, chih, chih_ = self.get_F_chi(E, sinThetaOverL)
        polFactor = 1.0 if polarization == 's' else torch.cos(2 * theta0)
        return 2 * (torch.sqrt(polFactor ** 2 * chih * chih_ / b) /
                    sin2theta).real

    def get_epsilon_h(self, E, b=1.0, polarization='s'):
        """Relative spectral width, Shvyd'ko Eq. 2.119."""
        _, Fhkl, _, _, _, _ = self.get_F_chi(E, 0.5 / self.d)
        if polarization == 's':
            polFactor = 1.0
        else:
            polFactor = torch.abs(torch.cos(2 * self.get_Bragg_angle(E)))
        return 4 * self.chiToFd2 * polFactor * torch.abs(Fhkl) / \
            abs(b) ** 0.5

    # ---- two-beam amplitudes --------------------------------------------
    def get_amplitude(self, E, beamInDotNormal, beamOutDotNormal=None,
                      beamInDotHNormal=None, d_local=None):
        """Complex reflectivity / transmittivity amplitudes (s, p) in Bragg
        and Laue geometry, thick and of finite thickness."""
        crystd = self.d if d_local is None else d_local
        _, _, _, chi0, chih, chih_ = self.get_F_chi(E, 0.5 / crystd)
        thetaB = self.get_Bragg_angle(E)
        return two_beam_amplitude(
            E, beamInDotNormal, beamOutDotNormal, beamInDotHNormal,
            crystd, chi0, chih, chih_, thetaB, self.t, self.geom)

    # ---- mosaic crystals (Bacon & Lowde) --------------------------------
    def get_kappa_Q(self, E):
        """Inverse extinction length kappa and integrated reflecting power
        Q per unit path (s and p), 1/cm, and the corrected Bragg angle."""
        thetaB = self.get_Bragg_angle(E) - self.get_dtheta(E)
        waveLength = _over(CH, E)
        _, Fhkl, _, _, _, _ = self.get_F_chi(E, 0.5 / self.d)
        polFactor = torch.cos(2 * thetaB)
        kappas = torch.abs(Fhkl) * waveLength * R0 / self.V
        Qs = kappas ** 2 * waveLength / torch.sin(2 * thetaB)
        kappap = kappas * torch.abs(polFactor)
        Qp = Qs * polFactor ** 2
        return kappas * 1e8, kappap * 1e8, Qs * 1e8, Qp * 1e8, thetaB

    def get_extinction_lengths(self, E):
        """Primary (and, with a mosaicity, secondary) extinction lengths,
        mm."""
        kappas, kappap, Qs, Qp = self.get_kappa_Q(E)[0:4]
        if self.mosaicity is not None:
            w = 1.0 / (SQRT2PI * self.mosaicity)
            return (_over(10., kappas), _over(10., kappap),
                    _over(10., w * Qs), _over(10., w * Qp))
        return _over(10., kappas), _over(10., kappap)

    def get_extinction_depth(self, E):
        """Extinction lengths measured normal to the surface, mm."""
        sinThetaB = torch.sin(self.get_Bragg_angle(E))
        return tuple(r * sinThetaB for r in self.get_extinction_lengths(E))

    def get_refractive_correction(self, E, beamInDotNormal=None, alpha=None):
        """(theta_c - theta'_c) = w_H / 2 (b - 1/b) tan(theta_B), Shvyd'ko
        Eqs. 2.152 / 2.112; give exactly one of *beamInDotNormal* or the
        asymmetry angle *alpha* [rad]."""
        thetaB = self.get_Bragg_angle(E)
        if (beamInDotNormal is None) == (alpha is None):
            raise ValueError(
                "one of 'beamInDotNormal' or 'alpha' must be given")
        if beamInDotNormal is not None:
            alpha = torch.arcsin(self._T(beamInDotNormal)) - thetaB
        else:
            alpha = self._T(alpha)
            beamInDotNormal = torch.sin(thetaB + alpha)
        pm = -1.0 if self.geom.startswith('Bragg') else 1.0
        beamOutDotNormal = pm * torch.sin(thetaB - alpha)
        b = beamInDotNormal / beamOutDotNormal
        F0 = self.get_F_chi(E, 0.5 / self.d)[0]
        return -self.chiToFd2 * F0.real * (b - 1 / b) * torch.tan(thetaB)

    def get_amplitude_mosaic(self, E, beamInDotNormal, beamOutDotNormal=None,
                             beamInDotHNormal=None):
        """Mosaic-crystal reflectivity after Bacon & Lowde."""
        Qs, Qp, thetaB = self.get_kappa_Q(E)[2:5]
        if beamInDotHNormal is None:
            beamInDotHNormal = beamInDotNormal
        delta = torch.arcsin(torch.abs(beamInDotHNormal)) - thetaB
        g0 = torch.abs(beamInDotNormal)
        gH = g0 if beamOutDotNormal is None else torch.abs(beamOutDotNormal)
        w = torch.exp(-0.5 * delta ** 2 / self.mosaicity ** 2) / \
            (SQRT2PI * self.mosaicity)
        mu = self.get_absorption_coefficient(self._T(E))
        if self.geom.startswith('Bragg'):
            mu = mu * 0.5 * (1 + g0 / gH)
        t = None if self.t is None else self.t * 0.1  # mm -> cm

        def for_one_polarization(Q):
            a = Q * w / mu
            bb = sqrt_rn(1 + 2 * a)
            if t is None:  # thick Bragg
                return a / (1 + a + bb)
            A = mu * t / g0
            if self.geom.startswith('Bragg'):
                return a / (1 + a + bb / torch.tanh(A * bb))
            sigma = Q * w / g0
            overGamma = 0.5 * (1 / g0 + 1 / gH)
            overG = 0.5 * (1 / g0 - 1 / gH)
            sm = sqrt_rn(sigma ** 2 + mu ** 2 * overG ** 2)
            sGamma = sigma + mu * overGamma
            return sigma / sm * torch.sinh(sm * t) * torch.exp(-sGamma * t)

        return (sqrt_rn(for_one_polarization(Qs)),
                sqrt_rn(for_one_polarization(Qp)))

    # ---- bent crystals (Takagi-Taupin) ----------------------------------
    def get_amplitude_pytte(self, E, beamInDotNormal, beamOutDotNormal=None,
                            beamInDotHNormal=None, alphaAsym=None, Ry=None,
                            Rx=None, inPlaneRotation=0.0, nsteps=4000,
                            autoLimits=True):
        """Bent-crystal amplitudes by Takagi-Taupin integration; the
        two-beam amplitudes for an unbent crystal and in Bragg-transmitted
        geometry.  *Ry* meridional, *Rx* sagittal bending radii in mm
        (positive concave), *alphaAsym* the asymmetry angle."""
        from . import tt
        unbent = (Ry is None or math.isinf(float(Ry))) and \
            (Rx is None or math.isinf(float(Rx)))
        if unbent or (self.geom.startswith('B') and
                      self.geom.endswith('transmitted')):
            return self.get_amplitude(E, beamInDotNormal, beamOutDotNormal,
                                      beamInDotHNormal)
        c1, c2, ir1 = tt.compute_tt_params(
            self, alphaAsym, Rm=Ry, Rs=Rx, inPlaneRotation=inPlaneRotation)
        return tt.tt_amplitudes(
            E, beamInDotNormal, beamOutDotNormal, beamInDotHNormal, self,
            c1, c2, ir1, alphaAsym=alphaAsym, nsteps=nsteps,
            autoLimits=autoLimits)

    # the reference's second name for the same integration
    get_amplitude_TT = get_amplitude_pytte


class Crystal(_CrystalMethods, Material):
    """A crystal with a given d-spacing; the structure factor comes from a
    concrete subclass."""

    def __init__(self, elements, quantities, rho, t=None, name='',
                 table='Chantler total', hkl=(1, 1, 1), d=None, V=None,
                 factDW=None, geom='Bragg reflected', mosaicity=None,
                 nu=None, useTT=False, volumetricDiffraction=False):
        super().__init__(elements, quantities, rho, t=t, kind='crystal',
                         name=name, table=table)
        self.hkl = tuple(int(i) for i in hkl)
        self.d, self.V, self.factDW = d, V, factDW
        self.geom = geom
        self.mosaicity = mosaicity
        self.nu = nu
        self.useTT = useTT
        self.volumetricDiffraction = volumetricDiffraction

    @staticmethod
    def _tensors(dtype, device, **values):
        dt = config.resolve_dtype(dtype)
        dev = config.resolve_device(device)
        return {k: None if v is None else torch.as_tensor(v, dtype=dt,
                                                          device=dev)
                for k, v in values.items()}

    @classmethod
    def create(cls, hkl=(1, 1, 1), d=0.0, V=None, elements='Si',
               quantities=None, rho=0.0, t=None, factDW=1.0,
               geom='Bragg reflected', table='Chantler total', name='',
               mosaicity=0.0, nu=None, useTT=False,
               volumetricDiffraction=False, dtype=None, device=None):
        base = Material.create(elements, quantities, kind='crystal', rho=rho,
                               t=t, table=table, name=name, dtype=dtype,
                               device=device)
        sqrthkl2 = math.sqrt(sum(i ** 2 for i in hkl))
        if V is None:
            V = (d * sqrthkl2) ** 3  # the cubic assumption
        return cls(base.elements, base.quantities, base.rho, t=base.t,
                   name=base.name, table=table, hkl=hkl, geom=geom,
                   nu=None if nu is None else float(nu), useTT=bool(useTT),
                   volumetricDiffraction=bool(volumetricDiffraction),
                   **cls._tensors(dtype, device, d=d, V=V, factDW=factDW,
                                  mosaicity=mosaicity or None))

    def get_structure_factor(self, E, sinThetaOverLambda=0.0, needFhkl=True):
        raise NotImplementedError(
            'use a concrete crystal class (CrystalSi, CrystalDiamond, '
            'CrystalFromCell, ...)')


class CrystalFcc(Crystal):
    """fcc structure factor: F = 4 f if h, k, l are all even or all odd,
    else 0."""

    def get_structure_factor(self, E, sinThetaOverLambda=0.0, needFhkl=True):
        el = self.elements[0]
        anomalousPart = el.get_f1f2(E)
        F0 = 4 * (el.Z + anomalousPart) * self.factDW
        residue = sum(i % 2 for i in self.hkl)
        if residue == 0 or residue == 3:
            f0 = el.get_f0(sinThetaOverLambda) if needFhkl else 0.0
            Fhkl = 4 * (f0 + anomalousPart) * self.factDW
        else:
            Fhkl = torch.zeros_like(F0)
        return F0, Fhkl, Fhkl


class CrystalDiamond(CrystalFcc):
    """Diamond lattice: F = F_fcc (1 + exp(i pi / 2 (h + k + l)))."""

    @classmethod
    def create(cls, hkl=(1, 1, 1), d=0.0, a=None, **kwargs):
        if a is None and not d and not issubclass(cls, CrystalSi):
            a = 3.56679   # the diamond lattice constant, A
            kwargs.setdefault('elements', 'C')
            kwargs.setdefault('rho', 3.516)
        if a is not None:
            d = a / math.sqrt(sum(i ** 2 for i in hkl))
        kwargs.setdefault('name', 'Diamond')
        return super(CrystalDiamond, cls).create(hkl=hkl, d=d, **kwargs)

    def get_structure_factor(self, E, sinThetaOverLambda=0.0, needFhkl=True):
        dr = 1 + math.cos(0.5 * PI * sum(self.hkl))
        di = math.sin(0.5 * PI * sum(self.hkl))
        F0, Fhkl, Fhkl_ = CrystalFcc.get_structure_factor(
            self, E, sinThetaOverLambda, needFhkl)
        # the complex factor is made from two real tensors on the device
        dj = torch.complex(self._T(dr), self._T(di))
        return F0 * 2, Fhkl * dj, Fhkl_ * torch.conj(dj)


def _si_dl_l(t):
    """Relative elongation of Si against temperature [K], Swenson's
    parameterization."""
    if 0.0 <= t < 30.0:
        return -2.154537e-004
    if 30.0 <= t < 130.0:
        return (-2.303956e-014 * t ** 4 + 7.834799e-011 * t ** 3 -
                1.724143e-008 * t ** 2 + 8.396104e-007 * t - 2.276144e-004)
    if 130.0 <= t < 293.0:
        return (-1.223001e-011 * t ** 3 + 1.532991e-008 * t ** 2 -
                3.263667e-006 * t - 5.217231e-005)
    if 293.0 <= t <= 1000.0:
        return (-1.161022e-012 * t ** 3 + 3.311476e-009 * t ** 2 +
                1.124129e-006 * t - 5.844535e-004)
    return 1.0e+100


class CrystalSi(CrystalDiamond):
    """Silicon with its temperature-dependent lattice constant."""

    def __init__(self, *args, tK=297.15, **kwargs):
        super().__init__(*args, **kwargs)
        self.tK = float(tK)

    @classmethod
    def create(cls, hkl=(1, 1, 1), tK=297.15, **kwargs):
        kwargs.setdefault('elements', 'Si')
        kwargs.setdefault('rho', 2.33)
        kwargs.setdefault('name', 'Si')
        kwargs.pop('a', None)
        kwargs.pop('d', None)
        cr = super(CrystalSi, cls).create(hkl=hkl, a=cls._a(tK), **kwargs)
        cr.tK = float(tK)
        return cr

    @staticmethod
    def _a(tK):
        a0 = 5.430710
        dl_l0 = _si_dl_l(273.15 + 19.9)
        return a0 * (_si_dl_l(tK) - dl_l0 + 1)

    def get_a(self):
        return self._a(self.tK)

    def get_Bragg_offset(self, E, Eref):
        """Bragg angle offset of a spectrum feature against its tabulated
        position."""
        chOverTwod = _over(CH / 2, self.d)
        return torch.arcsin(chOverTwod / self._T(E)) - \
            torch.arcsin(chOverTwod / self._T(Eref))


class CrystalFromCell(Crystal):
    """A crystal from its cell parameters and atomic positions: *atoms* are
    atomic numbers (or symbols), *atomsXYZ* fractional cell coordinates
    (n_atoms, 3), *atomsFraction* occupancies."""

    def __init__(self, *args, a=5.430710, b_=None, c=None, alpha=90.0,
                 beta=90.0, gamma=90.0, atoms_Z=(), atomsXYZ=None,
                 atomsFraction=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.a, self.b_, self.c = a, b_, c
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self.atoms_Z = tuple(atoms_Z)
        self.atomsXYZ = atomsXYZ
        self.atomsFraction = atomsFraction

    @classmethod
    def create(cls, name='', hkl=(1, 1, 1), a=5.430710, b=None, c=None,
               alpha=90.0, beta=90.0, gamma=90.0, atoms=(14,) * 8,
               atomsXYZ=((0., 0., 0.), (0., .5, .5), (.5, .5, 0.),
                         (.5, 0., .5), (.25, .25, .25), (.25, .75, .75),
                         (.75, .25, .75), (.75, .75, .25)),
               atomsFraction=None, t=None, factDW=1.0,
               geom='Bragg reflected', table='Chantler total',
               mosaicity=0.0, nu=None, useTT=False,
               volumetricDiffraction=False, dtype=None, device=None,
               **derived):
        """*derived*: what the cell determines (a layout's elements,
        quantities, rho, d, V), accepted and ignored."""
        b = b or a
        c = c or a
        atoms_Z = tuple(Element.create(at, dtype=dtype, device=device).Z
                        if isinstance(at, str) else int(at) for at in atoms)
        if atomsFraction is None:
            atomsFraction = [1.0] * len(atoms_Z)
        ar, br, gr = (math.radians(alpha), math.radians(beta),
                      math.radians(gamma))
        ca, cb, cg = math.cos(ar), math.cos(br), math.cos(gr)
        sa, sb, sg = math.sin(ar), math.sin(br), math.sin(gr)
        V = a * b * c * (1 - ca**2 - cb**2 - cg**2 + 2*ca*cb*cg) ** 0.5
        h, k, l = hkl
        d = V / (a * b * c) * (
            (h * sa / a) ** 2 + (k * sb / b) ** 2 + (l * sg / c) ** 2 +
            2 * h * k * (ca * cb - cg) / (a * b) +
            2 * h * l * (ca * cg - cb) / (a * c) +
            2 * k * l * (cb * cg - ca) / (b * c)) ** (-0.5)
        els = tuple(Element.create(z, table, dtype=dtype, device=device)
                    for z in sorted(set(atoms_Z)))
        masses = {el.Z: el.mass for el in els}
        mass = sum(f * masses[z] for z, f in zip(atoms_Z, atomsFraction))
        rho = mass / AVOGADRO / V * 1e24
        return cls(els, tuple(1.0 for _ in els), rho,
                   t=None if t is None else float(t), name=name, table=table,
                   hkl=hkl, geom=geom,
                   nu=None if nu is None else float(nu), useTT=bool(useTT),
                   volumetricDiffraction=bool(volumetricDiffraction),
                   a=a, b_=b, c=c, alpha=alpha, beta=beta, gamma=gamma,
                   atoms_Z=atoms_Z,
                   **cls._tensors(dtype, device, d=d, V=V, factDW=factDW,
                                  mosaicity=mosaicity or None,
                                  atomsXYZ=atomsXYZ,
                                  atomsFraction=atomsFraction))

    def get_structure_factor(self, E, sinThetaOverLambda=0.0, needFhkl=True):
        """F0, Fhkl and Fhkl_bar summed over the atoms of the cell."""
        el_by_Z = {el.Z: el for el in self.elements}
        Et = self._T(E)
        F0 = torch.zeros(Et.shape, dtype=config.cdtype(Et.dtype),
                         device=Et.device)
        Fhkl = torch.zeros_like(F0)
        Fhkl_ = torch.zeros_like(F0)
        hkl = self._T(self.hkl)
        cache = {}
        for i, Z in enumerate(self.atoms_Z):
            el = el_by_Z[Z]
            if Z not in cache:
                f0 = el.get_f0(sinThetaOverLambda) if needFhkl else 0.0
                cache[Z] = (f0, el.get_f1f2(E))
            f0, anom = cache[Z]
            af = self.atomsFraction[i]
            F0 = F0 + af * (Z + anom) * self.factDW
            fact = af * (f0 + anom) * self.factDW
            phase = PI2 * torch.dot(self.atomsXYZ[i], hkl)
            expiHr = torch.complex(torch.cos(phase), torch.sin(phase))
            Fhkl = Fhkl + fact * expiHr
            Fhkl_ = Fhkl_ + fact / expiHr
        return F0, Fhkl, Fhkl_
