"""Undulator source: the far-field radiation integral of one filament.

Port of the reference package's ``sources/undulator.py`` for the wave
chain: ``Undulator.create`` (auto-K from ``targetE``, the e-beam sizes, the
acceptance reduction), the Clenshaw-Curtis node grid padded to a multiple of
:data:`NODE_CHUNK`, the far-field integral over one period (the periodic sum
through the sin(pi Np w)/sin(pi w) factor), ``build_I_map`` with the energy
spread, ``shine_wave``: the coherent field of one macro-electron at the
samples of a prepared wave, with its spherical propagation phase, and the
ray-mode ``shine`` (importance resampling of ``_SynchrotronBase``, ray
origins from the Tanaka-Kitamura source sizes, unit amplitudes).

The integral is a loop over chunks of :data:`NODE_CHUNK` nodes with per-ray
complex accumulators, so the temporaries stay O(rays x chunk).  It is plain
PyTorch: the reference evaluates it in its array library, not in a kernel
of its own.  Above ``2 * RAY_BLOCK`` rays ``shine`` and ``shine_wave``
walk the rays in blocks of ``RAY_BLOCK``.

``power_vs_K``, ``tuning_curves`` and ``power_vs_K_through_aperture`` are
host products of ``intensities_on_mesh`` (``_SynchrotronBase``).  The
tapered and near-field integrals and the quadrature convergence search
(``gNodes=None``) come with ROADMAP A8 and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..ops import dd
from ..ops.dd import sqrt_rn
from ..physconsts import (C, CHBAR, CHeVcm, E2WC, EV2ERG, FINE_STR, K2B, M0,
                          PI, PI2, SIE0, SQ2, SQPI)
from ..transforms import virgin_local_to_global
from .synchrotron import _SynchrotronBase, _ebeam_sizes

#: quadrature nodes per step of the integral
NODE_CHUNK = 64
#: rays per block of ``shine_wave`` above 2 * RAY_BLOCK samples
RAY_BLOCK = 131072

_A8 = 'ROADMAP A8'
_TAPER_TODO = f'the tapered undulator integral is not ported yet: {_A8}'
_NEAR_TODO = f'the near-field undulator integral (R0) is not ported yet: {_A8}'
_CONVERGE_TODO = ('the quadrature convergence search of the undulator '
                  f'(gNodes=None) is not ported yet: {_A8}; pass gNodes')

#: 1e7 / CHBAR as a double-float constant (k [1/mm] = E [eV] * KC)
_KC = 1e7 / CHBAR
_KC_HI = np.float32(_KC)
_KC_LO = np.float32(_KC - np.float64(_KC_HI))


def clenshaw_curtis(n):
    """Clenshaw-Curtis nodes and weights on [-1, 1] (the FFT-based
    algorithm), float64 numpy."""
    if n == 1:
        return np.zeros(1), np.full(1, 2.0)
    points = -np.cos((np.pi * np.arange(n)) / (n - 1))
    if n == 2:
        return points, np.array([1.0, 1.0])
    m = n - 1
    N = np.arange(1, m, 2)
    length = len(N)
    v0 = np.concatenate([2.0 / N / (N - 2), np.array([1.0 / N[-1]]),
                         np.zeros(m - length)])
    v2 = -v0[:-1] - v0[:0:-1]
    g0 = -np.ones(m)
    g0[length] += m
    g0[m - length] += m
    g = g0 / (m ** 2 - 1 + (m % 2))
    w = np.fft.ihfft(v2 + g).real
    if m % 2 == 1:
        weights = np.concatenate([w, w[::-1]])
    else:
        weights = np.concatenate([w, w[-2::-1]])
    return points, weights


def tanaka_kitamura_Qa2(x, eps=1e-6):
    """The squared Q_a of Tanaka & Kitamura (2009), Eq. 17."""
    y = SQ2 * torch.clamp(x, min=eps)
    y2 = y ** 2
    val = y2 / (torch.exp(-y2) + SQPI * y * torch.erf(y) - 1)
    return torch.where(x > eps, val, torch.ones_like(x))


def _normals(generator, n):
    """*n* standard normal draws from *generator*, float64 on the CPU."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.randn(n, generator=generator, dtype=torch.float64)


class Undulator(_SynchrotronBase):
    """Planar or elliptic undulator (period *L0* mm, *n* periods).  The
    node grid ``tg``/``ag`` is float64 numpy, cast to a ray tensor's dtype
    and device where the integral runs."""

    def __init__(self, Kx=0.0, Ky=4.4, L0=33.0, n=50, phase=0.0,
                 quadm=0, gIntervals=2, tg=None, ag=None, **kwargs):
        super().__init__(**kwargs)
        self.Kx, self.Ky = config.number(Kx), config.number(Ky)
        self.L0 = float(L0)
        self.n = int(n)
        self.phase = float(phase)
        self.quadm = int(quadm)
        self.gIntervals = int(gIntervals)
        self.tg, self.ag = tg, ag

    @classmethod
    def create(cls, name='', center=(0, 0, 0), nrays=None, eE=6.0, eI=0.1,
               eEspread=0.0, eSigmaX=None, eSigmaZ=None, eEpsilonX=1.0,
               eEpsilonZ=0.01, betaX=9.0, betaZ=2.0, period=33.0, n=50,
               K=None, Kx=0.0, Ky=None, phaseDeg=0.0, targetE=None,
               taper=None, R0=None, eMin=5000.0, eMax=15000.0,
               xPrimeMax=0.5, zPrimeMax=0.5, xPrimeMaxAutoReduce=True,
               zPrimeMaxAutoReduce=True, distE='eV', pitch=0.0, yaw=0.0,
               gNodes=None, gIntervals=None, gp=1e-6, oversample=4,
               targetHarmonic=None, dtype=None, device=None):
        """The reference's constructor arguments (angles of the acceptance
        in mrad, e-beam emittances in nm rad, sizes in um); all host
        float64.  *dtype* and *device* are those of the beams ``shine``
        makes."""
        if taper is not None:
            raise NotImplementedError(_TAPER_TODO)
        if R0 is not None:
            raise NotImplementedError(_NEAR_TODO)
        if not gNodes:
            raise NotImplementedError(_CONVERGE_TODO)
        gamma = eE * 1e9 * EV2ERG / (M0 * C ** 2)
        gamma2 = gamma ** 2
        if targetE is not None:
            # auto-K from the target energy and harmonic
            Ky = math.sqrt(targetE[1] * 8 * PI * gamma2 /
                           period / targetE[0] / E2WC - 2)
            if len(targetE) > 2 and targetE[2]:
                Ky /= math.sqrt(2)
                Kx = Ky
        if K is not None:
            Ky = K
        if Ky is None:
            Ky = 4.4
        dx, dz, dxprime, dzprime = _ebeam_sizes(
            eSigmaX, eSigmaZ, eEpsilonX, eEpsilonZ, betaX, betaZ)
        xPrimeMax_ = xPrimeMax * 1e-3
        zPrimeMax_ = zPrimeMax * 1e-3
        if xPrimeMaxAutoReduce:
            xPrimeMax_ = min(xPrimeMax_, (Ky if Ky > 0 else 2.0) / gamma)
        if zPrimeMaxAutoReduce:
            zPrimeMax_ = min(zPrimeMax_, (Kx if Kx > 0 else 2.0) / gamma)
        src = cls(name=name, center=center, eE=eE, eI=eI, eEspread=eEspread,
                  dx=dx, dz=dz, dxprime=dxprime, dzprime=dzprime, eMin=eMin,
                  eMax=eMax, xPrimeMax=xPrimeMax_, zPrimeMax=zPrimeMax_,
                  distE=distE, nrays=nrays, oversample=oversample,
                  pitch=pitch, yaw=yaw, Kx=Kx, Ky=Ky, L0=period, n=n,
                  phase=math.radians(phaseDeg), quadm=int(gNodes),
                  gIntervals=int(gIntervals) if gIntervals else 2,
                  dtype=dtype, device=device)
        return src.with_grid(src.quadm, src.gIntervals)

    @property
    def Np(self):
        return self.n

    @property
    def E1(self):
        """Fundamental on-axis photon energy, eV."""
        gamma2 = self.gamma2
        Kx, Ky = config.host_float(self.Kx), config.host_float(self.Ky)
        wu = PI / self.L0 / gamma2 * \
            (2 * gamma2 - 1 - 0.5 * Kx ** 2 - 0.5 * Ky ** 2) / E2WC
        return 2 * gamma2 * wu / (1 + 0.5 * Kx ** 2 + 0.5 * Ky ** 2)

    def with_grid(self, quadm, gIntervals):
        """The Clenshaw-Curtis x *gIntervals* composite grid over one
        period, padded with zero weights to a multiple of NODE_CHUNK."""
        tg_n, ag_n = clenshaw_curtis(quadm)
        dstep = 2 * PI / float(gIntervals)
        dI = np.arange(-PI + 0.5 * dstep, PI, dstep)
        tg = (dI[:, None] + 0.5 * dstep * tg_n).ravel()
        ag = (dI[:, None] * 0 + ag_n).ravel()
        npad = (-len(tg)) % NODE_CHUNK
        if npad:
            tg = np.concatenate([tg, np.zeros(npad)])
            ag = np.concatenate([ag, np.zeros(npad)])
        return self.replace(quadm=int(quadm), gIntervals=int(gIntervals),
                            tg=tg, ag=ag)

    def with_converged_grid(self, gp=1e-6):
        raise NotImplementedError(_CONVERGE_TODO)

    def power_vs_K(self, Ks=None):
        """Total radiated power in W, P = 0.633 E^2 [GeV] B^2 [T] L [m]
        I [A], at *Ks* (this source's Ky if None; a number or an array)."""
        Kv = self.Ky if Ks is None else np.asarray(Ks, float)
        B = K2B * Kv / self.L0
        length = self.L0 * self.Np * 1e-3
        return 0.633 * (self.eE ** 2) * (B ** 2) * length * self.eI * 1e3

    @staticmethod
    def _steps(*axes):
        """The steps of mesh axes, 1 each when an axis has one point."""
        try:
            return tuple(a[1] - a[0] for a in axes)
        except IndexError:
            return (1.0,) * len(axes)

    def tuning_curves(self, energy, theta, psi, harmonics, Ks):
        """The largest flux of each of *harmonics* through the (theta, psi)
        aperture over *energy*, for each K of *Ks*: (tunesE [keV], tunesF
        [ph/s/0.1% bw]) shaped (len(Ks), len(harmonics))."""
        energy = np.atleast_1d(np.asarray(energy, float))
        theta = np.atleast_1d(np.asarray(theta, float))
        psi = np.atleast_1d(np.asarray(psi, float))
        dtheta, dpsi = self._steps(theta, psi)
        tunesE, tunesF = [], []
        for K in Ks:
            I0 = self.replace(Ky=float(K)).intensities_on_mesh(
                energy=energy, theta=theta, psi=psi, harmonic=harmonics)[0]
            flux = I0.sum(axis=(1, 2)) * dtheta * dpsi   # (nE, nHarm)
            tunesE.append(energy[np.argmax(flux, axis=0)] / 1000.0)
            tunesF.append(np.max(flux, axis=0))
        return np.array(tunesE), np.array(tunesF)

    def power_vs_K_through_aperture(self, energy, theta, psi, Ks):
        """The power [W] through the (theta, psi) aperture within *energy*
        for each K of *Ks*."""
        energy = np.atleast_1d(np.asarray(energy, float))
        theta = np.atleast_1d(np.asarray(theta, float))
        psi = np.atleast_1d(np.asarray(psi, float))
        dtheta, dpsi, dE = self._steps(theta, psi, energy)
        powers = []
        for K in Ks:
            I0 = self.replace(Ky=float(K)).intensities_on_mesh(
                energy=energy, theta=theta, psi=psi)[0]
            I0 = I0 * energy[:, None, None]   # per eV -> power density
            powers.append(I0.sum() * dtheta * dpsi * dE * EV2ERG * 1e-7)
        return np.array(powers)

    # ------------------------------------------------------------------
    def _integrate(self, ww1, w, wu, gamma, ddphi, ddpsi):
        """The far-field radiation integral over one period, per ray:
        (Is, Ip) complex.  Never forms 1 - beta: the ~1e-8 differences are
        regrouped into products of small terms (float32-safe)."""
        dt, dev = ww1.dtype, ww1.device
        Kx, Ky = self.Kx, self.Ky
        revgamma = 1.0 / gamma
        revgamma2 = revgamma ** 2
        wwuS = w / wu
        rg = revgamma[:, None]
        rg2 = revgamma2[:, None]
        wwu = wwuS[:, None]
        ww1_ = ww1[:, None]
        dx_ = ddphi[:, None]
        dy_ = ddpsi[:, None]
        dz_ = (1. - 0.5 * (ddphi ** 2 + ddpsi ** 2))[:, None]
        # dirz = 1 - A1m exactly: 1 - dir.beta and dirz - betaz below come
        # from small well-scaled terms, not from differences of ~1 numbers
        A1m = 0.5 * (dx_ ** 2 + dy_ ** 2)
        tg_all = torch.as_tensor(self.tg, dtype=dt, device=dev)
        ag_all = torch.as_tensor(self.ag, dtype=dt, device=dev)
        Bs = Bp = None
        for j in range(0, tg_all.shape[0], NODE_CHUNK):
            tg = tg_all[j:j + NODE_CHUNK]
            ag = ag_all[j:j + NODE_CHUNK]
            zloc = tg[None, :]
            sinx = torch.sin(tg)[None, :]
            cosx = torch.cos(tg)[None, :]
            sinxph = torch.sin(tg + self.phase)[None, :]
            cosxph = torch.cos(tg + self.phase)[None, :]
            sin2x = 2 * sinx * cosx
            sin2xph = 2 * sinxph * cosxph
            ucos = ww1_ * zloc + wwu * rg * (
                -Ky * dx_ * sinx + Kx * dy_ * sinxph +
                0.125 * rg * (Ky ** 2 * sin2x + Kx ** 2 * sin2xph))
            betax = Ky * rg * cosx
            betay = -Kx * rg * cosxph
            B1m = 0.5 * (rg2 + betax * betax + betay * betay)
            betaPx = -Ky * sinx
            betaPz = 0.5 * rg * (Ky ** 2 * sin2x + Kx ** 2 * sin2xph)
            betaPy = Kx * sinxph
            one_minus_nb = (0.5 * (rg2 + (dx_ - betax) ** 2 +
                                   (dy_ - betay) ** 2) - A1m * B1m)
            bnz = B1m - A1m
            rkrel = 1. / one_minus_nb
            amp = ag[None, :] * rkrel ** 2
            eucos = torch.complex(torch.cos(ucos), torch.sin(ucos)) * amp
            bnx = dx_ - betax
            bny = dy_ - betay
            dirDotBetaP = dx_ * betaPx + dy_ * betaPy + dz_ * betaPz
            dirDotDmB = dx_ * bnx + dy_ * bny + dz_ * bnz
            s = torch.sum(eucos * (bnx * dirDotBetaP - betaPx * dirDotDmB),
                          dim=1)
            p = torch.sum(eucos * (bny * dirDotBetaP - betaPy * dirDotDmB),
                          dim=1)
            Bs = s if Bs is None else Bs + s
            Bp = p if Bp is None else Bp + p
        return wu * revgamma * Bs, wu * revgamma * Bp

    def build_I_map(self, generator, w, ddtheta, ddpsi, harmonic=None,
                    dgamma=None, gamma=None):
        """(flux, amp_s, amp_p) at photon energies *w* (eV) and angles
        (*ddtheta*, *ddpsi*) (rad), tensors of one shape.  With an energy
        spread the Lorentz factor is *gamma* (per ray) where given, else
        gamma + *dgamma*, or drawn from *generator* when both are None.

        The Lorentz factor, the harmonic number ww1 and the periodic factor
        sin(pi Np ww1) / sin(pi ww1) are evaluated in float64 whatever the
        rays' dtype: near a harmonic h both sines are near zero, and in
        float32 their arguments (~pi Np h) carry ulps of ~1e-4 rad, which
        put the factor out by up to 2.5x at the 7th harmonic of Np = 111
        (ROADMAP C16).  In float64 these are the reference's operations."""
        dt, dev = w.dtype, w.device
        gamma0 = self.gamma
        w64 = w.to(torch.float64)
        if gamma is None and self.eEspread > 0 and dgamma is not None:
            g64 = gamma0 + dgamma * torch.ones_like(w64)
        elif gamma is None:
            g64 = self._sample_gamma(generator, gamma0, w.shape,
                                     torch.float64, dev)
        else:
            g64 = gamma.to(torch.float64)
        gamma = g64.to(dt)
        gamma2 = g64 ** 2
        Kx, Ky = self.Kx, self.Ky
        wu = PI / self.L0 / gamma2 * \
            (2 * gamma2 - 1 - 0.5 * Kx ** 2 - 0.5 * Ky ** 2) / E2WC
        ww1 = w64 * ((1. + 0.5 * Kx ** 2 + 0.5 * Ky ** 2) + gamma2 * (
            ddtheta.to(torch.float64) ** 2 + ddpsi.to(torch.float64) ** 2)
        ) / (2. * gamma2 * wu)
        sinw = torch.sin(PI * ww1)
        tiny = torch.finfo(dt).tiny
        sinw = torch.where(torch.abs(sinw) < tiny,
                           torch.full_like(sinw, tiny), sinw)
        ab = (1. / PI2 / wu * torch.sin(PI * self.Np * ww1) / sinw).to(dt)
        wu = wu.to(dt)

        Is, Ip = self._integrate(ww1.to(dt), w, wu, gamma, ddtheta, ddpsi)

        bwFact = 0.001 if self.distE == 'BW' else 1. / w
        Amp2Flux = FINE_STR * bwFact * self.eI / SIE0
        if harmonic is not None:
            mask = (ww1 <= harmonic + 0.5) & (ww1 >= harmonic - 0.5)
            Is = torch.where(mask, Is, torch.zeros_like(Is))
            Ip = torch.where(mask, Ip, torch.zeros_like(Ip))
        dstep = 2 * PI / float(self.gIntervals)
        integralField = torch.abs(Is) ** 2 + torch.abs(Ip) ** 2
        sqA = sqrt_rn(Amp2Flux * torch.ones_like(w))
        return (Amp2Flux * ab ** 2 * 0.25 * dstep ** 2 * integralField,
                sqA * ab * Is * 0.5 * dstep,
                sqA * ab * Ip * 0.5 * dstep)

    def _I_map_blocks(self, generator, w, ddtheta, ddpsi, ray_block=None,
                      **kw):
        """``build_I_map`` in blocks of *ray_block* (:data:`RAY_BLOCK`)
        rays above two blocks."""
        return super()._I_map_blocks(
            generator, w, ddtheta, ddpsi,
            RAY_BLOCK if ray_block is None else ray_block, **kw)

    def get_sigma_r02(self, E):
        """sigma_r0^2 (Tanaka & Kitamura, after their Eq. 23)."""
        return 2 * CHeVcm / E * 10 * self.L0 * self.Np / PI2 ** 2

    def get_sigmaP_r02(self, E):
        return CHeVcm / E * 10 / (2 * self.L0 * self.Np)

    def _harmonic(self, E, onlyOddHarmonics):
        harmonic = torch.div(E, self.E1, rounding_mode='floor')
        if onlyOddHarmonics:
            harmonic = harmonic + harmonic % 2 - 1
        return harmonic

    def get_sigma_r2(self, E, onlyOddHarmonics=True, with0eSpread=False):
        """sigma_r^2 with the energy spread (Tanaka & Kitamura)."""
        sigma_r02 = self.get_sigma_r02(E)
        if self.eEspread == 0 or with0eSpread:
            return sigma_r02
        eEspread_norm = PI2 * self._harmonic(E, onlyOddHarmonics) * \
            self.Np * self.eEspread
        return sigma_r02 * tanaka_kitamura_Qa2(eEspread_norm / 4.) ** (2 / 3.)

    def get_sigmaP_r2(self, E, onlyOddHarmonics=True, with0eSpread=False):
        """sigma'_r^2 with the energy spread (Tanaka & Kitamura)."""
        sigmaP_r02 = self.get_sigmaP_r02(E)
        if self.eEspread == 0 or with0eSpread:
            return sigmaP_r02
        eEspread_norm = PI2 * self._harmonic(E, onlyOddHarmonics) * \
            self.Np * self.eEspread
        return sigmaP_r02 * tanaka_kitamura_Qa2(eEspread_norm)

    def get_SIGMA(self, E, onlyOddHarmonics=True, with0eSpread=False):
        """The source sizes (x, z), e-beam and photon, mm."""
        sigma_r2 = self.get_sigma_r2(E, onlyOddHarmonics, with0eSpread)
        return (sqrt_rn(self.dx ** 2 + sigma_r2),
                sqrt_rn(self.dz ** 2 + sigma_r2))

    def get_SIGMAP(self, E, onlyOddHarmonics=True, with0eSpread=False):
        """The source divergences (x, z), e-beam and photon, rad."""
        sigmaP_r2 = self.get_sigmaP_r2(E, onlyOddHarmonics, with0eSpread)
        return (sqrt_rn(self.dxprime ** 2 + sigmaP_r2),
                sqrt_rn(self.dzprime ** 2 + sigmaP_r2))

    def _sample_positions(self, E, Theta0, r):
        """x, z ~ N(0, SIGMA(E)) from the standard normals r['x'],
        r['z']; y = 0."""
        sx, sz = self.get_SIGMA(E, onlyOddHarmonics=False)
        return sx * r['x'], torch.zeros_like(E), sz * r['z']

    def shine(self, generator=None, toGlobal=True, withAmplitudes=True,
              fixedEnergy=False, draws=None):
        """Ray-mode shine (see ``_SynchrotronBase.shine``) with the
        amplitudes normalized to unit modulus, Es = mJs / |mJs|."""
        beam = super().shine(generator, toGlobal=False,
                             withAmplitudes=withAmplitudes,
                             fixedEnergy=fixedEnergy, draws=draws)
        if beam.Es is not None:
            absS, absP = torch.abs(beam.Es), torch.abs(beam.Ep)
            zero = torch.zeros_like(beam.Es)
            beam = beam.replace(
                Es=torch.where(absS > 0, beam.Es / torch.clamp(
                    absS, min=1e-300), zero),
                Ep=torch.where(absP > 0, beam.Ep / torch.clamp(
                    absP, min=1e-300), zero))
        if toGlobal:
            beam = virgin_local_to_global(beam, self.center)
        return beam

    def shine_wave(self, generator, wave, fixedEnergy, ray_block=None,
                   draws=None):
        """The coherent field of one macro-electron (filament) at the
        samples of *wave* (from a ``prepare_wave_on_*``), with the 1/r and
        sqrt(area) factors so that sum(|Es|^2 + |Ep|^2) estimates the flux,
        and the spherical propagation phase k r to the samples (in float32
        through double-float arithmetic: k r is ~1e10 rad).

        The e-beam offsets and divergences (and the energy-spread shift)
        are normal draws from *generator* (seed 0 if None), or the five
        standard normals *draws* (x, z, x', z', energy spread).  Returns
        the wave with E, Es, Ep, the coherency matrix and directions
        set."""
        dt, dev = wave.xDiffr.dtype, wave.xDiffr.device
        n = wave.xDiffr.shape[0]
        g = _normals(generator, 5) if draws is None else \
            torch.as_tensor(draws, dtype=torch.float64)
        rX = self.dx * float(g[0])
        rZ = self.dz * float(g[1])
        dtheta = self.dxprime * float(g[2])
        dpsi = self.dzprime * float(g[3])
        dgamma = self.gamma * self.eEspread * float(g[4]) \
            if self.eEspread > 0 else None
        x = wave.xDiffr - rX
        y = wave.yDiffr
        z = wave.zDiffr - rZ
        rDiffr = sqrt_rn(x ** 2 + y ** 2 + z ** 2)
        rTheta = x / rDiffr + dtheta
        rPsi = z / rDiffr + dpsi
        rE = torch.full((n,), float(fixedEnergy), dtype=dt, device=dev)
        Intensity, mJs, mJp = self._I_map_blocks(
            generator, rE, rTheta, rPsi, ray_block, dgamma=dgamma)
        # the wave's aperture area projected onto the beam direction when
        # sampling an OE surface
        wave_area = wave.area if wave.areaNormal is None else wave.areaNormal
        norm = sqrt_rn(torch.as_tensor(wave_area, dtype=dt,
                                       device=dev)) / rDiffr
        Es = mJs * norm
        Ep = mJp * norm
        if dt == torch.float32:
            zero = torch.zeros_like(x)
            xh, xl = dd.add_f(wave.xDiffr, zero if wave.xDiffr_lo is None
                              else wave.xDiffr_lo, -rX)
            yh = wave.yDiffr
            yl = zero if wave.yDiffr_lo is None else wave.yDiffr_lo
            zh, zl = dd.add_f(wave.zDiffr, zero if wave.zDiffr_lo is None
                              else wave.zDiffr_lo, -rZ)
            s2 = dd.sqr(xh, xl)
            s2 = dd.add(*s2, *dd.sqr(yh, yl))
            s2 = dd.add(*s2, *dd.sqr(zh, zl))
            rD = dd.sqrt(*s2)
            kh, kl = dd.two_prod(rE, torch.full_like(rE, float(_KC_HI)))
            kl = kl + rE * float(_KC_LO)
            kah, kal = dd.mul(kh, kl,
                              torch.full_like(kh, float(dd.INV_TWO_PI_HI)),
                              torch.full_like(kh, float(dd.INV_TWO_PI_LO)))
            mh, ml = dd.mul(kah, kal, rD[0], rD[1])
            sph, cph = dd.sincos_cycles(dd.frac_cycles(mh, ml))
        else:
            kr = (rE * (1e7 / CHBAR)) * rDiffr
            sph, cph = torch.sin(kr), torch.cos(kr)
        mPh = torch.complex(cph, sph)
        Es = Es * mPh
        Ep = Ep * mPh
        total = torch.sum(Intensity) * (self.eMax - self.eMin)
        return wave.replace(
            E=rE, Es=Es, Ep=Ep,
            a=x / rDiffr, b=y / rDiffr, c=z / rDiffr,
            Jss=(Es * torch.conj(Es)).real, Jpp=(Ep * torch.conj(Ep)).real,
            Jsp=Es * torch.conj(Ep), accepted=total,
            seeded=torch.tensor(float(n), dtype=dt, device=dev),
            seededI=total)
