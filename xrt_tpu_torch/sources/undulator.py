"""Undulator source: the far-field, tapered and near-field radiation
integrals of one filament.

Port of the reference package's ``sources/undulator.py``: ``Undulator.create``
(auto-K from ``targetE``, the e-beam sizes, the acceptance reduction, a
linear taper, a near-field distance ``R0``), the Clenshaw-Curtis node grid
padded to a multiple of :data:`NODE_CHUNK`, the quadrature convergence
search (``gNodes=None``: an exponential search, then bisection on the MAD
statistic of an intensity probe), the radiation integral over one period
(the far field: the periodic sum through the sin(pi Np w)/sin(pi w) factor)
or over all Np periods (tapered or near field, with the near-field
geometry and its wrapped phases), ``build_I_map`` with the energy spread,
``shine_wave``: the coherent field of one macro-electron at the samples of
a prepared wave, with its spherical propagation phase, and the ray-mode
``shine`` (importance resampling of ``_SynchrotronBase``, ray origins from
the Tanaka-Kitamura source sizes, unit amplitudes).

The integral walks a list of (period, node) entries in steps of
:data:`NODE_CHUNK` nodes with per-ray complex accumulators, so the
temporaries stay O(rays x chunk).  The list is made once a call, as the
reference tiles it: Np copies of the node grid with each period's offset
(one copy in the far field), and the sines and cosines of the nodes'
trajectory phases are taken once over the whole list, so a step derives
no per-node term again.  It is plain PyTorch: the reference evaluates it
in its array library, not in a kernel of its own.  Above ``2 * RAY_BLOCK``
rays ``shine`` and ``shine_wave`` walk the rays in blocks of
``RAY_BLOCK``.

``power_vs_K``, ``tuning_curves`` and ``power_vs_K_through_aperture`` are
host products of ``intensities_on_mesh`` (``_SynchrotronBase``).
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
from ..profiler import stage
from ..transforms import virgin_local_to_global
from .synchrotron import _SynchrotronBase, _create_args, _ebeam_sizes

#: quadrature nodes per step of the integral
NODE_CHUNK = 64
#: rays per block of ``shine_wave`` above 2 * RAY_BLOCK samples
RAY_BLOCK = 131072

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
    """Planar or elliptic undulator (period *L0* mm, *n* periods), with a
    linear taper (*taper_val*, dB/B per unit length) or a near-field
    observation distance *R0* (mm).  The node grid ``tg``/``ag`` is
    float64 numpy, cast to a ray tensor's dtype and device where the
    integral runs."""

    def __init__(self, Kx=0.0, Ky=4.4, L0=33.0, n=50, phase=0.0,
                 taper_val=None, R0=None, quadm=0, gIntervals=2, tg=None,
                 ag=None, **kwargs):
        super().__init__(**kwargs)
        self.Kx, self.Ky = config.number(Kx), config.number(Ky)
        self.L0 = float(L0)
        self.n = int(n)
        self.phase = float(phase)
        self.taper_val = taper_val
        self.R0 = R0
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
        float64.  *taper*: (dgap, gap) in mm, or dB/B per unit length.
        *R0*: the near-field distance, mm; it forces both acceptance
        reductions.  *gNodes* None: the node count from
        :meth:`with_converged_grid` at the precision *gp*.  *dtype* and
        *device* are those of the beams ``shine`` makes."""
        createArgs = _create_args(locals())
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
        taper_val = None
        if taper is not None:
            # (dgap, gap) in mm -> dB/B per unit length
            taper_val = taper[0] / n / period / taper[1] \
                if isinstance(taper, (tuple, list)) else float(taper)
        dx, dz, dxprime, dzprime = _ebeam_sizes(
            eSigmaX, eSigmaZ, eEpsilonX, eEpsilonZ, betaX, betaZ)
        xPrimeMax_ = xPrimeMax * 1e-3
        zPrimeMax_ = zPrimeMax * 1e-3
        if R0 is not None:
            xPrimeMaxAutoReduce = zPrimeMaxAutoReduce = True
        if xPrimeMaxAutoReduce:
            xPrimeMax_ = min(xPrimeMax_, (Ky if Ky > 0 else 2.0) / gamma)
        if zPrimeMaxAutoReduce:
            zPrimeMax_ = min(zPrimeMax_, (Kx if Kx > 0 else 2.0) / gamma)
        src = cls(name=name, center=center, eE=eE, eI=eI, eEspread=eEspread,
                  dx=dx, dz=dz, dxprime=dxprime, dzprime=dzprime, eMin=eMin,
                  eMax=eMax, xPrimeMax=xPrimeMax_, zPrimeMax=zPrimeMax_,
                  distE=distE, nrays=nrays, oversample=oversample,
                  pitch=pitch, yaw=yaw, Kx=Kx, Ky=Ky, L0=period, n=n,
                  phase=math.radians(phaseDeg), taper_val=taper_val,
                  R0=None if R0 is None else float(R0),
                  quadm=int(gNodes) if gNodes else 0,
                  gIntervals=int(gIntervals) if gIntervals else 2,
                  dtype=dtype, device=device)
        src.createArgs = createArgs
        if not gNodes:
            return src.with_converged_grid(gp)
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
        """The grid of the converged node count: an exponential search over
        2^m nodes, then bisection to within 20 nodes, each step judged by
        the median relative change and the relative MAD of the intensity
        probe over six grids around it (``stat_step`` 5), either below
        *gp*.  The probes run in float64 on the source's device whatever
        its dtype (the statistic resolves relative changes of *gp*), one
        host read each."""
        def mad_at(quadm):
            stat_step = 5
            vals, dIs = [], []
            Iold = None
            for k in range(quadm - stat_step // 2,
                           quadm - stat_step // 2 + stat_step + 1):
                Inew = self.with_grid(max(k, 3),
                                      self.gIntervals)._intensity_probe()
                if Iold is not None:
                    vals.append(Inew)
                    dIs.append(abs(Inew - Iold) / max(abs(Inew), 1e-300))
                Iold = Inew
            vals = np.array(vals)
            med = np.median(vals)
            mad = np.median(np.abs(vals - med)) / max(abs(med), 1e-300)
            return mad, float(np.median(dIs))

        m = 3
        while m < 20:
            m += 1
            quadm = 2 ** m
            mad, dimad = mad_at(quadm)
            if dimad < gp or mad < gp or quadm > 400000:
                break
        lo, hi = 2 ** (m - 1), 2 ** m
        while hi - lo > 20:
            mid = (lo + hi) // 2
            mad, dimad = mad_at(mid)
            if dimad < gp or mad < gp:
                hi = mid
            else:
                lo = mid
        return self.with_grid(hi, self.gIntervals)

    def _intensity_probe(self):
        """|I| at the acceptance corner (eMax, Theta_max, Psi_max), float64
        on the source's device, read to the host."""
        dev = config.resolve_device(self.device)

        def one(v):
            return torch.full((1,), float(v), dtype=torch.float64,
                              device=dev)
        I = self.build_I_map(torch.Generator().manual_seed(0),
                             one(self.eMax), one(self.Theta_max),
                             one(self.Psi_max))[0]
        return abs(float(I[0]))

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
    def _node_list(self, dt, dev):
        """The (period, node) list of the integral on *dev*: Np copies of
        the node grid, each shifted by its period's offset, when tapered or
        in the near field, one copy otherwise (the reference's tiling).
        Returns the nodes' positions zloc, weights and the sines and
        cosines of their trajectory phases, each over the whole list."""
        nmx = self.Np if (self.R0 is not None or
                          self.taper_val is not None) else 1
        nn = len(self.tg)
        offs = np.repeat(-(nmx - 1) * PI + PI2 * np.arange(nmx), nn) \
            if nmx > 1 else np.zeros(nn)
        tg = torch.as_tensor(np.tile(self.tg, nmx), dtype=dt, device=dev)
        ag = torch.as_tensor(np.tile(self.ag, nmx), dtype=dt, device=dev)
        zloc = tg + torch.as_tensor(offs, dtype=dt, device=dev)
        sinx, cosx = torch.sin(tg), torch.cos(tg)
        sinxph = torch.sin(tg + self.phase)
        cosxph = torch.cos(tg + self.phase)
        return dict(zloc=zloc, ag=ag, sinx=sinx, cosx=cosx, sinxph=sinxph,
                    cosxph=cosxph, sin2x=2 * sinx * cosx,
                    sin2xph=2 * sinxph * cosxph)

    def _integrate(self, ww1, w, wu, gamma, ddphi, ddpsi):
        """The radiation integral per ray, (Is, Ip) complex: over one
        period in the far field, over all Np periods when tapered or in
        the near field.  Never forms 1 - beta: the ~1e-8 differences are
        regrouped into products of small terms (float32-safe).  The near
        field takes the phase by angle addition of three wrapped pieces:
        the per-ray carrier wwu R0z, the node's wwu zloc (1 - betam) and
        the transverse path difference."""
        dt, dev = ww1.dtype, ww1.device
        Kx, Ky = self.Kx, self.Ky
        nearField = self.R0 is not None
        taper = self.taper_val is not None
        revgamma = 1.0 / gamma
        revgamma2 = revgamma ** 2
        wwuS = w / wu
        rg = revgamma[:, None]
        rg2 = revgamma2[:, None]
        wwu = wwuS[:, None]
        ww1_ = ww1[:, None]
        wu_ = wu[:, None]
        dx_ = ddphi[:, None]
        dy_ = ddpsi[:, None]
        dz_ = (1. - 0.5 * (ddphi ** 2 + ddpsi ** 2))[:, None]
        # dirz = 1 - A1m exactly: 1 - dir.beta and dirz - betaz below come
        # from small well-scaled terms, not from differences of ~1 numbers
        A1m = 0.5 * (dx_ ** 2 + dy_ ** 2)
        if nearField:
            # 1 - betam kept on its own: ~1e-8, betam rounds to 1 in
            # float32
            omb = (1. + 0.5 * Kx ** 2 + 0.5 * Ky ** 2) * 0.5 * revgamma2
            betam_ = (1. - omb)[:, None]
            omb_ = omb[:, None]
            R0n = self.R0 * PI2 / self.L0
            R0x = (torch.tan(ddphi) * R0n)[:, None]
            R0y = (torch.tan(ddpsi) * R0n)[:, None]
            R0z = torch.ones_like(ddpsi) * R0n
            sz = torch.sin(wwuS * R0z)[:, None]
            cz = torch.cos(wwuS * R0z)[:, None]
            R0z = R0z[:, None]
        if taper:
            alphaS = self.taper_val / E2WC
        nodes = self._node_list(dt, dev)
        Bs = Bp = None
        for j in range(0, nodes['zloc'].shape[0], NODE_CHUNK):
            nd = {k: v[None, j:j + NODE_CHUNK] for k, v in nodes.items()}
            zloc, sinx, cosx = nd['zloc'], nd['sinx'], nd['cosx']
            sinxph, cosxph = nd['sinxph'], nd['cosxph']
            sin2x, sin2xph = nd['sin2x'], nd['sin2xph']
            if taper:
                taperC = 1. - alphaS * zloc / wu_
                ucos = ww1_ * zloc + wwu * rg * (
                    -Ky * dx_ * (sinx + alphaS / wu_ *
                                 (1 - cosx - zloc * sinx)) +
                    Kx * dy_ * sinx + 0.125 * rg * (
                        Kx ** 2 * sin2xph + Ky ** 2 *
                        (sin2x - 2 * alphaS / wu_ *
                         (zloc ** 2 + cosx ** 2 + zloc * sin2x))))
                eucos = torch.complex(torch.cos(ucos), torch.sin(ucos))
                betax = taperC * Ky * rg * cosx
            elif nearField:
                zterm = 0.5 * (Ky ** 2 * sin2x + Kx ** 2 * sin2xph) * rg
                drx = R0x - Ky * sinx * rg
                dry = R0y - Kx * sinxph * rg
                drz = R0z - (betam_ * zloc - 0.25 * zterm * rg)
                dist = sqrt_rn(drx ** 2 + dry ** 2 + drz ** 2)
                drs = 0.5 * (drx ** 2 + dry ** 2) / drz
                zph = wwu * zloc * omb_
                sinzloc, coszloc = torch.sin(zph), torch.cos(zph)
                dph = wwu * (drs + 0.25 * zterm * rg)
                sindrs, cosdrs = torch.sin(dph), torch.cos(dph)
                eucos = torch.complex(
                    -sz * sinzloc * cosdrs - sz * coszloc * sindrs -
                    cz * sinzloc * sindrs + cz * coszloc * cosdrs,
                    -sz * sinzloc * sindrs + sz * coszloc * cosdrs +
                    cz * sinzloc * cosdrs + cz * coszloc * sindrs)
                betax = Ky * rg * cosx
            else:
                ucos = ww1_ * zloc + wwu * rg * (
                    -Ky * dx_ * sinx + Kx * dy_ * sinxph +
                    0.125 * rg * (Ky ** 2 * sin2x + Kx ** 2 * sin2xph))
                eucos = torch.complex(torch.cos(ucos), torch.sin(ucos))
                betax = Ky * rg * cosx
            betay = -Kx * rg * cosxph
            B1m = 0.5 * (rg2 + betax * betax + betay * betay)
            if taper:
                betaPx = -Ky * (alphaS * cosx + taperC * sinx)
                betaPz = 0.5 * rg * (
                    Ky ** 2 * taperC * (alphaS * cosx ** 2 +
                                        taperC * sin2x) +
                    Kx ** 2 * sin2xph)
            else:
                betaPx = -Ky * sinx
                betaPz = 0.5 * rg * (Ky ** 2 * sin2x + Kx ** 2 * sin2xph)
            betaPy = Kx * sinxph
            if nearField:
                # the node's own direction dr / dist; 1 - dirz =
                # (drx^2 + dry^2) / (dist (dist + drz))
                t2 = (drx ** 2 + dry ** 2) / (dist * (dist + drz))
                one_minus_nb = (B1m + (1. - B1m) * t2 -
                                (drx * betax + dry * betay) / dist)
                bnz = B1m - t2
                ndx, ndy, ndz = drx / dist, dry / dist, drz / dist
            else:
                one_minus_nb = (0.5 * (rg2 + (dx_ - betax) ** 2 +
                                       (dy_ - betay) ** 2) - A1m * B1m)
                bnz = B1m - A1m
                ndx, ndy, ndz = dx_, dy_, dz_
            rkrel = 1. / one_minus_nb
            eucos = eucos * (nd['ag'] * rkrel ** 2)
            bnx = ndx - betax
            bny = ndy - betay
            dirDotBetaP = ndx * betaPx + ndy * betaPy + ndz * betaPz
            dirDotDmB = ndx * bnx + ndy * bny + ndz * bnz
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
        if self.taper_val is not None or self.R0 is not None:
            # the integral runs over all periods: no periodic factor
            ab = (1. / PI2 / wu).to(dt)
        else:
            sinw = torch.sin(PI * ww1)
            tiny = torch.finfo(dt).tiny
            sinw = torch.where(torch.abs(sinw) < tiny,
                               torch.full_like(sinw, tiny), sinw)
            ab = (1. / PI2 / wu * torch.sin(PI * self.Np * ww1) /
                  sinw).to(dt)
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
        set.  While the profiler traces, the call is the span
        ``sources.shine_wave``."""
        with stage('sources.shine_wave', device=wave.xDiffr):
            return self._shine_wave(generator, wave, fixedEnergy, ray_block,
                                    draws)

    def _shine_wave(self, generator, wave, fixedEnergy, ray_block, draws):
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
