"""Source from a tabulated magnetic field B(z).

Port of the reference package's ``sources/customfield.py``:
``SourceFromField.create`` reads the field (a text file through
``np.loadtxt``, an array, or a periodic test field from *K*, *period* and
*n*), interpolates it with cubic splines, integrates the scaled electron
trajectory by RK4 (``_rk4_trajectory``: gamma-independent, so one
trajectory serves every ray) and builds the composite Clenshaw-Curtis grid
over the field's range, padded with zero weights to a multiple of
:data:`NODE_CHUNK`, all in host float64 numpy and scipy, as the reference
does.  ``build_I_map`` evaluates the retarded-potential integral on the
rays' device in steps of :data:`NODE_CHUNK` nodes, scaling the universal
trajectory per ray by e / (m c gamma), in the far field or, with *R0*, at
the observation points at that distance.

In the near field the node phase wc (tg - trajz) is a difference of two
numbers of the size of tg (trajz ~ tg): in float32 it keeps ulp(tg) x wc
of absolute error, ~0.04 rad for example 22's 0.124 eV light over a 1.8 m
field.  The formula is the reference's; float32 near fields are for long
wavelengths only.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.interpolate import interp1d

from ..ops.dd import sqrt_rn
from ..physconsts import (C, CHeVcm, E2WC, EMC, FINE_STR, K2B, PI, PI2, SIE0,
                          SIM0)
from .synchrotron import _SynchrotronBase, _create_args, _ebeam_sizes
from .undulator import NODE_CHUNK, clenshaw_curtis

_SPL_KW = dict(kind='cubic', bounds_error=False, fill_value='extrapolate')

#: the node arrays of a source, float64 numpy of one length
NODE_ARRAYS = ('tg', 'ag', 'Bxt', 'Byt', 'Bzt', 'betax_t', 'betay_t',
               'trajx_t', 'trajy_t', 'trajz_t')


def _fwhm(z, a):
    dz = z[1] - z[0]
    args = np.argwhere(a >= a.max() * 0.5)
    return z[int(np.max(args))] - z[int(np.min(args))] + dz


class SourceFromField(_SynchrotronBase):
    """A synchrotron source given by a tabulated field: columns (z [mm],
    {Bx,} By {, Bz}) in T, or a periodic test field.  The node arrays
    (:data:`NODE_ARRAYS`) and the mean longitudinal velocity term *betam*
    are host float64, cast to a ray tensor's dtype and device where the
    integral runs.  *R0* (mm) puts the observation points in the near
    field; None is the far field."""

    def __init__(self, betam=0.0, dstep=0.0, deviceLength=0.0, quadm=0,
                 gIntervals=2, R0=None, **kwargs):
        nodes = {k: kwargs.pop(k, None) for k in NODE_ARRAYS}
        super().__init__(**kwargs)
        for k, v in nodes.items():
            setattr(self, k, v)
        self.betam = float(betam)
        self.dstep = float(dstep)
        self.deviceLength = float(deviceLength)
        self.quadm = int(quadm)
        self.gIntervals = int(gIntervals)
        self.R0 = R0

    @classmethod
    def create(cls, name='', center=(0, 0, 0), nrays=None, eE=6.0, eI=0.1,
               eEspread=0.0, eEpsilonX=1.0, eEpsilonZ=0.01, betaX=9.0,
               betaZ=2.0, eSigmaX=None, eSigmaZ=None, customField=None,
               eMin=5000.0, eMax=15000.0, xPrimeMax=0.5, zPrimeMax=0.5,
               distE='eV', gNodes=2000, gIntervals=None, oversample=2,
               pitch=0.0, yaw=0.0, R0=None, K=4.4, period=53.96, n=41,
               dtype=None, device=None):
        """The reference's constructor arguments (acceptance in mrad).
        *customField*: a file name, (file name, ``np.loadtxt`` keyword
        arguments) or an array; None makes the periodic test field of *K*,
        *period* (mm) and *n* periods.  *dtype* and *device* are those of
        the beams ``shine`` makes."""
        createArgs = _create_args(locals())
        if customField is not None:
            if isinstance(customField, (tuple, list)):
                fname, readkw = customField
                data = np.loadtxt(fname, **readkw)
            elif isinstance(customField, np.ndarray):
                data = np.asarray(customField, float)
            else:
                data = np.loadtxt(customField)
        else:
            L0, Np = period, n
            zg = np.linspace(-L0 * Np * 0.5, L0 * Np * 0.5, 1000 * Np)
            B0y = K2B * K / L0
            data = np.vstack([zg, B0y * np.sin(2 * np.pi * zg / L0)]).T
        dataz = data[:, 0]
        deviceLength = _fwhm(dataz, np.abs(data[:, 1:]).max(axis=1))

        # the field on the RK grid (two field points a step)
        lenmm = abs(dataz[-1] - dataz[0])
        wtGrid = np.linspace(dataz[0], dataz[-1], int(lenmm * 10))
        BGrid = np.linspace(dataz[0], dataz[-1], 2 * len(wtGrid) - 1)

        def field_at(z):
            cols = [interp1d(dataz, data[:, i], **_SPL_KW)(z)
                    for i in range(1, data.shape[1])]
            zero = np.zeros_like(cols[0])
            if len(cols) == 1:
                return zero, cols[0], zero
            if len(cols) == 2:
                return cols[0], cols[1], zero
            return cols[0], cols[1], cols[2]

        betax, betay, betam, trajx, trajy, trajz = _rk4_trajectory(
            wtGrid, *field_at(BGrid))

        # the composite quadrature grid over the field's range
        if gIntervals is None:
            gIntervals = 2
        tg_n, ag_n = clenshaw_curtis(int(gNodes))
        dstep = (dataz[-1] - dataz[0]) / float(gIntervals)
        dI = np.arange(0.5 * dstep + dataz[0], dataz[-1], dstep)
        tg = (dI[:, None] + 0.5 * dstep * tg_n).ravel()
        ag = (dI[:, None] * 0 + ag_n).ravel()
        Bxt, Byt, Bzt = field_at(tg)
        on_tg = [interp1d(wtGrid, v, **_SPL_KW)(tg)
                 for v in (betax, betay, trajx, trajy, trajz)]
        npad = (-len(tg)) % NODE_CHUNK
        nodes = {k: np.concatenate([v, np.zeros(npad)]) for k, v in zip(
            NODE_ARRAYS, [tg, ag, Bxt, Byt, Bzt] + on_tg)}

        dx, dz, dxprime, dzprime = _ebeam_sizes(
            eSigmaX, eSigmaZ, eEpsilonX, eEpsilonZ, betaX, betaZ)
        src = cls(name=name, center=center, eE=eE, eI=eI,
                  eEspread=eEspread, dx=dx, dz=dz, dxprime=dxprime,
                  dzprime=dzprime, eMin=eMin, eMax=eMax,
                  xPrimeMax=xPrimeMax * 1e-3, zPrimeMax=zPrimeMax * 1e-3,
                  distE=distE, nrays=nrays, oversample=oversample,
                  pitch=pitch, yaw=yaw, betam=betam, dstep=dstep,
                  deviceLength=deviceLength, quadm=int(gNodes),
                  gIntervals=int(gIntervals),
                  R0=None if R0 is None else float(R0), dtype=dtype,
                  device=device, **nodes)
        src.createArgs = createArgs
        return src

    def get_sigma_r02(self, E):
        """sigma_r0^2 from the field's FWHM length."""
        return 2 * CHeVcm / E * 10 * self.deviceLength / PI2 ** 2

    def get_SIGMA(self, E, onlyOddHarmonics=True):
        s2 = self.get_sigma_r02(E)
        return sqrt_rn(self.dx ** 2 + s2), sqrt_rn(self.dz ** 2 + s2)

    def _sample_positions(self, E, Theta0, r):
        """x, z ~ N(0, SIGMA(E)) from the standard normals r['x'],
        r['z']; y = 0."""
        sx, sz = self.get_SIGMA(E)
        return sx * r['x'], torch.zeros_like(E), sz * r['z']

    def build_I_map(self, generator, w, ddtheta, ddpsi, gamma=None):
        """(flux, amp_s, amp_p) at photon energies *w* (eV) and angles
        (*ddtheta*, *ddpsi*) (rad), tensors of one shape.  With an energy
        spread the Lorentz factor is *gamma* (per ray) where given, else
        drawn from *generator*."""
        dt, dev = w.dtype, w.device
        if gamma is None:
            gamma = self._sample_gamma(generator, self.gamma, w.shape, dt,
                                       dev)
        revgamma2 = 1.0 / gamma ** 2
        emcg = SIE0 / SIM0 / C / 10. / gamma
        betam = self.betam
        wc = w * E2WC / (1. + (betam * EMC ** 2 - 0.5) * revgamma2)
        dirz = sqrt_rn(1. - ddtheta ** 2 - ddpsi ** 2)

        nearField = self.R0 is not None
        if nearField:
            # the observation point of each ray; the carrier wc R0z is a
            # per-ray constant, taken once
            R0x = (torch.tan(ddtheta) * self.R0)[:, None]
            R0y = (torch.tan(ddpsi) * self.R0)[:, None]
            R0z = torch.full_like(ddpsi, self.R0)
            sz = torch.sin(wc * R0z)[:, None]
            cz = torch.cos(wc * R0z)[:, None]
            R0z = R0z[:, None]
        else:
            # 1 - dirz = (theta^2 + psi^2) / (1 + dirz) exactly
            A1m = ((ddtheta ** 2 + ddpsi ** 2) / (1. + dirz))[:, None]
            dirx_n, diry_n = ddtheta[:, None], ddpsi[:, None]
            dirz_n = dirz[:, None]
        nodes = {k: torch.as_tensor(getattr(self, k), dtype=dt, device=dev)
                 for k in NODE_ARRAYS}
        em = emcg[:, None]
        rg2 = revgamma2[:, None]
        wcb = wc[:, None]
        Is = Ip = None
        for j in range(0, nodes['tg'].shape[0], NODE_CHUNK):
            nd = {k: v[None, j:j + NODE_CHUNK] for k, v in nodes.items()}
            tg, Bx, By, Bz = nd['tg'], nd['Bxt'], nd['Byt'], nd['Bzt']
            # the universal trajectory scaled per ray
            betax_ = em * nd['betax_t']
            betay_ = em * nd['betay_t']
            trajx_ = em * nd['trajx_t']
            trajy_ = em * nd['trajy_t']
            trajz_ = tg * (1. - 0.5 * rg2) + EMC ** 2 * rg2 * nd['trajz_t']
            if nearField:
                # wc (tg + |R0 - r(z)| - R0z) with |dr| - drz expanded
                # (LRS); the three pieces combine by angle addition
                drx = R0x - trajx_
                dry = R0y - trajy_
                drz = R0z - trajz_
                dist = sqrt_rn(drx ** 2 + dry ** 2 + drz ** 2)
                rdrz = 1. / drz
                drs = (drx ** 2 + dry ** 2) * rdrz
                LRS = 0.5 * drs - 0.125 * drs ** 2 * rdrz + \
                    0.0625 * drs ** 3 * rdrz ** 2
                zph = wcb * (tg - trajz_)
                sinzloc, coszloc = torch.sin(zph), torch.cos(zph)
                sindrs, cosdrs = torch.sin(wcb * LRS), torch.cos(wcb * LRS)
                eucos = torch.complex(
                    -sz * sinzloc * cosdrs - sz * coszloc * sindrs -
                    cz * sinzloc * sindrs + cz * coszloc * cosdrs,
                    -sz * sinzloc * sindrs + sz * coszloc * cosdrs +
                    cz * sinzloc * cosdrs + cz * coszloc * sindrs)
                # the node's own direction; 1 - dirz = LRS / dist
                rdist = 1. / dist
                dirx_n = drx * rdist
                diry_n = dry * rdist
                A1m = LRS * rdist
                dirz_n = 1. - A1m
            else:
                phz = wcb * (tg - dirz_n * trajz_)
                phxy = wcb * (dirx_n * trajx_ + diry_n * trajy_)
                sinphz, cosphz = torch.sin(phz), torch.cos(phz)
                sinphxy, cosphxy = torch.sin(phxy), torch.cos(phxy)
                eucos = torch.complex(sinphz * cosphxy - cosphz * sinphxy,
                                      cosphz * cosphxy + sinphz * sinphxy)
            smTerm = rg2 + betax_ ** 2 + betay_ ** 2
            # B1m := 1 - betaz, never formed as a difference of ~1 numbers
            B1m = 0.5 * smTerm + 0.125 * smTerm ** 2 + 0.0625 * smTerm ** 3
            betaz = 1 - B1m
            betaPx = betay_ * Bz - betaz * By
            betaPy = -betax_ * Bz + betaz * Bx
            betaPz = betax_ * By - betay_ * Bx
            one_minus_nb = (B1m + betaz * A1m -
                            dirx_n * betax_ - diry_n * betay_)
            rkrel = 1. / one_minus_nb
            eucos = eucos * nd['ag'] * rkrel ** 2
            bnx = dirx_n - betax_
            bny = diry_n - betay_
            bnz = B1m - A1m
            dirDotBetaP = dirx_n * betaPx + diry_n * betaPy + \
                dirz_n * betaPz
            dirDotDmB = dirx_n * bnx + diry_n * bny + dirz_n * bnz
            s = torch.sum(eucos * em * (bnx * dirDotBetaP -
                                        betaPx * dirDotDmB), dim=1)
            p = torch.sum(eucos * em * (bny * dirDotBetaP -
                                        betaPy * dirDotDmB), dim=1)
            Is = s if Is is None else Is + s
            Ip = p if Ip is None else Ip + p

        ab = 0.5 / PI / (1. - 0.5 * revgamma2 +
                         betam * EMC ** 2 * revgamma2)
        bwFact = 0.001 if self.distE == 'BW' else 1. / w
        Amp2Flux = FINE_STR * bwFact * self.eI / SIE0
        integralField = torch.abs(Is) ** 2 + torch.abs(Ip) ** 2
        sqA = sqrt_rn(Amp2Flux * torch.ones_like(w))
        return (Amp2Flux * 0.25 * self.dstep ** 2 * ab ** 2 * integralField,
                sqA * Is * 0.5 * self.dstep * ab,
                sqA * Ip * 0.5 * self.dstep * ab)


def _rk4_trajectory(wtGrid, Bx, By, Bz):
    """The scaled (e / (m c gamma) = 1) electron trajectory by RK4 over the
    doubled field grid: three passes, for the mean velocity, the mean
    position and then the trajectory, float64 numpy.  Returns (betax,
    betay, betam, trajx, trajy, trajz)."""
    def f_beta(B, beta):
        return np.array((beta[1] * B[2] - B[1], B[0] - beta[0] * B[2]))

    def f_traj(beta):
        betaz = -0.5 * (beta[0] ** 2 + beta[1] ** 2)
        return np.array((beta[0], beta[1], betaz))

    def fields(i):
        return [(Bx[k], By[k], Bz[k]) for k in (2 * i, 2 * i + 1, 2 * i + 2)]

    def step(i, beta, traj):
        h = wtGrid[i + 1] - wtGrid[i]
        B0, B1, B2 = fields(i)
        k1b = h * f_beta(B0, beta)
        k1t = h * f_traj(beta)
        k2b = h * f_beta(B1, beta + 0.5 * k1b)
        k2t = h * f_traj(beta + 0.5 * k1b)
        k3b = h * f_beta(B1, beta + 0.5 * k2b)
        k3t = h * f_traj(beta + 0.5 * k2b)
        k4b = h * f_beta(B2, beta + k3b)
        k4t = h * f_traj(beta + k3b)
        return (h, beta + (k1b + 2 * k2b + 2 * k3b + k4b) / 6.,
                traj + (k1t + 2 * k2t + 2 * k3t + k4t) / 6.)

    n = len(wtGrid)
    length = wtGrid[-1] - wtGrid[0]
    beta_next = np.zeros(2)
    beta0 = np.zeros(2)
    for i in range(n - 1):
        h = wtGrid[i + 1] - wtGrid[i]
        B0, B1, B2 = fields(i)
        k1 = h * f_beta(B0, beta_next)
        k2 = h * f_beta(B1, beta_next + 0.5 * k1)
        k3 = h * f_beta(B1, beta_next + 0.5 * k2)
        k4 = h * f_beta(B2, beta_next + k3)
        beta_next = beta_next + (k1 + 2 * k2 + 2 * k3 + k4) / 6.
        beta0 += h * beta_next
    beta0 /= -length

    beta_next, traj_next = beta0.copy(), np.zeros(3)
    traj0 = np.zeros(3)
    betam_int = 0.0
    for i in range(n - 1):
        h, beta_next, traj_next = step(i, beta_next, traj_next)
        traj0 += h * traj_next
        betam_int += beta_next[0] ** 2 + beta_next[1] ** 2
    traj0 /= -length
    betam_int *= -0.5 / (n - 1)

    beta_next, traj_next = beta0.copy(), traj0.copy()
    rows = [(beta0[0], beta0[1], traj0[0], traj0[1], traj0[2])]
    for i in range(n - 1):
        _, beta_next, traj_next = step(i, beta_next, traj_next)
        rows.append((beta_next[0], beta_next[1], *traj_next))
    betax, betay, trajx, trajy, trajz = (np.array(c) for c in zip(*rows))
    return betax, betay, betam_int, trajx, trajy, trajz
