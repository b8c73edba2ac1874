"""Synchrotron sources: the bending magnet, the multipole wiggler and the
electron-beam base they share with the undulator.

Port of the reference package's ``sources/synchrotron.py``:
``_SynchrotronBase`` (the e-beam parameters, the acceptance window
``Theta_min/max``, ``Psi_min/max``, ``xzE``, the energy-spread draw, the
ray-mode ``shine`` and the field maps on angular meshes,
``multi_electron_stack`` and ``intensities_on_mesh``), ``BendingMagnet``
(amplitudes from the modified Bessel functions K_1/3, K_2/3) and
``Wiggler`` (the bending-magnet amplitudes with the critical energy of each
pole's local field and ray origins along the poles).

``shine`` samples by importance resampling, as the reference does: a fixed
batch of ``nrays * oversample`` candidates (E, theta, psi) drawn uniformly
in the acceptance window is evaluated once by ``build_I_map``, then exactly
``nrays`` rays are drawn with probability proportional to the intensity.
The draw is an inverse CDF, as the reference's ``choice`` with ``p`` is: a
cumulative sum of the intensities in the beam's dtype (on the card in rows,
so that a seed gives the same rays on every run: ``cumsum_rows``), uniforms
scaled by its last value, and a sorted search.  Each draw can be injected
(``draws=``), so the port can be held to the reference on the same numbers.

The field maps evaluate ``build_I_map`` on the mesh on the source's
device, in ray blocks; what follows (Stokes parameters or the orbital
angular momentum terms, the energy-spread average, the convolution with
the e-beam divergence) is host numpy and scipy, as in the reference.

The Bessel functions are evaluated in float64 whatever the rays' dtype and
then cast: in float32 the reference's 40-term series overflows (q^k is inf
for q = (x/2)^2 > 9.7, and the coefficient of k = 39 underflows to 0), so
K is NaN for x in (6.2, 8), and the two series cancel to errors of ~3e-4
and ~9e-3 at x = 4 and 6 (ROADMAP C15).  In float64 they are the
reference's operations in its order.
"""
from __future__ import annotations

import functools
import inspect
import math

import numpy as np
import torch

from .. import config
from ..beam import Beam
from ..ops.dd import sqrt_rn
from ..physconsts import (C, CHeVcm, E0, E2W, EV2ERG, FINE_STR, K2B, M0, PI,
                          PI2, SIE0, SIM0, SQ3)
from ..profiler import stage
from ..transforms import rotate_xyz, virgin_local_to_global
from .geometric import _draw

#: the draws of a ray-mode shine, in the reference's order; each is a
#: tensor of uniforms in [0, 1) or of standard normals, and 'pole' (the
#: wiggler's) of integers in [-Np, Np)
DRAWS = ('E', 'theta', 'psi', 'gamma', 'choice', 'dtheta', 'smear', 'dpsi',
         'x', 'z', 'pole')
#: rays per block of ``build_I_map`` above two blocks (the bending
#: magnet's Bessel series hold (rays, 40) float64 temporaries)
RAY_BLOCK = 1 << 20
#: the row length of the card's reproducible cumulative sum
SCAN_ROW = 1024


def cumsum_rows(p):
    """The cumulative sum of the 1D tensor *p*, with the same bits on every
    run.  On the CPU it is torch's sequential scan.  On the card torch's 1D
    scan adds its tiles' partial sums in the order the tiles finish, so its
    last bits, and with them a resampled ray here and there, change from
    run to run; here each row of :data:`SCAN_ROW` values is scanned by one
    block, then the rows' totals the same way, and each row gets the sum of
    the rows before it."""
    n = p.shape[0]
    if p.device.type == 'cpu' or n <= SCAN_ROW:
        return torch.cumsum(p, dim=0)
    rows = torch.cat([p, p.new_zeros((-n) % SCAN_ROW)]).reshape(-1,
                                                                SCAN_ROW)
    inner = torch.cumsum(rows, dim=1)
    before = cumsum_rows(inner[:, -1])
    before = torch.cat([before.new_zeros(1), before[:-1]])
    return (inner + before[:, None]).reshape(-1)[:n]


@functools.lru_cache(maxsize=None)
def _series_coeffs(nu, nterms, device):
    """1 / (k! Gamma(k + nu + 1)), k < *nterms*, as a float64 tensor on
    *device*, copied there once."""
    import scipy.special as sp
    k = np.arange(nterms)
    return torch.as_tensor(np.exp(-sp.gammaln(k + 1) -
                                  sp.gammaln(k + nu + 1)),
                           dtype=torch.float64, device=device)


def _besseli_series(nu, x, nterms=40):
    """I_nu(x) by its power series, *nterms* terms (*x* float64)."""
    half = x / 2
    coeffs = _series_coeffs(nu, nterms, x.device)
    q = half[..., None] ** 2
    powers = q ** torch.arange(nterms, dtype=x.dtype, device=x.device)
    return half ** nu * torch.sum(powers * coeffs, dim=-1)


def _kv_nu(nu, x):
    """The modified Bessel function K_nu(x) for nu = 1/3, 2/3, evaluated in
    float64 and returned in *x*'s dtype: for x < 8, pi/2 (I_-nu - I_nu) /
    sin(pi nu) by the series; above, the asymptotic expansion
    sqrt(pi / 2x) e^-x sum a_k(nu) / x^k."""
    x64 = x.to(torch.float64)
    xs = torch.clamp(x64, 1e-12, 8.0)
    small = (PI / 2) * (_besseli_series(-nu, xs) -
                        _besseli_series(nu, xs)) / math.sin(PI * nu)
    xl = torch.clamp(x64, min=8.0)
    mu = 4 * nu * nu
    term = torch.ones_like(xl)
    acc = torch.ones_like(xl)
    for k in range(1, 14):
        term = term * (mu - (2 * k - 1) ** 2) / (8 * k * xl)
        acc = acc + term
    large = sqrt_rn(config.scalar(PI, xl.dtype, xl.device) / (2 * xl)) * \
        torch.exp(-xl) * acc
    return torch.where(x64 < 8.0, small, large).to(x.dtype)


def _nonzero(v):
    """Whether a term scaled by *v* must be kept: *v* > 0, or *v* is a
    tensor that records a gradient (adding a zero-scaled term is exact)."""
    if isinstance(v, torch.Tensor) and v.requires_grad:
        return True
    return config.host_float(v) > 0


def _create_args(args):
    """A source's ``create()`` arguments as the (name, value) pairs a layout
    records (``beamline._element_params``): its fields hold derived values
    in other units (the acceptance in rad, the e-beam sizes from the
    emittances), which ``create()`` would read wrongly.  The dtype and
    device are left out, and None values."""
    args = dict(args)
    args.update(args.pop('kwargs', None) or {})
    out = []
    for k, v in args.items():
        if k in ('cls', 'dtype', 'device') or k.startswith('_') or \
                v is None:
            continue
        if hasattr(v, 'tolist'):
            v = v.tolist()
        out.append((k, list(v) if isinstance(v, tuple) else v))
    return tuple(out)


def _scalar(v):
    """A parameter as a Python float, or the tensor itself where a gradient
    is recorded through it."""
    if isinstance(v, torch.Tensor) and v.requires_grad:
        return v
    return config.host_float(v)


class _SynchrotronBase(config.Replaceable):
    """Shared e-beam / acceptance-window parameters.  Energies in eV, sizes
    in mm, angles in rad; the e-beam sizes and divergences are Python floats
    or the tensors that were passed in."""

    isMPW = False
    #: the create() arguments a layout records (:func:`_create_args`)
    createArgs = None

    def __init__(self, name='', center=(0, 0, 0), eE=6.0, eI=0.1,
                 eEspread=0.0, dx=0.0, dz=0.0, dxprime=0.0, dzprime=0.0,
                 eMin=5000.0, eMax=15000.0, xPrimeMax=0.5e-3,
                 zPrimeMax=0.5e-3, xPrimeMin=None, zPrimeMin=None,
                 distE='eV', nrays=None, oversample=2, pitch=0.0, yaw=0.0,
                 dtype=None, device=None):
        self.name = name
        self.center = tuple(config.number(c) for c in center)
        self.eE = float(eE)
        self.eI = config.number(eI)
        self.eEspread = float(eEspread)
        self.dx, self.dz = config.number(dx), config.number(dz)
        self.dxprime = config.number(dxprime)
        self.dzprime = config.number(dzprime)
        self.eMin, self.eMax = float(eMin), float(eMax)
        self.xPrimeMax, self.zPrimeMax = float(xPrimeMax), float(zPrimeMax)
        self.xPrimeMin, self.zPrimeMin = xPrimeMin, zPrimeMin
        self.distE = distE
        self.nrays = nrays
        self.oversample = oversample
        self.pitch, self.yaw = float(pitch), float(yaw)
        self.dtype, self.device = dtype, device

    @property
    def gamma(self):
        return self.eE * 1e9 * EV2ERG / (M0 * C ** 2)

    def _export_params(self):
        """A layout's (drop, extra): the create() arguments in place of the
        fields, which hold derived values in other units (ROADMAP C23)."""
        if self.createArgs is None:
            return (), {}
        from ..beamline import _create_signature_names
        return (tuple(_create_signature_names(type(self))),
                dict(self.createArgs))

    @property
    def gamma2(self):
        return self.gamma ** 2

    @property
    def Theta_min(self):
        return (self.xPrimeMin if self.xPrimeMin is not None
                else -self.xPrimeMax) - _scalar(self.dxprime)

    @property
    def Theta_max(self):
        return self.xPrimeMax + _scalar(self.dxprime)

    @property
    def Psi_min(self):
        return (self.zPrimeMin if self.zPrimeMin is not None
                else -self.zPrimeMax) - _scalar(self.dzprime)

    @property
    def Psi_max(self):
        return self.zPrimeMax + _scalar(self.dzprime)

    @property
    def xzE(self):
        """Acceptance-volume factor."""
        return (self.eMax - self.eMin) * (self.Theta_max - self.Theta_min) \
            * (self.Psi_max - self.Psi_min)

    def _sample_gamma(self, generator, gamma, shape, dtype, device):
        """Lorentz factors: *gamma* spread by ``eEspread`` (normal draws
        from *generator*, made on the CPU in float64 so that one seed gives
        the same values on any device), or *gamma* itself."""
        if self.eEspread > 0:
            g = torch.randn(shape, generator=generator, dtype=torch.float64)
            return gamma * (1 + self.eEspread * g.to(device=device,
                                                     dtype=dtype))
        return torch.full(shape, gamma, dtype=dtype, device=device)

    # ---- field maps on angular meshes ---------------------------------
    def _auto_meshes(self, energy, theta, psi, nE=65, nTheta=33, nPsi=33):
        """The (energy, theta, psi) axes as float64 numpy; 'auto' (or None)
        spans the acceptance window."""
        if energy is None or isinstance(energy, str):
            energy = np.linspace(self.eMin, self.eMax, nE)
        if theta is None or isinstance(theta, str):
            theta = np.linspace(self.Theta_min, self.Theta_max, nTheta)
        if psi is None or isinstance(psi, str):
            psi = np.linspace(self.Psi_min, self.Psi_max, nPsi)
        return (np.atleast_1d(np.asarray(energy, float)),
                np.atleast_1d(np.asarray(theta, float)),
                np.atleast_1d(np.asarray(psi, float)))

    def _I_map_kwargs(self, harmonic, dgamma):
        """The keyword arguments of ``build_I_map`` that this source takes:
        *harmonic* and *dgamma* where its signature names them."""
        params = inspect.signature(self.build_I_map).parameters
        kw = {}
        if 'harmonic' in params:
            kw['harmonic'] = harmonic
        if 'dgamma' in params and dgamma is not None:
            kw['dgamma'] = dgamma
        return kw

    def _I_map_blocks(self, generator, w, ddtheta, ddpsi, ray_block=None,
                      **kw):
        """``build_I_map`` over the rays, in blocks of *ray_block*
        (:data:`RAY_BLOCK`) above two blocks: the same results with bounded
        temporaries.  Per-ray tensors in *kw* are cut with the rays."""
        n = w.shape[0]
        rb = RAY_BLOCK if ray_block is None else int(ray_block)
        if n <= 2 * rb:
            return self.build_I_map(generator, w, ddtheta, ddpsi, **kw)

        def part(v, j):
            per_ray = isinstance(v, torch.Tensor) and v.ndim > 0 and \
                v.shape[0] == n
            return v[j:j + rb] if per_ray else v
        outs = [self.build_I_map(generator, w[j:j + rb], ddtheta[j:j + rb],
                                 ddpsi[j:j + rb],
                                 **{k: part(v, j) for k, v in kw.items()})
                for j in range(0, n, rb)]
        return tuple(torch.cat(col) for col in zip(*outs))

    def multi_electron_stack(self, generator=None, energy='auto',
                             theta='auto', psi='auto', harmonic=None,
                             withElectronDivergence=True, draws=None):
        """Es and Ep shaped (energy, theta, psi[, harmonic]) on the source's
        device, where axis 0 holds macro-electrons, each with its own
        angular offsets (normal draws of ``dxprime``, ``dzprime``) and
        Lorentz-factor shift.  *draws* may give the (len(energy),) standard
        normals 'dtheta', 'dpsi' and 'gamma' in place of *generator*'s."""
        dt = config.resolve_dtype(self.dtype)
        dev = config.resolve_device(self.device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        draws = dict(draws or {})
        energy, theta, psi = self._auto_meshes(energy, theta, psi)
        nmacro = len(energy)
        tomesh = [energy, theta, psi]
        if harmonic is not None:
            tomesh.append(np.atleast_1d(np.asarray(harmonic, float)))
        mesh = [torch.as_tensor(m, dtype=dt, device=dev)
                for m in np.meshgrid(*tomesh, indexing='ij')]

        def normals(name):
            if name in draws:
                return torch.as_tensor(draws[name], dtype=dt, device=dev)
            return _draw(torch.randn, generator, nmacro, dt, dev)
        expand = (slice(None),) + (None,) * (len(tomesh) - 1)
        if withElectronDivergence and _nonzero(self.dxprime):
            mesh[1] = mesh[1] + (self.dxprime * normals('dtheta'))[expand]
        if withElectronDivergence and _nonzero(self.dzprime):
            mesh[2] = mesh[2] + (self.dzprime * normals('dpsi'))[expand]
        dgamma = None
        if self.eEspread > 0:
            spr = self.gamma * self.eEspread * normals('gamma')
            dgamma = torch.broadcast_to(spr[expand], mesh[0].shape).ravel()
        sh = tuple(len(m) for m in tomesh)
        xH = mesh[3].ravel() if harmonic is not None else None
        res = self._I_map_blocks(generator, mesh[0].ravel(),
                                 mesh[1].ravel(), mesh[2].ravel(),
                                 **self._I_map_kwargs(xH, dgamma))
        return res[1].reshape(sh), res[2].reshape(sh)

    def intensities_on_mesh(self, generator=None, energy='auto',
                            theta='auto', psi='auto', harmonic=None,
                            eSpreadSigmas=3.5, eSpreadNSamples=36,
                            mode='constant', resultKind='Stokes'):
        """The Stokes parameters [s0, s1/s0, s2/s0, s3/s0] (or [Is, Ip,
        OAMs, OAMp, Es, Ep] for *resultKind* 'vortex') on the (energy,
        theta, psi[, harmonic]) mesh as float64 numpy: the fields on the
        source's device, then on the host the incoherent average over the
        energy spread (*eSpreadNSamples* Lorentz factors over
        +-*eSpreadSigmas*, where ``build_I_map`` takes a shift) and the
        convolution with the e-beam divergence (``gaussian_filter`` with
        *mode*)."""
        assert resultKind in ('Stokes', 'vortex')
        dt = config.resolve_dtype(self.dtype)
        dev = config.resolve_device(self.device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        energy, theta, psi = self._auto_meshes(energy, theta, psi)
        tomesh = [energy, theta, psi]
        sh = [len(energy), len(theta), len(psi)]
        ispread = None
        if harmonic is not None:
            harmonic = np.atleast_1d(np.asarray(harmonic, float))
            tomesh.append(harmonic)
            sh.append(len(harmonic))
        supports_dgamma = 'dgamma' in self._I_map_kwargs(None, 0.0)
        if self.eEspread > 0 and supports_dgamma:
            spr = np.linspace(-eSpreadSigmas, eSpreadSigmas,
                              eSpreadNSamples)
            dgamma_1d = float(self.gamma) * spr * self.eEspread
            wspr = np.exp(-0.5 * spr ** 2)
            wspr /= wspr.sum()
            tomesh.append(dgamma_1d)
            ispread = len(tomesh) - 1
            sh.append(len(dgamma_1d))
        mesh = np.meshgrid(*tomesh, indexing='ij')

        def T(m):
            return torch.as_tensor(m.ravel(), dtype=dt, device=dev)
        xH = T(mesh[3]) if harmonic is not None else None
        xG = T(mesh[ispread]) if ispread else None
        res = self._I_map_blocks(generator, T(mesh[0]), T(mesh[1]),
                                 T(mesh[2]), **self._I_map_kwargs(xH, xG))
        Es = res[1].cpu().numpy().reshape(sh)
        Ep = res[2].cpu().numpy().reshape(sh)

        Is = (Es * Es.conj()).real.astype(float)
        Ip = (Ep * Ep.conj()).real.astype(float)
        if resultKind == 'Stokes':
            Isp = Es * Ep.conj()
        else:   # the orbital angular momentum terms
            dEsdth, dEsdps = np.gradient(Es, theta, psi, axis=(1, 2))
            dEpdth, dEpdps = np.gradient(Ep, theta, psi, axis=(1, 2))
            th_b = theta.reshape((1, -1) + (1,) * (Es.ndim - 2))
            ps_b = psi.reshape((1, 1, -1) + (1,) * (Es.ndim - 3))
            lsy = 1j * (dEsdth * ps_b - dEsdps * th_b)
            lpy = 1j * (dEpdth * ps_b - dEpdps * th_b)
            OAMs = (Es.conj() * lsy).real.astype(float)
            OAMp = (Ep.conj() * lpy).real.astype(float)

        if ispread:
            ws = wspr.reshape((1,) * (len(sh) - 1) + (-1,))
            Is = (Is * ws).sum(axis=-1)
            Ip = (Ip * ws).sum(axis=-1)
            if resultKind == 'Stokes':
                Isp = (Isp * ws).sum(axis=-1)
            else:
                OAMs = (OAMs * ws).sum(axis=-1)
                OAMp = (OAMp * ws).sum(axis=-1)
                Es = (Es * ws).sum(axis=-1)
                Ep = (Ep * ws).sum(axis=-1)

        if resultKind == 'Stokes':
            s0 = Is + Ip
            s1 = Is - Ip
            s2 = 2.0 * np.real(Isp)
            s3 = -2.0 * np.imag(Isp)
            ss = [s0, s1, s2, s3]
        else:
            ss = [Is, Ip, OAMs, OAMp, Es, Ep]

        dxp = config.host_float(self.dxprime)
        dzp = config.host_float(self.dzprime)
        if (dxp > 0 or dzp > 0) and len(theta) > 1 and len(psi) > 1:
            from scipy.ndimage import gaussian_filter
            Sx = dxp / (theta[1] - theta[0])
            Sz = dzp / (psi[1] - psi[0])

            def filt(a2):
                if np.iscomplexobj(a2):
                    return (gaussian_filter(a2.real, [Sx, Sz], mode=mode) +
                            1j * gaussian_filter(a2.imag, [Sx, Sz],
                                                 mode=mode))
                return gaussian_filter(a2, [Sx, Sz], mode=mode)

            for arr in ss:
                if harmonic is None:
                    for ie in range(len(energy)):
                        arr[ie, :, :] = filt(arr[ie, :, :])
                else:
                    for ie in range(len(energy)):
                        for ih in range(len(harmonic)):
                            arr[ie, :, :, ih] = filt(arr[ie, :, :, ih])

        if resultKind == 'Stokes':
            with np.errstate(divide='ignore', invalid='ignore'):
                return [s0,
                        np.where(s0, s1 / s0, s0),
                        np.where(s0, s2 / s0, s0),
                        np.where(s0, s3 / s0, s0)]
        return ss

    # ---- ray mode -----------------------------------------------------
    #: the draws a source needs beyond the undulator's ('smear': the
    #: bending magnet's 1/gamma opening in theta; 'pole': the wiggler's
    #: pole of each ray)
    _extra_draws = ()

    def _draws(self, generator, draws, dt, dev, M, nrays):
        """The draws of a shine, in the beam's dtype on its device: those
        in *draws* as given, the others from *generator* (a CUDA generator
        draws on the card in the beam's dtype, a CPU one in float64 on the
        host)."""
        draws = dict(draws or {})
        sizes = dict(E=M, theta=M, psi=M, gamma=M)
        out = {}
        for name in DRAWS:
            if name in ('smear', 'pole') and name not in self._extra_draws:
                continue
            if name == 'gamma' and not self.eEspread > 0:
                continue
            n = sizes.get(name, nrays)
            if name == 'pole':
                Np = int(self.Np)
                out[name] = torch.as_tensor(draws[name], device=dev) \
                    if name in draws else torch.randint(
                        -Np, Np, (n,), generator=generator,
                        device=generator.device).to(dev)
            elif name in draws:
                out[name] = torch.as_tensor(draws[name], dtype=dt,
                                            device=dev)
            else:
                fn = torch.randn if name in ('gamma', 'dtheta', 'smear',
                                             'dpsi', 'x', 'z') \
                    else torch.rand
                out[name] = _draw(fn, generator, n, dt, dev)
        return out

    def shine(self, generator=None, toGlobal=True, withAmplitudes=True,
              fixedEnergy=False, draws=None):
        """A Monte-Carlo source beam of ``nrays`` rays by importance
        resampling of ``nrays * oversample`` candidates.  *generator* is a
        ``torch.Generator`` (seed 0 on the beam's device if None); *draws*
        maps names of :data:`DRAWS` to injected draws.  The beam is made in
        the source's dtype on its device.  While the profiler traces, the
        call is the span ``sources.shine``."""
        with stage('sources.shine',
                   device=config.resolve_device(self.device)):
            return self._shine(generator, toGlobal, withAmplitudes,
                               fixedEnergy, draws)

    def _shine(self, generator, toGlobal, withAmplitudes, fixedEnergy,
               draws):
        dt = config.resolve_dtype(self.dtype)
        dev = config.resolve_device(self.device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        nrays = self.nrays or config.NRAYS
        M = nrays * self.oversample
        r = self._draws(generator, draws, dt, dev, M, nrays)

        def uniform(u, lo, hi):
            return torch.clamp(u * (hi - lo) + lo, min=lo)
        rE = uniform(r['E'], self.eMin, self.eMax)
        if fixedEnergy:
            rE = torch.full((M,), float(fixedEnergy), dtype=dt, device=dev)
        rTheta = uniform(r['theta'], self.Theta_min, self.Theta_max)
        rPsi = uniform(r['psi'], self.Psi_min, self.Psi_max)
        gamma = self.gamma * (1 + self.eEspread * r['gamma']) \
            if 'gamma' in r else None
        Intensity, mJss, mJpp = self._I_map_blocks(
            generator, rE, rTheta, rPsi, gamma=gamma)

        # resample ~ Intensity: the inverse CDF of the reference's choice
        sumI = torch.sum(Intensity)
        p = Intensity / torch.clamp(sumI, min=1e-300)
        p_cuml = cumsum_rows(p)
        idx = torch.searchsorted(p_cuml, p_cuml[-1] * (1 - r['choice']))
        idx = torch.clamp(idx, max=M - 1)
        rE = rE[idx]
        Theta0 = rTheta[idx]
        Psi0 = rPsi[idx]
        mJss = mJss[idx]
        mJpp = mJpp[idx]

        dtheta = torch.zeros((nrays,), dtype=dt, device=dev)
        dpsi = torch.zeros((nrays,), dtype=dt, device=dev)
        if _nonzero(self.dxprime):
            dtheta = dtheta + self.dxprime * r['dtheta']
        if 'smear' in r:
            dtheta = dtheta + r['smear'] / self.gamma
        if _nonzero(self.dzprime):
            dpsi = dpsi + self.dzprime * r['dpsi']
        a = torch.tan(Theta0 + dtheta)
        c = torch.tan(Psi0 + dpsi)

        intensS = (mJss * torch.conj(mJss)).real
        intensP = (mJpp * torch.conj(mJpp)).real
        sSP = intensS + intensP
        safe = torch.clamp(sSP, min=1e-300)
        x, y, z = self._sample_positions(rE, Theta0, r)
        zero = torch.zeros_like(sSP)
        Jss = torch.where(sSP > 0, intensS / safe, zero)
        Jpp = torch.where(sSP > 0, intensP / safe, zero)
        Jsp = torch.zeros_like(mJss) if self.isMPW else \
            torch.where(sSP > 0, mJss * torch.conj(mJpp) / safe,
                        torch.zeros_like(mJss))
        norm = sqrt_rn(a ** 2 + 1.0 + c ** 2)
        scale = sumI / M * self.xzE
        beam = Beam(
            x=x, y=y, z=z, a=a / norm, b=1.0 / norm, c=c / norm, E=rE,
            state=torch.ones((nrays,), dtype=torch.int32, device=dev),
            path=torch.zeros((nrays,), dtype=dt, device=dev),
            Jss=Jss, Jpp=Jpp, Jsp=Jsp,
            Es=mJss if withAmplitudes else None,
            Ep=mJpp if withAmplitudes else None,
            accepted=scale * nrays, acceptedE=torch.sum(rE) * scale * SIE0,
            seeded=torch.tensor(float(nrays), dtype=dt, device=dev),
            seededI=scale * nrays)
        if self.pitch != 0:     # as the reference: a yaw alone is not
            #                     applied
            x2, y2, z2 = rotate_xyz(beam.x, beam.y, beam.z,
                                    pitch=self.pitch, yaw=self.yaw)
            a2, b2, c2 = rotate_xyz(beam.a, beam.b, beam.c,
                                    pitch=self.pitch, yaw=self.yaw)
            beam = beam.replace(x=x2, y=y2, z=z2, a=a2, b=b2, c=c2)
        if toGlobal:
            beam = virgin_local_to_global(beam, self.center)
        return beam


def _ebeam_sizes(eSigmaX, eSigmaZ, eEpsilonX, eEpsilonZ, betaX, betaZ):
    """(dx, dz, dxprime, dzprime) of the e-beam: sizes in um or from the
    emittances (nm rad) and beta functions (m), as mm and rad."""
    epsX = eEpsilonX * 1e-6
    epsZ = eEpsilonZ * 1e-6
    if eSigmaX is not None:
        dx = eSigmaX * 1e-3
    else:
        dx = math.sqrt(epsX * betaX * 1e3) if betaX else 0.0
    if eSigmaZ is not None:
        dz = eSigmaZ * 1e-3
    else:
        dz = math.sqrt(epsZ * betaZ * 1e3) if betaZ else 0.0
    return (dx, dz, epsX / dx if dx > 0 else 0.0,
            epsZ / dz if dz > 0 else 0.0)


class BendingMagnet(_SynchrotronBase):
    """Bending-magnet source of field *B0* (T): amplitudes from the modified
    Bessel functions; flux per eV (``distE`` 'eV') or per 0.1% bandwidth
    ('BW')."""

    Np = 0.5
    _extra_draws = ('smear',)

    def __init__(self, B0=1.0, **kwargs):
        super().__init__(**kwargs)
        self.B0 = float(B0)

    @classmethod
    def create(cls, name='', center=(0, 0, 0), nrays=None, eE=6.0, eI=0.1,
               eEspread=0.0, eSigmaX=None, eSigmaZ=None, eEpsilonX=1.0,
               eEpsilonZ=0.01, betaX=9.0, betaZ=2.0, B0=1.0, rho=None,
               eMin=5000.0, eMax=15000.0, xPrimeMax=0.5, zPrimeMax=0.5,
               distE='eV', pitch=0.0, yaw=0.0, oversample=2, dtype=None,
               device=None, **kwargs):
        """The reference's constructor arguments (the acceptance in mrad,
        e-beam emittances in nm rad, sizes in um; *rho*, the orbit radius in
        m, in place of *B0*).  *dtype* and *device* are those of the beams
        ``shine`` makes."""
        createArgs = _create_args(locals())
        gamma = eE * 1e9 * EV2ERG / (M0 * C ** 2)
        if rho is not None and not B0:
            B0 = M0 * C ** 2 * gamma / rho / E0 / 1e6
        dx, dz, dxprime, dzprime = _ebeam_sizes(
            eSigmaX, eSigmaZ, eEpsilonX, eEpsilonZ, betaX, betaZ)
        src = cls(name=name, center=center, eE=eE, eI=eI,
                  eEspread=eEspread, dx=dx, dz=dz, dxprime=dxprime,
                  dzprime=dzprime, eMin=eMin, eMax=eMax,
                  xPrimeMax=xPrimeMax * 1e-3, zPrimeMax=zPrimeMax * 1e-3,
                  distE=distE, nrays=nrays, oversample=oversample,
                  pitch=pitch, yaw=yaw, B0=B0, dtype=dtype, device=device,
                  **kwargs)
        src.createArgs = createArgs
        return src

    @property
    def ro(self):
        """The orbit's radius of curvature, m."""
        return M0 * C ** 2 * self.gamma / self.B0 / E0 / 1e6

    def build_I_map(self, generator, dde, ddtheta, ddpsi, gamma=None):
        """(flux, amp_s, amp_p) at photon energies *dde* (eV) and angles
        (*ddtheta*, *ddpsi*) (rad).  With an energy spread the Lorentz
        factor is *gamma* (per ray) where given, else drawn from
        *generator*."""
        if gamma is None:
            gamma = self._sample_gamma(generator, self.gamma, dde.shape,
                                       dde.dtype, dde.device) \
                if self.eEspread > 0 else self.gamma
        gamma2 = gamma ** 2
        w_cr = 1.5 * gamma2 * self.B0 * SIE0 / SIM0
        if self.isMPW:
            s = torch.clamp(ddtheta * gamma / self.K, -1.0, 1.0)
            w_cr = w_cr * torch.sin(torch.arccos(s))
        if isinstance(w_cr, torch.Tensor):
            w_cr = torch.where(torch.isfinite(w_cr) & (w_cr != 0), w_cr,
                               torch.full_like(w_cr, 1e-30))
        elif not (math.isfinite(w_cr) and w_cr != 0):
            w_cr = 1e-30

        gammapsi = gamma * ddpsi
        gamma2psi2p1 = gammapsi ** 2 + 1
        eta = 0.5 * dde * E2W / w_cr * gamma2psi2p1 ** 1.5

        ampSP = -0.5j * SQ3 / PI * gamma * dde * E2W / w_cr * gamma2psi2p1
        ampS = ampSP * _kv_nu(2. / 3., eta)
        ampP = 1j * gammapsi * ampSP * _kv_nu(1. / 3., eta) / \
            sqrt_rn(gamma2psi2p1)
        zero = torch.zeros_like(ampS)
        ampS = torch.where(torch.isfinite(torch.abs(ampS)), ampS, zero)
        ampP = torch.where(torch.isfinite(torch.abs(ampP)), ampP, zero)

        bwFact = 0.001 if self.distE == 'BW' else 1. / dde
        Amp2Flux = FINE_STR * bwFact * self.eI / SIE0 * 2 * self.Np
        sqA = sqrt_rn(Amp2Flux * torch.ones_like(dde))
        return (Amp2Flux * (torch.abs(ampS) ** 2 + torch.abs(ampP) ** 2),
                sqA * ampS, sqA * ampP)

    def _sample_positions(self, E, Theta0, r):
        """Ray origins on the orbit's arc: z ~ N(0, dz) from the normals
        r['z'], the radius spread by dx from r['x']."""
        z = self.dz * r['z']
        R1 = self.ro * 1e3 + self.dx * r['x']
        x = -R1 * torch.cos(Theta0) + self.ro * 1000.
        y = R1 * torch.sin(Theta0)
        return x, y, z


class Wiggler(BendingMagnet):
    """Multipole wiggler of deflection parameter *K*, period *L0* (mm) and
    *n* periods: the bending-magnet amplitudes with the critical energy of
    the local field at each angle, ray origins on the poles."""

    isMPW = True
    _extra_draws = ('pole',)

    def __init__(self, K=10.0, L0=50.0, n=40, **kwargs):
        super().__init__(**kwargs)
        self.K = float(K)
        self.L0 = float(L0)
        self.n = int(n)

    @classmethod
    def create(cls, name='', K=10.0, period=50.0, n=40, B0=None, **kwargs):
        """*K* (or the peak field *B0*, T), *period* (mm), *n*; the other
        arguments are the bending magnet's, with xPrimeMax 1 mrad by
        default, reduced to K / gamma."""
        kwargs.setdefault('xPrimeMax', 1.0)
        createArgs = _create_args(locals())
        if B0 is not None:
            K = B0 * period / K2B
        B = K2B * K / period
        src = super(Wiggler, cls).create(name=name, B0=B, K=K, L0=period,
                                         n=n, **kwargs)
        xpm = min(src.xPrimeMax, (K if K > 0 else 2.0) / src.gamma)
        return src.replace(xPrimeMax=xpm, createArgs=createArgs)

    @property
    def Np(self):
        return self.n

    @property
    def X0(self):
        """Amplitude of the wiggling orbit, mm."""
        return 0.5 * self.K * self.L0 / self.gamma / PI

    def _sample_positions(self, E, Theta0, r):
        """Ray origins on the poles: y from the angle's place in the
        period and the pole r['pole'] in [-Np, Np); x on the orbit spread
        by the source size from r['x'], z from r['z']."""
        sigma_r2 = 2 * (CHeVcm / E * 10 * self.L0 * self.Np) / PI2 ** 2
        sourceSIGMAx = sqrt_rn(self.dx ** 2 + sigma_r2)
        sourceSIGMAz = sqrt_rn(self.dz ** 2 + sigma_r2)
        s = torch.clamp(Theta0 * self.gamma / self.K, -1.0, 1.0)
        y = ((torch.arccos(s) / PI) + r['pole'].to(E.dtype) - 0.5) * 0.5 * \
            self.L0
        x = self.X0 * torch.sin(PI2 * y / self.L0) + sourceSIGMAx * r['x']
        z = sourceSIGMAz * r['z']
        return x, y, z

    def power_vs_K(self, K=None):
        """Total radiated power in W, P = 0.633 E^2 [GeV] B^2 [T] L [m]
        I [A], at K (this source's if None; a number or an array)."""
        Kv = self.K if K is None else np.asarray(K, float)
        B = K2B * Kv / self.L0
        length = self.L0 * self.Np * 1e-3  # m
        return 0.633 * (self.eE ** 2) * (B ** 2) * length * self.eI * 1e3
