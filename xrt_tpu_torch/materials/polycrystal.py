"""Polycrystalline and multi-reflex crystal materials.

Port of the reference package's ``materials/polycrystal.py``: ``Powder``
(randomly oriented crystallites), ``CrystalHarmonics`` (n [hkl], the
brightest wins) and ``MonoCrystal`` (every reflex of a crystal cut along
[hkl]).  The reflex table is made on the host at creation; each ray's
reflex is chosen in one streaming pass over chunks of 16 reflexes (a
Python loop that keeps the running best), each chunk one broadcast call
of the two-beam amplitude over (rays, reflexes).  A powder and a
monocrystal sample a reflex by its intensity with the Gumbel-max trick
(the largest log-intensity plus a Gumbel draw, which a running arg-max
composes with); the harmonics take the arg-max.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..physconsts import CH, PI2
from .crystal import CrystalFromCell, _over, two_beam_amplitude

_REFLEX_CHUNK = 16


def _d_spacing_table(a, b, c, alpha, beta, gamma, hkl_table):
    """Triclinic d-spacings of an (R, 3) integer reflex table, float64
    numpy."""
    ar, br, gr = map(math.radians, (alpha, beta, gamma))
    ca, cb, cg = math.cos(ar), math.cos(br), math.cos(gr)
    sa, sb, sg = math.sin(ar), math.sin(br), math.sin(gr)
    V = a * b * c * (1 - ca**2 - cb**2 - cg**2 + 2*ca*cb*cg) ** 0.5
    h = hkl_table[:, 0].astype(float)
    k = hkl_table[:, 1].astype(float)
    l = hkl_table[:, 2].astype(float)
    inv_d2 = ((h * sa / a) ** 2 + (k * sb / b) ** 2 + (l * sg / c) ** 2 +
              2 * h * k * (ca * cb - cg) / (a * b) +
              2 * h * l * (ca * cg - cb) / (a * c) +
              2 * k * l * (cb * cg - ca) / (b * c)) * (a * b * c / V) ** 2
    return 1.0 / np.sqrt(np.maximum(inv_d2, 1e-300))


def gumbel_draws(generator, shape, dtype, device):
    """Standard Gumbel draws -log(-log(u)), u uniform in (0, 1)."""
    g = generator if generator is not None else \
        torch.Generator(device).manual_seed(0)
    u = torch.rand(shape, generator=g, dtype=dtype,
                   device=g.device).to(device)
    u = torch.clamp(u, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


class _PolyCrystalMethods:
    """The structure factors over a chunk of reflexes and the streaming
    per-ray choice of a reflex."""

    # a powder's "surface" is the crystallite plane itself, so the
    # deflection normal flips together with the plane normal
    _flipSurfWithPlane = False
    # a ray samples its reflex by intensity (Gumbel draws), or takes the
    # brightest
    _samples = True

    def reflex_tables(self):
        """(hkl (R, 3) int, d (R,) float) numpy tables."""
        raise NotImplementedError

    def _chi_batch(self, E, hkl_chunk, d_chunk):
        """chi0 (N, 1), chih and chih_ (N, r) for a chunk of reflexes, with
        the conjugation of ``get_F_chi``."""
        el_by_Z = {el.Z: el for el in self.elements}
        E = E[:, None]
        stol = _over(0.5, d_chunk)[None, :]
        cdt = config.cdtype(E.dtype)
        F0 = torch.zeros(E.shape, dtype=cdt, device=E.device)
        Fhkl = torch.zeros((E.shape[0], d_chunk.shape[0]), dtype=cdt,
                           device=E.device)
        Fhkl_ = torch.zeros_like(Fhkl)
        cache = {}
        for i, Z in enumerate(self.atoms_Z):
            if Z not in cache:
                el = el_by_Z[Z]
                cache[Z] = (el.get_f0(stol), el.get_f1f2(E))
            f0, anom = cache[Z]
            af = self.atomsFraction[i]
            F0 = F0 + af * (Z + anom) * self.factDW
            fact = af * (f0 + anom) * self.factDW
            phase = PI2 * (self.atomsXYZ[i] @ hkl_chunk.T)[None, :]
            expiHr = torch.complex(torch.cos(phase), torch.sin(phase))
            Fhkl = Fhkl + fact * expiHr
            Fhkl_ = Fhkl_ + fact / expiHr
        waveLength = _over(CH, E)
        chiToFlambdaSquare = self.chiToF * waveLength ** 2
        return (torch.conj(F0) * chiToFlambdaSquare,
                torch.conj(Fhkl) * chiToFlambdaSquare,
                torch.conj(Fhkl_) * chiToFlambdaSquare)

    def _plane_normals(self, hkl_chunk, nb):
        """The unit Bragg-plane normal of each (ray, reflex): the nominal
        *nb* for every reflex (a powder's crystallite, the harmonics of
        one reflex)."""
        shp = (nb[0].shape[0], hkl_chunk.shape[0])
        return tuple(v[:, None].expand(shp) for v in nb)

    def _select(self, g, score):
        """The score a ray maximizes over the reflexes: the log-intensity
        plus the Gumbel draws *g*."""
        return torch.log(torch.clamp(score, min=1e-300)) + g

    def reflect_multi_hkl(self, generator, E, abc, nb, ns, gumbel=None):
        """(a, b, c, curveS, curveP) of each ray's chosen reflex in one
        streaming pass over the reflex table.  *abc*: the incoming
        directions; *nb*: the nominal plane normal; *ns*: the surface
        normal (a powder's is its crystallite's).  *gumbel*, one (N, 16)
        tensor a chunk, replaces the draws from *generator*."""
        hkl_table, d_table = self.reflex_tables()
        R = hkl_table.shape[0]
        nchunks = (R + _REFLEX_CHUNK - 1) // _REFLEX_CHUNK
        pad = nchunks * _REFLEX_CHUNK - R
        hkl_p = np.concatenate(
            [hkl_table, np.zeros((pad, 3), hkl_table.dtype)])
        d_p = np.concatenate([d_table, np.ones(pad, d_table.dtype)])
        a, b, c = abc
        nsx, nsy, nsz = ns
        dt, dev = a.dtype, a.device
        sig = 1.0 if self.geom.startswith('Laue') else -1.0
        beamInDotSurf = a * nsx + b * nsy + c * nsz
        lam = _over(CH, E)
        orderLambda = (lam * 1e-7)[:, None]
        best = torch.full_like(a, -math.inf)
        bA, bB, bC = a, b, c
        bS = torch.zeros(a.shape, dtype=config.cdtype(dt), device=dev)
        bP = bS
        for ic in range(nchunks):
            sl = slice(ic * _REFLEX_CHUNK, (ic + 1) * _REFLEX_CHUNK)
            hklc = torch.as_tensor(hkl_p[sl], dtype=dt, device=dev)
            dc = torch.as_tensor(d_p[sl], dtype=dt, device=dev)
            chi0, chih, chih_ = self._chi_batch(E, hklc, dc)
            px, py, pz = self._plane_normals(hklc, nb)
            # flip so that the beam meets the planes from above
            pdot = a[:, None] * px + b[:, None] * py + c[:, None] * pz
            flip = torch.where(pdot > 0, -1.0, 1.0).to(dt)
            px, py, pz, pdot = px * flip, py * flip, pz * flip, pdot * flip
            if self._flipSurfWithPlane:
                nsxr, nsyr, nszr = px, py, pz
                bInS = pdot
            else:
                nsxr, nsyr, nszr = (v[:, None].expand(px.shape)
                                    for v in ns)
                bInS = beamInDotSurf[:, None].expand(px.shape)
            # the crystal's "grating" vector in the surface
            nDotNs = px * nsxr + py * nsyr + pz * nszr
            wHd = _over(1e7, dc)[None, :]
            gx = (px - nDotNs * nsxr) * wHd
            gy = (py - nDotNs * nsyr) * wHd
            gz = (pz - nDotNs * nszr) * wHd
            bInG = a[:, None] * gx + b[:, None] * gy + c[:, None] * gz
            G2 = gx * gx + gy * gy + gz * gz
            u = bInS * bInS - 2 * bInG * orderLambda - \
                G2 * (orderLambda * orderLambda)
            dn = bInS + sig * sqrt_rn(torch.abs(u))
            aO = a[:, None] - nsxr * dn + gx * orderLambda
            bO = b[:, None] - nsyr * dn + gy * orderLambda
            cO = c[:, None] - nszr * dn + gz * orderLambda
            norm = sqrt_rn(aO * aO + bO * bO + cO * cO)
            aO, bO, cO = aO / norm, bO / norm, cO / norm
            bOutDotSurf = aO * nsxr + bO * nsyr + cO * nszr
            sinThB = torch.clamp(lam[:, None] / (2 * dc[None, :]),
                                 -1 + 1e-16, 1 - 1e-16)
            curveS, curveP = two_beam_amplitude(
                E[:, None], bInS, bOutDotSurf, pdot, dc[None, :], chi0,
                chih, chih_, torch.arcsin(sinThB), self.t, self.geom)
            curveS = torch.where(torch.isnan(torch.abs(curveS)), 0.0,
                                 curveS)
            curveP = torch.where(torch.isnan(torch.abs(curveP)), 0.0,
                                 curveP)
            intensity = torch.abs(curveS) ** 2 + torch.abs(curveP) ** 2
            g = None
            if self._samples:
                g = gumbel[ic] if gumbel is not None else gumbel_draws(
                    generator, intensity.shape, dt, dev)
            score = self._select(g, intensity)
            if pad and ic == nchunks - 1:
                valid = torch.arange(_REFLEX_CHUNK, device=dev) < \
                    _REFLEX_CHUNK - pad
                score = torch.where(valid[None, :], score, -math.inf)
            cbest = torch.argmax(score, dim=1, keepdim=True)

            def take(v):
                return torch.gather(v, 1, cbest)[:, 0]
            csc = take(score)
            upd = csc > best
            best = torch.where(upd, csc, best)
            bA = torch.where(upd, take(aO), bA)
            bB = torch.where(upd, take(bO), bB)
            bC = torch.where(upd, take(cO), bC)
            bS = torch.where(upd, take(curveS), bS)
            bP = torch.where(upd, take(curveP), bP)
        return bA, bB, bC, bS, bP


class Powder(_PolyCrystalMethods, CrystalFromCell):
    """Randomly oriented crystallites.  *hkl* bounds the reflexes: every
    [mnp] with 0 <= m <= h, 0 <= n <= k, 0 <= p <= l but [000]; *chi*
    limits the crystallites' azimuths; *t* (mm) is the powder layer, through
    which the interaction point is drawn."""

    _flipSurfWithPlane = True

    def __init__(self, *args, chi=(0.0, 0.5 * math.pi), **kwargs):
        super().__init__(*args, **kwargs)
        self.chi = chi

    @classmethod
    def create(cls, chi=(0.0, 0.5 * math.pi), **kwargs):
        mat = super(Powder, cls).create(**kwargs)
        mat.kind = 'powder'
        mat.chi = tuple(float(v) for v in chi)
        return mat

    def reflex_tables(self):
        h, k, l = self.hkl
        m, n, p = np.meshgrid(np.arange(h + 1), np.arange(k + 1),
                              np.arange(l + 1), indexing='ij')
        tab = np.stack([m.ravel(), n.ravel(), p.ravel()], axis=1)
        tab = tab[np.abs(tab).sum(1) > 0].astype(np.int32)
        return tab, _d_spacing_table(self.a, self.b_, self.c, self.alpha,
                                     self.beta, self.gamma, tab)

    def random_orientation(self, generator, nrays, dtype, device,
                           draws=None):
        """Crystallite normals: cos(theta) uniform in [0, 1), the azimuth
        uniform in the *chi* window.  *draws*, a pair of uniforms in
        [0, 1), replaces the draws from *generator*."""
        if draws is None:
            g = generator if generator is not None else \
                torch.Generator(device).manual_seed(0)
            draws = [torch.rand(nrays, generator=g, dtype=dtype,
                                device=g.device).to(device)
                     for _ in range(2)]
        cosY = draws[0]
        sinY = sqrt_rn(1.0 - cosY * cosY)
        zAng = self.chi[0] + (self.chi[1] - self.chi[0]) * draws[1]
        return sinY * torch.cos(zAng), sinY * torch.sin(zAng), cosY


class CrystalHarmonics(_PolyCrystalMethods, CrystalFromCell):
    """n [hkl] for n = 1..Nmax; the brightest harmonic wins."""

    _samples = False

    def __init__(self, *args, Nmax=3, **kwargs):
        super().__init__(*args, **kwargs)
        self.Nmax = Nmax

    @classmethod
    def create(cls, Nmax=3, **kwargs):
        mat = super(CrystalHarmonics, cls).create(**kwargs)
        mat.kind = 'crystal harmonics'
        mat.Nmax = int(Nmax)
        return mat

    def reflex_tables(self):
        base = np.asarray(self.hkl, np.int32)
        tab = np.stack([n * base for n in range(1, self.Nmax + 1)])
        return tab, _d_spacing_table(self.a, self.b_, self.c, self.alpha,
                                     self.beta, self.gamma, tab)

    def _select(self, g, score):
        return score


class MonoCrystal(_PolyCrystalMethods, CrystalFromCell):
    """A single crystal's diffraction pattern: every reflex of
    [-Nmax..Nmax]^3 of a crystal cut along *hkl*, one sampled a ray by
    intensity."""

    def __init__(self, *args, Nmax=3, **kwargs):
        super().__init__(*args, **kwargs)
        self.Nmax = Nmax

    @classmethod
    def create(cls, Nmax=3, **kwargs):
        mat = super(MonoCrystal, cls).create(**kwargs)
        mat.kind = 'monocrystal'
        mat.Nmax = int(Nmax)
        return mat

    def reflex_tables(self):
        n = self.Nmax
        rng = np.arange(-n, n + 1)
        m, k, p = np.meshgrid(rng, rng, rng, indexing='ij')
        tab = np.stack([m.ravel(), k.ravel(), p.ravel()], axis=1)
        tab = tab[np.abs(tab).sum(1) > 0].astype(np.int32)
        return tab, _d_spacing_table(self.a, self.b_, self.c, self.alpha,
                                     self.beta, self.gamma, tab)

    def _plane_normals(self, hkl_chunk, nb):
        """Each reflex direction turned by the rotation that takes the cut
        normal [hkl] onto the local plane normal (Rodrigues; cubic
        symmetry, so reciprocal directions are real directions)."""
        nbx, nby, nbz = nb
        cut = np.asarray(self.hkl, float)
        ux, uy, uz = (float(v) for v in cut / np.linalg.norm(cut))
        # axis = cut x n, angle = acos(cut . n), a ray each
        kx = uy * nbz - uz * nby
        ky = uz * nbx - ux * nbz
        kz = ux * nby - uy * nbx
        kn = sqrt_rn(kx * kx + ky * ky + kz * kz)
        degenerate = kn < 1e-12
        kn_s = torch.where(degenerate, torch.ones_like(kn), kn)
        kx, ky, kz = kx / kn_s, ky / kn_s, kz / kn_s
        cosA = torch.clamp(ux * nbx + uy * nby + uz * nbz, -1.0, 1.0)
        sinA = kn
        hn = sqrt_rn(torch.sum(hkl_chunk * hkl_chunk, dim=1))
        hn = torch.where(hn == 0, torch.ones_like(hn), hn)
        e = hkl_chunk / hn[:, None]
        ex, ey, ez = e[:, 0][None, :], e[:, 1][None, :], e[:, 2][None, :]
        kxc, kyc, kzc = kx[:, None], ky[:, None], kz[:, None]
        cA, sA = cosA[:, None], sinA[:, None]
        kDotE = kxc * ex + kyc * ey + kzc * ez
        crx = kyc * ez - kzc * ey
        cry = kzc * ex - kxc * ez
        crz = kxc * ey - kyc * ex
        px = ex * cA + crx * sA + kxc * kDotE * (1 - cA)
        py = ey * cA + cry * sA + kyc * kDotE * (1 - cA)
        pz = ez * cA + crz * sA + kzc * kDotE * (1 - cA)
        deg = degenerate[:, None]
        sgn = torch.sign(cosA)[:, None]     # an anti-parallel cut: mirror
        return (torch.where(deg, ex * sgn, px),
                torch.where(deg, ey * sgn, py),
                torch.where(deg, ez * sgn, pz))
