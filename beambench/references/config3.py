"""The plain reference of BASELINE configuration 3 in the near field, in
float64 PyTorch.

It imports nothing of the program under test.  From the configuration file
and one pass's random draws it works out, for every candidate (E, theta,
psi): the radiation integral of a planar undulator observed at the
distance R0 (xrt's near field: the integral runs over all Np periods, each
node with its own direction to the observation point), the flux per eV;
then the resampling of ``nrays`` rays by the pass's ``choice`` uniforms,
the rays' origins from the Tanaka-Kitamura source sizes and their
directions with the e-beam's angular spread (the helpers of
``references/undulator.py``'s far-field pass, which this source shares);
then the double-crystal monochromator: the two flat Si(111) crystals as
two parallel planes, each ray's intersection, specular reflection and the
Belyakov-Dmitrienko two-beam amplitudes of a thick Bragg crystal on each;
then the straight line to the screen and a plain histogram.

The formulas follow xrt: the near-field branch of
``Undulator._build_I_map`` (``raycing/sources/synchr.py``, the
``undulator_nf`` kernel; the phase in three wrapped pieces), ``DCM`` and
``Crystal.get_amplitude`` (``raycing/oes.py``, ``raycing/materials.py``).

Departures from xrt, each the program's own (the reference checks the
program's method, not xrt's sampling):

* xrt draws its rays by rejection under the intensity's maximum; here
  ``nrays * oversample`` uniform candidates are resampled in proportion to
  their intensity, as the program does, with the program's uniforms;
* the quadrature is Gauss-Legendre (:data:`GL_INTERVALS` x
  :data:`GL_NODES` over each period), converged to float64's rounding,
  where xrt and the program use the pinned Clenshaw-Curtis nodes (their
  own error, ~1.5e-11 of the flux, is what the float64 program reads);
* the per-ray carrier phase exp(i w / wu R0) (~1e12 rad, whose float64
  ulp is ~1e-4 rad) multiplies each ray's sum once, where xrt turns every
  node by it; no compared value reads a ray's common phase;
* no energy spread (BASELINE gives none);
* the DCM's crystals are planes of infinite extent inside their physical
  limits, the second one h = fixedOffset / (2 cos theta) above the first
  along its normal; the Bragg angle is xrt's alignment at ``alignE`` (the
  Bragg angle less the refraction correction, f1 and f2 interpolated in
  float32 as a scalar energy takes them); Si's f1, f2 are a frozen copy
  of the three rows of Chantler's table around 9 keV, f0 Waasmaier and
  Kirfel's;
* the amplitudes' phases along the path, which the plot (``fluxKind``
  'total') does not read, are left out.

What it takes from a run, and only to judge it: the checked pass's draws,
the program's source beam (energies, directions, Jss, Jpp, Jsp, the
accepted flux), its beam after the DCM (Jss, Jpp, Jsp, state), its screen
beam and the plot's totals before and after the pass.

``compare(..., lowered=True)`` is the control: the same reference in
float32 (the precision below the configuration's float64) from the
radiation integral to the screen, put in the program's place.
"""
import math

import numpy as np
import torch

import harness

UND = harness.load_module('references', 'undulator')
ANA = harness.load_module('references', 'analyzer')

PI = math.pi
E2WC, EV2ERG, M0, C = UND.E2WC, UND.EV2ERG, UND.M0, UND.C
FINE_STR, SIE0, CHEVCM = UND.FINE_STR, UND.SIE0, UND.CHEVCM
CH = CHEVCM * 1e8               # eV A
R0_A = ANA.R0_A
#: Gauss-Legendre quadrature of the radiation integral: intervals in each
#: period and nodes in each interval (the integrand turns through ~45 rad a
#: period at the 7th harmonic; each intensity is within ~6e-13 of 8 x 128
#: nodes', the floor of float64's rounding over 111 periods; 2 x 64 nodes
#: are ~5e-12 off)
GL_INTERVALS, GL_NODES = 2, 128
#: Si, 'Chantler total': (E [eV], f1, f2) at the rows around 9 keV, as the
#: raw table stores them (float32)
SI_F1F2 = ((8447.890625, 0.25370025634765625, 0.30537328124046326),
           (9030.7939453125, 0.23729991912841797, 0.26890042424201965),
           (9653.9189453125, 0.2193002700805664, 0.23543143272399902))
SI_Z = 14
#: Si's lattice constant at 19.9 C, A, and its thermal expansion (Swenson's
#: parameterization between 293 and 1000 K)
SI_A0 = 5.430710
SI_DL = (-1.161022e-012, 3.311476e-009, 1.124129e-006, -5.844535e-004)
#: the crystals' temperature, K (xrt's default)
SI_TK = 297.15


def _over(c, t):
    """The number *c* over the tensor *t*, one correctly rounded division
    (PyTorch takes a number over a tensor as a reciprocal times it)."""
    return torch.full_like(t, c) / t


def source(cfg):
    """The source's derived constants, Python floats: the Lorentz factor,
    K (xrt's auto-K from ``targetE``), wu, the acceptance window (widened
    by the e-beam divergence, after R0 forced the auto reduction), the
    e-beam sizes (mm) and divergences (rad) from the emittances and beta
    functions."""
    u = cfg['undulator']
    gamma = u['eE'] * 1e9 * EV2ERG / (M0 * C ** 2)
    g2 = gamma * gamma
    L0 = float(u['period'])
    E_t, h = u['targetE']
    K = math.sqrt(h * 8 * PI * g2 / L0 / E_t / E2WC - 2)
    dx = math.sqrt(u['eEpsilonX'] * 1e-6 * u['betaX'] * 1e3)
    dz = math.sqrt(u['eEpsilonZ'] * 1e-6 * u['betaZ'] * 1e3)
    dxp, dzp = u['eEpsilonX'] * 1e-6 / dx, u['eEpsilonZ'] * 1e-6 / dz
    xpm = min(u['xPrimeMax'] * 1e-3, K / gamma)
    zpm = min(u['zPrimeMax'] * 1e-3, 2.0 / gamma)
    return dict(
        gamma=gamma, K=K, L0=L0, Np=int(u['n']), eI=float(u['eI']),
        R0=float(u['R0']),
        wu=PI / L0 / g2 * (2 * g2 - 1 - 0.5 * K * K) / E2WC,
        eMin=float(u['eMin']), eMax=float(u['eMax']),
        theta=(-xpm - dxp, xpm + dxp), psi=(-zpm - dzp, zpm + dzp),
        dx=dx, dz=dz, dxprime=dxp, dzprime=dzp)


def _nodes(Np):
    """(positions z over the Np periods, weights, position within the
    period) of the composite Gauss-Legendre rule, float64 numpy."""
    t, wt = np.polynomial.legendre.leggauss(GL_NODES)
    edges = np.linspace(-PI, PI, GL_INTERVALS + 1)
    half = 0.5 * (edges[1:] - edges[:-1])
    tg = ((edges[:-1] + edges[1:])[:, None] * 0.5 + half[:, None] * t)
    wg = half[:, None] * wt + 0 * tg
    off = -(Np - 1) * PI + 2 * PI * np.arange(Np)
    return tg.ravel(), wg.ravel(), off


def integrals(s, E, th, ps, dtype=torch.float64, block=32768):
    """The near-field radiation integral over the Np periods, (Js, Jp) as
    complex128 (the integrals over z of xrt's integrand, with the carrier
    phase), for each (E, theta, psi), every per-node operation in *dtype*;
    in blocks of *block* candidates."""
    parts = [_near_block(s, *(v[j:j + block] for v in (E, th, ps)), dtype)
             for j in range(0, E.shape[0], block)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _near_block(s, E, th, ps, dtype):
    dev = E.device
    K, wu = s['K'], s['wu']
    tg, wg, offsets = _nodes(s['Np'])

    def col(v):
        return v.to(dtype)[:, None]

    def row(v):
        return torch.as_tensor(np.asarray(v).ravel(), dtype=dtype,
                               device=dev)[None]
    rg = 1.0 / s['gamma']
    omb = (1 + 0.5 * K * K) * 0.5 * rg * rg
    betam = 1 - omb
    R0n = s['R0'] * 2 * PI / s['L0']
    wwu = col(E / wu)
    R0x = col(torch.tan(th.double()) * R0n)
    R0y = col(torch.tan(ps.double()) * R0n)
    # the node's own terms (the trajectory within its period)
    sx, cx = np.sin(tg), np.cos(tg)
    s2x = 2 * sx * cx
    zterm4 = row(0.25 * 0.5 * K * K * s2x * rg * rg)     # 0.25 zterm rg
    drx = R0x - row(K * sx * rg)
    dry = R0y + 0 * drx
    s2 = drx * drx + dry * dry
    betax = row(K * rg * cx)
    B1m = 0.5 * (rg * rg + betax * betax)
    betaPx = row(-K * sx)
    betaPz = row(0.5 * rg * K * K * s2x)
    w = row(wg)
    tg_ = row(tg)
    Bs = torch.zeros(E.shape[0], dtype=torch.complex128, device=dev)
    Bp = torch.zeros_like(Bs)
    for off in offsets:
        zloc = tg_ + off
        drz = R0n - (betam * zloc - zterm4)
        dist = torch.sqrt(s2 + drz * drz)
        drs = 0.5 * s2 / drz
        phase = wwu * zloc * omb + wwu * (drs + zterm4)
        t2 = s2 / (dist * (dist + drz))
        ndx, ndy, ndz = drx / dist, dry / dist, drz / dist
        one_minus_nb = B1m + (1 - B1m) * t2 - ndx * betax
        bnx, bny, bnz = ndx - betax, ndy, B1m - t2
        dot_bP = ndx * betaPx + ndz * betaPz
        dot_dmb = ndx * bnx + ndy * bny + ndz * bnz
        f = w / (one_minus_nb * one_minus_nb)
        fs = f * (bnx * dot_bP - betaPx * dot_dmb)
        fp = f * (bny * dot_bP)
        cph, sph = torch.cos(phase), torch.sin(phase)

        def integral(v):
            return torch.complex(torch.sum(v * cph, dim=1).double(),
                                 torch.sum(v * sph, dim=1).double())
        Bs = Bs + integral(fs)
        Bp = Bp + integral(fp)
    carrier = (E.double() / wu) * R0n
    turn = torch.complex(torch.cos(carrier), torch.sin(carrier))
    return Bs * turn, Bp * turn


def amplitudes(s, E, th, ps, dtype=torch.float64):
    """(intensity per eV, As, Ap) of each candidate: the flux
    Amp2Flux (wu / gamma / (2 pi wu))^2 (|Js|^2 + |Jp|^2) and the
    amplitudes whose squares add to it (no periodic factor: the integral
    runs over every period)."""
    wu = s['wu']
    Js, Jp = integrals(s, E, th, ps, dtype)
    amp = torch.sqrt(FINE_STR / E.double() * s['eI'] / SIE0) / \
        (2 * PI * wu) * wu / s['gamma']
    As, Ap = Js * amp, Jp * amp
    return torch.abs(As) ** 2 + torch.abs(Ap) ** 2, As, Ap


# ---------------------------------------------------------------------------
# the double-crystal monochromator
# ---------------------------------------------------------------------------

class SiCrystal:
    """Si(hkl) of the diamond lattice at :data:`SI_TK`, xrt's
    ``CrystalSi``."""

    def __init__(self, hkl):
        def dl(t):
            c3, c2, c1, c0 = SI_DL
            return c3 * t ** 3 + c2 * t ** 2 + c1 * t + c0
        a = SI_A0 * (dl(SI_TK) - dl(273.15 + 19.9) + 1)
        self.d = a / math.sqrt(sum(i * i for i in hkl))
        self.V = a ** 3
        s = sum(hkl)
        self.dj = complex(1 + math.cos(0.5 * PI * s), math.sin(0.5 * PI * s))
        c, aa, bb = ANA.SI_F0[5], ANA.SI_F0[0:5], ANA.SI_F0[6:11]
        q2 = (0.5 / self.d) ** 2
        self.f0 = c + sum(ai * math.exp(-bi * q2) for ai, bi in zip(aa, bb))

    @staticmethod
    def f1f2(E):
        """f1 + i f2 at energies *E*: the table's rows interpolated
        linearly in *E*'s dtype."""
        e, f1, f2 = (torch.tensor(v, dtype=E.dtype, device=E.device)
                     for v in zip(*SI_F1F2))
        i = torch.clamp(torch.searchsorted(e, E, right=True) - 1, 0,
                        e.shape[0] - 2)
        w = (E - e[i]) / (e[i + 1] - e[i])
        return torch.complex(f1[i] + w * (f1[i + 1] - f1[i]),
                             f2[i] + w * (f2[i + 1] - f2[i]))

    def chi(self, E):
        """(chi0, chih, chih_) at energies *E* (eV, tensor), complex of
        *E*'s precision."""
        f = self.f1f2(E)
        F0 = 4 * (SI_Z + f) * 2
        Fh = 4 * (self.f0 + f) * self.dj
        Fh_ = 4 * (self.f0 + f) * self.dj.conjugate()
        lam = _over(CH, E)
        k = -R0_A / PI / self.V * lam * lam
        return torch.conj(F0) * k, torch.conj(Fh) * k, torch.conj(Fh_) * k

    def bragg(self, E):
        """xrt's alignment of a symmetric Bragg crystal at the energy *E*
        (a number): the Bragg angle less the refraction correction, f1 and
        f2 interpolated in float32 (a scalar energy takes the table's
        type)."""
        thB = math.asin(CH / (2 * self.d * E))
        f = self.f1f2(torch.tensor([E], dtype=torch.float32))
        F0 = complex((4 * (SI_Z + f))[0]) * 2
        chi0 = F0 * (-R0_A / PI / self.V) * (CH / E) ** 2
        symm = (chi0 / math.sin(2 * thB)).real
        g0 = math.sin(thB)
        osq = math.sqrt(1 - g0 * g0)
        dtheta0 = (-g0 + math.sqrt(g0 * g0 - 2 * g0 * osq * symm)) / osq
        return thB + dtheta0

    def amplitude(self, E, inSN, outSN, inHN):
        """Thick Bragg two-beam amplitudes (s, p), with the |b|^-1/2 flux
        factor."""
        chi0, chih, chih_ = self.chi(E)
        lam = _over(CH, E)
        k = _over(2 * PI, lam)
        b = (-inSN * k) / (-outSN * k)
        HoverK = lam / self.d
        alpha = HoverK * (0.5 * HoverK - torch.abs(inHN)) + \
            chi0 / 2 * (1 / b - 1)
        thB = torch.asin(_over(CH, 2 * self.d * E))
        out = []
        for pol in (torch.ones_like(E), torch.cos(2 * thB)):
            delta = torch.sqrt(alpha * alpha + pol * pol * chih * chih_ / b)
            ra = chih * pol / (alpha + delta)
            rb = chih * pol / (alpha - delta)
            ra = torch.where(torch.isnan(torch.abs(ra)) |
                             (torch.abs(rb) < torch.abs(ra)), rb, ra)
            out.append(torch.nan_to_num(ra / torch.sqrt(torch.abs(b))))
        return out


def dcm(cfg, p, d, E):
    """The DCM of the configuration on the rays of energies *E* at *p*
    (x, y, z) going along *d* (a, b, c), global frame, in their dtype: (the
    point and direction after the second crystal, the amplitudes (rs1 rs2,
    rp1 rp2), the mask of the rays both crystals took)."""
    m = cfg['dcm']
    cr = SiCrystal(m['hkl'])
    th = cr.bragg(m['alignE'])
    n1 = (0.0, -math.sin(th), math.cos(th))
    ey = (0.0, math.cos(th), math.sin(th))
    c1 = (0.0, float(m['center_y']), 0.0)
    h = m['fixedOffset'] / 2.0 / math.cos(th)
    c2 = tuple(c + h * n for c, n in zip(c1, n1))

    def dot(u, v):
        return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

    def crystal(p, d, c, n):
        """The hit on the plane through *c* of normal *n*, the reflected
        direction, the incidence (d . n) and the physical limits' mask."""
        dn = dot(d, n)
        t = (dot(c, n) - dot(p, n)) / dn
        hit = tuple(pi + di * t for pi, di in zip(p, d))
        rel = tuple(hi - ci for hi, ci in zip(hit, c))
        lx, ly = m['limPhysX'], m['limPhysY']
        y = dot(rel, ey)
        inside = (rel[0] >= lx[0]) & (rel[0] <= lx[1]) & (y >= ly[0]) & \
            (y <= ly[1]) & (dn < 0)
        out = tuple(di - 2 * dn * ni for di, ni in zip(d, n))
        return hit, out, dn, inside
    p1, d1, in1, ok1 = crystal(p, d, c1, n1)
    p2, d2, in2, ok2 = crystal(p1, d1, c2, tuple(-v for v in n1))
    rs1, rp1 = cr.amplitude(E, in1, -in1, in1)
    rs2, rp2 = cr.amplitude(E, in2, -in2, in2)
    return p2, d2, (rs1 * rs2, rp1 * rp2), ok1 & ok2


def shine(cfg, draws, dtype=torch.float64):
    """The resampled rays of one pass from its *draws*, through the DCM to
    the screen: the candidates' index 'idx', E, the rays' angles theta,
    psi, the source's Jss, Jpp, |Jsp|, the DCM's 'dcm_Jss', 'dcm_Jpp',
    'dcm_Jsp' (|Jsp|) and 'good' (both crystals took the ray), the screen
    positions sx, sz and the accepted flux 'accepted'.  Everything from the
    radiation integral to the screen runs in *dtype* (the cumulative sum
    of the resampling too); every value is returned in float64."""
    s = source(cfg)
    E, th, ps = UND.candidates(s, draws)
    M, n = E.shape[0], draws['choice'].shape[0]
    I, As, Ap = amplitudes(s, E, th, ps, dtype)
    I_ = I.to(dtype)
    p = I_ / torch.sum(I_)
    cum = torch.cumsum(p, dim=0)
    idx = torch.searchsorted(cum, cum[-1] * (1 - draws['choice'].to(dtype)))
    idx = torch.clamp(idx, max=M - 1)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    As, Ap = As[idx].to(cdt), Ap[idx].to(cdt)
    iS, iP = torch.abs(As) ** 2, torch.abs(Ap) ** 2
    tot = iS + iP
    Jss, Jpp, Jsp = iS / tot, iP / tot, As * torch.conj(Ap) / tot
    E, th, ps = (v[idx].to(dtype) for v in (E, th, ps))
    r = {k: draws[k].to(dtype) for k in ('x', 'z', 'dtheta', 'dpsi')}
    # Tanaka & Kitamura's source sizes at zero energy spread
    sr2 = 2 * CHEVCM / E * 10 * s['L0'] * s['Np'] / (2 * PI) ** 2
    x = torch.sqrt(s['dx'] ** 2 + sr2) * r['x']
    z = torch.sqrt(s['dz'] ** 2 + sr2) * r['z']
    th = th + s['dxprime'] * r['dtheta']
    ps = ps + s['dzprime'] * r['dpsi']
    a, c = torch.tan(th), torch.tan(ps)
    norm = torch.sqrt(a * a + 1 + c * c)
    d = (a / norm, 1 / norm, c / norm)
    p2, d2, (rs, rp), good = dcm(cfg, (x, torch.zeros_like(x), z), d, E)
    # the screen: the plane y = screen y, its local z from its centre's
    scr = cfg['screen']
    path = (scr['y'] - p2[1]) / d2[1]
    xz = (s['eMax'] - s['eMin']) * (s['theta'][1] - s['theta'][0]) * \
        (s['psi'][1] - s['psi'][0])
    out = dict(E=E, theta=th, psi=ps, Jss=Jss, Jpp=Jpp, Jsp=torch.abs(Jsp),
               dcm_Jss=Jss * torch.abs(rs) ** 2,
               dcm_Jpp=Jpp * torch.abs(rp) ** 2,
               dcm_Jsp=torch.abs(Jsp * rs * torch.conj(rp)),
               sx=p2[0] + d2[0] * path, sz=p2[2] + d2[2] * path - scr['z'])
    return dict({k: v.double() for k, v in out.items()}, idx=idx, good=good,
                accepted=float(torch.sum(I)) / M * xz * n)


def histograms(x, z, E, w, bins, limits):
    """{'total2D': (z bins, x bins), 'c': energy bins} of one pass: the
    weights *w* binned by the values' own precision and summed in the
    weights' own precision; rays outside an axis left out."""
    xl, zl, cl = limits
    ix, iz = UND._bin(x, xl, bins[0]), UND._bin(z, zl, bins[1])
    ok = (ix >= 0) & (iz >= 0)
    h2 = torch.zeros(bins[0] * bins[1], dtype=w.dtype,
                     device=x.device).index_add_(
        0, iz[ok] * bins[0] + ix[ok], w[ok]).reshape(bins[1], bins[0])
    ic = UND._bin(E, cl, bins[2])
    ok = ic >= 0
    hc = torch.zeros(bins[2], dtype=w.dtype,
                     device=x.device).index_add_(0, ic[ok], w[ok])
    return {'total2D': h2.double(), 'c': hc.double()}


def _rms(a, b):
    return float(torch.sqrt(torch.mean((a.double() - b) ** 2))) \
        if a.numel() else 0.0


def compare(cfg, kept, lowered=False):
    """The numbers that decide ``correct``, on the checked pass:

    * 'flux_err': the relative difference of the pass's accepted flux (the
      sum of its candidates' intensities);
    * 'index_off': the share of rays whose candidate is not the
      reference's (energy and angles not within ``MATCH_E``,
      ``MATCH_ANGLE`` of ``references/undulator.py``);
    * 'pol_err': the largest RMS difference of the source's Jss, Jpp and
      |Jsp| over the rays whose candidate agrees;
    * 'dcm_err': the largest RMS difference of Jss, Jpp and |Jsp| after the
      DCM over those rays (0 where a ray is lost);
    * 'ray_err': the largest difference of a screen x or z over those
      rays, relative to the plot's half-width;
    * 'hist_err': the largest relative L1 difference of the plot's 2D and
      energy totals of the pass from the reference's histograms of the
      same screen rays (the control's: its rays binned and summed in
      float32 against float64)."""
    names = ('flux_err', 'index_off', 'pol_err', 'dcm_err', 'ray_err',
             'hist_err')
    # no product of the reference may run in TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not kept or 'after' not in kept:
        return {k: float('inf') for k in names}
    draws = kept['draws']
    ref = shine(cfg, draws)
    pl = cfg['plot']
    half = pl['half']
    bins = (pl['bins'], pl['bins'], pl['c_bins'])
    if lowered:
        low = shine(cfg, draws, torch.float32)
        same = low['idx'] == ref['idx']
        prog = {k: low[k] for k in ('Jss', 'Jpp', 'Jsp', 'sx', 'sz')}
        for k in ('Jss', 'Jpp', 'Jsp'):
            prog['dcm_' + k] = low['dcm_' + k] * low['good']
        accepted = low['accepted']
        w = ((low['dcm_Jss'] + low['dcm_Jpp']) * low['good']).float()
        # the control's plot: its rays binned and summed in float32
        f32 = [low[k].float() for k in ('sx', 'sz', 'E')]
        got = histograms(*f32, w, bins, kept['limits'])
        want = histograms(low['sx'], low['sz'], low['E'], w.double(), bins,
                          kept['limits'])
        got = {k: v.cpu().numpy() for k, v in got.items()}
    else:
        src, mono, scr = kept['source'], kept['dcm'], kept['screen']
        th = torch.atan2(src['a'].double(), src['b'].double())
        ps = torch.atan2(src['c'].double(), src['b'].double())
        same = (torch.abs(src['E'].double() - ref['E']) <= UND.MATCH_E) & \
            (torch.abs(th - ref['theta']) <= UND.MATCH_ANGLE) & \
            (torch.abs(ps - ref['psi']) <= UND.MATCH_ANGLE)
        took = mono['state'] == 1
        prog = dict(Jss=src['Jss'], Jpp=src['Jpp'],
                    Jsp=torch.abs(src['Jsp']), sx=scr['x'], sz=scr['z'],
                    dcm_Jss=mono['Jss'].double() * took,
                    dcm_Jpp=mono['Jpp'].double() * took,
                    dcm_Jsp=torch.abs(mono['Jsp']).double() * took)
        accepted = float(src['accepted'])
        good = scr['state'] == 1
        w = (scr['Jss'].double() + scr['Jpp'].double()) * good
        want = histograms(scr['x'], scr['z'], scr['E'], w, bins,
                          kept['limits'])
        got = {k: kept['after'][k] - kept['before'][k] for k in want}
    for k in ('Jss', 'Jpp', 'Jsp'):
        ref['dcm_' + k] = ref['dcm_' + k] * ref['good']
    out = dict(flux_err=abs(accepted - ref['accepted']) / ref['accepted'],
               index_off=1.0 - float(same.double().mean()))
    out['pol_err'] = max(_rms(prog[k][same], ref[k][same])
                         for k in ('Jss', 'Jpp', 'Jsp'))
    out['dcm_err'] = max(_rms(prog['dcm_' + k][same], ref['dcm_' + k][same])
                         for k in ('Jss', 'Jpp', 'Jsp'))
    out['ray_err'] = max(
        float(torch.max(torch.abs(prog[k][same].double() - ref[k][same])))
        if bool(same.any()) else 0.0 for k in ('sx', 'sz')) / half
    err = 0.0
    for k, h in want.items():
        ref_h = h.cpu().numpy()
        den = np.abs(ref_h).sum()
        e = np.abs(got[k] - ref_h).sum() / den if den > 0 else \
            (0.0 if np.abs(got[k]).sum() == 0 else float('inf'))
        err = max(err, float(e))
    out['hist_err'] = err
    return out
