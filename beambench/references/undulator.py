"""The plain reference of the undulator characterisation (xrt speed test 2),
in float64 PyTorch.

It imports nothing of the program under test.  From the configuration file
and one pass's random draws it works out, for every candidate (E, theta,
psi): the far-field radiation integral of a planar undulator over one
period by its own Gauss-Legendre quadrature, the periodic factor
sin(pi Np w) / sin(pi w) of the Np periods and the flux per eV; then the
resampling of ``nrays`` rays by the pass's ``choice`` uniforms (the inverse
of the intensities' cumulative sum), the rays' origins from the
Tanaka-Kitamura source sizes, their directions with the e-beam's angular
spread, the straight line to the screen and a plain histogram.  The
formulas follow xrt's far-field branch of ``Undulator._build_I_map``
(``raycing/sources.py``) and ``_sample_positions`` / ``get_SIGMA``.

Departures from xrt, each the program's own (the reference checks the
program's method, not xrt's sampling):

* xrt draws its rays by rejection under the intensity's maximum, found on
  an ``eN`` x ``nx`` x ``nz`` mesh (1000 x 40 x 20 in the speed test); here
  ``nrays * oversample`` uniform candidates are resampled in proportion to
  their intensity, as the program does, with the program's uniforms;
* the quadrature is Gauss-Legendre (:data:`GL_INTERVALS` x
  :data:`GL_NODES` over the period), converged far below float32, where
  xrt and the program use Clenshaw-Curtis nodes;
* no energy spread: the source sizes are Tanaka and Kitamura's at zero
  spread, and the Lorentz factor is the beam's own;
* the rays go straight from the source to the screen at ``screen_y``
  (the program's ``Screen.expose``), without the phases of the
  amplitudes, which the plot (``fluxKind`` 's') does not read.

What it takes from a run, and only to judge it: the checked pass's draws,
the program's source beam (energies, directions, Jss, Jpp, Jsp, the
accepted flux), its screen beam and the plot's totals before and after
the pass.

``compare(..., lowered=True)`` is the control: the same reference with the
radiation integral evaluated in bfloat16 (the precision below the
configuration's float32), put in the program's place.
"""
import math

import numpy as np
import torch

PI = math.pi
HPLANCK = 6.626069573e-27       # erg s
C = 2.99792458e10               # cm/s
EV2ERG = 1.602176565e-12
M0 = 9.109383701528e-28         # g
SIE0 = 1.602176565e-19          # C
FINE_STR = 1 / 137.03599976
E2WC = 5067.7309392068091       # omega / c in 1/mm per eV
CHEVCM = HPLANCK * C / EV2ERG   # eV cm

#: Gauss-Legendre quadrature of the radiation integral: intervals over the
#: period and nodes in each (the integrand turns through ~40 rad at the
#: acceptance's corner; this is converged to ~1e-14)
GL_INTERVALS, GL_NODES = 8, 48
#: a ray is the reference's candidate when its energy (eV) and its angles
#: theta, psi (rad) are within these of the candidate's: float32 rounds
#: them to ~5e-4 eV and ~1e-10 rad, and another candidate comes this close
#: in all three with a chance of ~1e-12 a ray
MATCH_E, MATCH_ANGLE = 1e-2, 1e-7


def source(cfg):
    """The source's derived constants, Python floats: the Lorentz factor,
    wu, the acceptance window (widened by the e-beam divergence, as xrt
    does), the e-beam sizes (mm) and divergences (rad)."""
    u = cfg['undulator']
    gamma = u['eE'] * 1e9 * EV2ERG / (M0 * C ** 2)
    g2 = gamma * gamma
    K, L0 = float(u['K']), float(u['period'])
    dx, dz = u['eSigmaX'] * 1e-3, u['eSigmaZ'] * 1e-3
    dxp = u['eEpsilonX'] * 1e-6 / dx
    dzp = u['eEpsilonZ'] * 1e-6 / dz
    acc = cfg['accept_xz'] / cfg['screen_y']
    return dict(
        gamma=gamma, K=K, L0=L0, Np=int(u['n']), eI=float(u['eI']),
        wu=PI / L0 / g2 * (2 * g2 - 1 - 0.5 * K * K) / E2WC,
        eMin=cfg['E0'] - cfg['dE'], eMax=cfg['E0'] + cfg['dE'],
        theta=(-acc - dxp, acc + dxp), psi=(-acc - dzp, acc + dzp),
        dx=dx, dz=dz, dxprime=dxp, dzprime=dzp)


def candidates(s, draws):
    """(E, theta, psi) of the candidates, float64, from the uniforms."""
    def uniform(v, lo, hi):
        return torch.clamp(v.double() * (hi - lo) + lo, min=lo)
    return (uniform(draws['E'], s['eMin'], s['eMax']),
            uniform(draws['theta'], *s['theta']),
            uniform(draws['psi'], *s['psi']))


def integrals(s, E, th, ps, ww1, dtype=torch.float64, block=65536):
    """The radiation integral over one period, (Js, Jp) as complex128, for
    each (E, theta, psi) of harmonic number *ww1*, every per-node
    operation in *dtype*; in blocks of *block* candidates."""
    parts = [_integral_block(s, *(v[j:j + block] for v in (E, th, ps, ww1)),
                             dtype)
             for j in range(0, E.shape[0], block)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _integral_block(s, E, th, ps, ww1, dtype):
    dev = E.device
    K, wu, rg = s['K'], s['wu'], 1 / s['gamma']
    t, wt = np.polynomial.legendre.leggauss(GL_NODES)
    edges = np.linspace(-PI, PI, GL_INTERVALS + 1)
    half = 0.5 * (edges[1:] - edges[:-1])
    zn = (edges[:-1] + edges[1:])[:, None] * 0.5 + half[:, None] * t
    zw = half[:, None] * wt + 0 * zn

    def col(v):
        return v.to(dtype)[:, None]

    def row(v):
        return torch.as_tensor(v.ravel(), dtype=dtype, device=dev)[None]
    zn, zw = row(zn), row(zw)
    x, y = col(th), col(ps)
    w1, wwu = col(ww1), col(E / wu)
    sx, cx, s2x = torch.sin(zn), torch.cos(zn), torch.sin(2 * zn)
    A1m = 0.5 * (x * x + y * y)
    dirz = 1 - A1m
    phase = w1 * zn + wwu * rg * (-K * x * sx + 0.125 * rg * K * K * s2x)
    betax = K * rg * cx
    B1m = 0.5 * (rg * rg + betax * betax)
    bPx, bPz = -K * sx, 0.5 * rg * K * K * s2x
    one_minus_nb = 0.5 * (rg * rg + (x - betax) ** 2 + y * y) - A1m * B1m
    bnx, bny, bnz = x - betax, y, B1m - A1m
    dot_bP = x * bPx + dirz * bPz
    dot_dmb = x * bnx + y * bny + dirz * bnz
    f = zw / (one_minus_nb * one_minus_nb)
    fs = f * (bnx * dot_bP - bPx * dot_dmb)
    fp = f * (bny * dot_bP)
    cph, sph = torch.cos(phase), torch.sin(phase)

    def integral(v):
        return torch.complex(torch.sum(v * cph, dim=1).double(),
                             torch.sum(v * sph, dim=1).double())
    return integral(fs), integral(fp)


def amplitudes(s, E, th, ps, dtype=torch.float64):
    """(intensity per eV, As, Ap) of each candidate: the flux
    Amp2Flux ab^2 (wu / gamma)^2 (|Js|^2 + |Jp|^2) and the amplitudes whose
    squares add to it."""
    g2 = s['gamma'] ** 2
    K, wu = s['K'], s['wu']
    ww1 = E * ((1 + 0.5 * K * K) + g2 * (th * th + ps * ps)) / (2 * g2 * wu)
    sinw = torch.sin(PI * ww1)
    ab = torch.sin(PI * s['Np'] * ww1) / sinw / (2 * PI * wu)
    Js, Jp = integrals(s, E, th, ps, ww1, dtype)
    amp = torch.sqrt(FINE_STR / E * s['eI'] / SIE0) * ab * wu / s['gamma']
    As, Ap = Js * amp, Jp * amp
    return torch.abs(As) ** 2 + torch.abs(Ap) ** 2, As, Ap


def shine(cfg, draws, dtype=torch.float64):
    """The resampled rays of one pass from its *draws*: the candidates'
    index 'idx' (the resampling in float64), E, the rays' angles theta,
    psi (the candidate's with the e-beam's divergence), Jss, Jpp, |Jsp|,
    the origins x, z, the directions a, b, c, the screen positions sx, sz
    and the accepted flux 'accepted'.  The radiation integral and the
    rays' arithmetic from the chosen candidates on run in *dtype*; every
    value is returned in float64."""
    s = source(cfg)
    E, th, ps = candidates(s, draws)
    M, n = E.shape[0], draws['choice'].shape[0]
    I, As, Ap = amplitudes(s, E, th, ps, dtype)
    p = I / torch.sum(I)
    cum = torch.cumsum(p, dim=0)
    idx = torch.searchsorted(cum, cum[-1] * (1 - draws['choice'].double()))
    idx = torch.clamp(idx, max=M - 1)
    As, Ap = As[idx], Ap[idx]
    iS, iP = torch.abs(As) ** 2, torch.abs(Ap) ** 2
    tot = iS + iP
    E, th, ps = (v[idx].to(dtype) for v in (E, th, ps))
    r = {k: draws[k].to(dtype) for k in ('x', 'z', 'dtheta', 'dpsi')}
    # Tanaka & Kitamura's source sizes at zero energy spread
    sr2 = 2 * CHEVCM / E * 10 * s['L0'] * s['Np'] / (2 * PI) ** 2
    x = torch.sqrt(s['dx'] ** 2 + sr2) * r['x']
    z = torch.sqrt(s['dz'] ** 2 + sr2) * r['z']
    # the rays' angles: the candidate's and the e-beam's divergence
    th = th + s['dxprime'] * r['dtheta']
    ps = ps + s['dzprime'] * r['dpsi']
    a, c = torch.tan(th), torch.tan(ps)
    norm = torch.sqrt(a * a + 1 + c * c)
    xz = (s['eMax'] - s['eMin']) * (s['theta'][1] - s['theta'][0]) * \
        (s['psi'][1] - s['psi'][0])
    D = cfg['screen_y']
    rays = dict(E=E, theta=th, psi=ps, x=x, z=z, a=a / norm, b=1 / norm,
                c=c / norm, sx=x + a * D, sz=z + c * D)
    return dict({k: v.double() for k, v in rays.items()}, idx=idx,
                Jss=iS / tot, Jpp=iP / tot,
                Jsp=torch.abs(As * torch.conj(Ap)) / tot,
                accepted=float(torch.sum(I)) / M * xz * n)


def _bin(v, lim, bins):
    """xrt's bin of each value: floor((v - lo) / span * bins) in the
    values' own precision, -1 outside."""
    lo = torch.tensor(lim[0], dtype=v.dtype, device=v.device)
    span = torch.tensor(lim[1] - lim[0], dtype=v.dtype, device=v.device)
    nb = torch.tensor(float(bins), dtype=v.dtype, device=v.device)
    i = torch.floor((v - lo) / span * nb)
    return torch.where((i >= 0) & (i < bins), i, -1).long()


def histograms(x, z, E, w, bins, limits):
    """{'total2D': (z bins, x bins), 'c': energy bins} of one pass, float64
    sums of the weights *w*; rays outside an axis left out."""
    xl, zl, cl = limits
    ix, iz = _bin(x, xl, bins[0]), _bin(z, zl, bins[1])
    ok = (ix >= 0) & (iz >= 0)
    h2 = torch.zeros(bins[0] * bins[1], dtype=torch.float64,
                     device=x.device).index_add_(
        0, iz[ok] * bins[0] + ix[ok], w[ok]).reshape(bins[1], bins[0])
    ic = _bin(E, cl, bins[2])
    ok = ic >= 0
    hc = torch.zeros(bins[2], dtype=torch.float64,
                     device=x.device).index_add_(0, ic[ok], w[ok])
    return {'total2D': h2, 'c': hc}


def _rms(a, b):
    return float(torch.sqrt(torch.mean((a.double() - b) ** 2))) \
        if a.numel() else 0.0


def compare(cfg, kept, lowered=False):
    """The numbers that decide ``correct``, on the checked pass:

    * 'flux_err': the relative difference of the pass's accepted flux (the
      sum of its candidates' intensities);
    * 'index_off': the share of rays whose candidate is not the
      reference's (energy and angles not within :data:`MATCH_E`,
      :data:`MATCH_ANGLE` of it);
    * 'pol_err': the largest RMS difference of Jss, Jpp and |Jsp| over the
      rays whose candidate agrees;
    * 'ray_err': the largest difference of a screen x or z over those
      rays, relative to the plot's half-width;
    * 'hist_err': the largest relative L1 difference of the plot's 2D and
      energy totals of the pass from the reference's histograms of the
      same screen rays."""
    names = ('flux_err', 'index_off', 'pol_err', 'ray_err', 'hist_err')
    if not kept or 'after' not in kept:
        return {k: float('inf') for k in names}
    draws = kept['draws']
    ref = shine(cfg, draws)
    pl = cfg['plot']
    half = pl['half']
    bins = (pl['bins'], pl['bins'], pl['c_bins'])
    if lowered:
        low = shine(cfg, draws, torch.bfloat16)
        same = low['idx'] == ref['idx']
        prog = {k: low[k] for k in ('Jss', 'Jpp', 'Jsp', 'sx', 'sz')}
        accepted = low['accepted']
        # the control's plot: its rays binned in bfloat16
        b16 = [low[k].to(torch.bfloat16) for k in ('sx', 'sz', 'E')]
        w = low['Jss']
        got = histograms(*b16, w, bins, kept['limits'])
        want = histograms(low['sx'], low['sz'], low['E'], w, bins,
                          kept['limits'])
        got = {k: v.cpu().numpy() for k, v in got.items()}
    else:
        src, scr = kept['source'], kept['screen']
        th = torch.atan2(src['a'].double(), src['b'].double())
        ps = torch.atan2(src['c'].double(), src['b'].double())
        same = (torch.abs(src['E'].double() - ref['E']) <= MATCH_E) & \
            (torch.abs(th - ref['theta']) <= MATCH_ANGLE) & \
            (torch.abs(ps - ref['psi']) <= MATCH_ANGLE)
        prog = dict(Jss=src['Jss'], Jpp=src['Jpp'],
                    Jsp=torch.abs(src['Jsp']), sx=scr['x'], sz=scr['z'])
        accepted = float(src['accepted'])
        good = scr['state'] == 1
        w = scr['Jss'].double() * good
        want = histograms(scr['x'], scr['z'], scr['E'], w, bins,
                          kept['limits'])
        got = {k: kept['after'][k] - kept['before'][k] for k in want}
    out = dict(flux_err=abs(accepted - ref['accepted']) / ref['accepted'],
               index_off=1.0 - float(same.double().mean()))
    out['pol_err'] = max(_rms(prog[k][same], ref[k][same])
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

