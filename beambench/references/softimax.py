"""The plain reference of the SoftiMAX wave chain, in float64 PyTorch.

It imports nothing of the program under test.  From the configuration file
alone it works out the undulator's far-field amplitude (the radiation
integral over one period, by Gauss-Legendre quadrature, with the periodic
factor of the Np periods), each sender's surface normal (aperture, toroid,
flat mirror, blazed grating, elliptical cylinder) and the Kirchhoff double
sum of every step.  The formulas follow xrt's: the far-field branch of
``Undulator._build_I_map`` and ``_diffraction_integral`` of
``raycing/waves.py``.

What it takes from a run of the program, and only to judge it: the receiver
sample positions and, for each Kirchhoff step, the step's input beam (its
source points, directions, fields and states) and the raw sums it
returned.  So the reference follows the chain step by step from the
program's own state: each step's sums are recomputed from that step's
input, the source field from the sample positions, and the focal images
from M5's beam; the reflections and rescaling between steps are not
recomputed (see PERF.md).

``compare(..., lowered=True)`` is the control: the same reference in
float32 with plain float32 phases (the step below the configuration's
double-float phases) put in the program's place.
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
CH = HPLANCK * C / EV2ERG * 1e8  # eV A
CHBAR = CH / (2 * PI)

#: Gauss-Legendre quadrature of the radiation integral: intervals of one
#: period and nodes in each (converged far below float32's resolution)
GL_INTERVALS, GL_NODES = 8, 96


def undulator_field(cfg, x, y, z, area, block=8192):
    """(Es, Ep) of one zero-emittance filament at points (x, y, z) of the
    source frame (mm), with the 1/r and sqrt(area) factors and the
    spherical phase k r, in the points' dtype; in blocks of *block*
    points."""
    parts = [_undulator_block(cfg, x[j:j + block], y[j:j + block],
                              z[j:j + block], area)
             for j in range(0, x.shape[0], block)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _undulator_block(cfg, x, y, z, area):
    u = cfg['undulator']
    dt, dev = x.dtype, x.device
    cdt = torch.complex128 if dt == torch.float64 else torch.complex64
    E = float(cfg['E0'])
    gamma = u['eE'] * 1e9 * EV2ERG / (M0 * C ** 2)
    g2 = gamma ** 2
    L0, Np, h = float(u['period']), int(u['n']), int(u['harmonic'])
    Ky = math.sqrt(h * 8 * PI * g2 / L0 / E / E2WC - 2)
    wu = PI / L0 / g2 * (2 * g2 - 1 - 0.5 * Ky ** 2) / E2WC
    r = torch.sqrt(x * x + y * y + z * z)
    th, ps = x / r, z / r
    ww1 = E * ((1 + 0.5 * Ky ** 2) + g2 * (th * th + ps * ps)) / \
        (2 * g2 * wu)
    ab = 1 / (2 * PI * wu) * torch.sin(PI * Np * ww1) / torch.sin(PI * ww1)
    # composite Gauss-Legendre nodes over one period [-pi, pi]
    t, wt = np.polynomial.legendre.leggauss(GL_NODES)
    edges = np.linspace(-PI, PI, GL_INTERVALS + 1)
    half = 0.5 * (edges[1:] - edges[:-1])
    zn = ((edges[:-1] + edges[1:])[:, None] * 0.5 + half[:, None] * t)
    zw = half[:, None] * wt + 0 * zn
    zn = torch.as_tensor(zn.ravel(), dtype=dt, device=dev)[None]
    zw = torch.as_tensor(zw.ravel(), dtype=dt, device=dev)[None]
    rg = 1 / gamma
    wwu = E / wu
    sx, cx, s2x = torch.sin(zn), torch.cos(zn), torch.sin(2 * zn)
    thc, psc = th[:, None], ps[:, None]
    A1m = 0.5 * (thc * thc + psc * psc)
    dz = 1 - A1m
    ucos = ww1[:, None] * zn + wwu * rg * (-Ky * thc * sx +
                                           0.125 * rg * Ky ** 2 * s2x)
    betax = Ky * rg * cx
    B1m = 0.5 * (rg * rg + betax * betax)
    betaPx = -Ky * sx
    betaPz = 0.5 * rg * Ky ** 2 * s2x
    one_minus_nb = 0.5 * (rg * rg + (thc - betax) ** 2 + psc * psc) - \
        A1m * B1m
    bnx, bny, bnz = thc - betax, psc, B1m - A1m
    dirDotBetaP = thc * betaPx + dz * betaPz
    dirDotDmB = thc * bnx + psc * bny + dz * bnz
    f = torch.polar(zw / one_minus_nb ** 2, ucos)
    Is = torch.sum(f * (bnx * dirDotBetaP - betaPx * dirDotDmB), dim=1)
    Ip = torch.sum(f * (bny * dirDotBetaP), dim=1)
    sqA = math.sqrt(FINE_STR / E * u['eI'] / SIE0)
    amp = sqA * ab * wu * rg * math.sqrt(area) / r
    kr = (E / CHBAR * 1e7) * r
    ph = torch.polar(torch.ones_like(kr), kr).to(cdt)
    return (Is * amp).to(cdt) * ph, (Ip * amp).to(cdt) * ph


def _ellipse(p, q, pitch):
    a = abs(pitch)
    g = math.atan2((p - q) * math.sin(a), (p + q) * math.cos(a))
    return dict(A=(q + p) / 2, B=math.sqrt(q * p) * math.sin(a),
                y0=(q - p) / 2 * math.cos(a), z0=(q + p) / 2 * math.sin(a),
                cg=math.cos(g), sg=math.sin(g))


def senders(cfg):
    """{step: (kind, parameters)} of the element each Kirchhoff step
    integrates over, from the configuration."""
    pitch = math.radians(cfg['pitch_deg'])
    m1 = ('toroid', dict(R=1e22, r=2.0 * cfg['p_m1'] * math.sin(pitch)))
    m3 = ('toroid', dict(R=1e22, r=2.0 * math.sin(pitch) *
                         cfg['q_m3_sag']))
    grating = ('grating', dict(rho=cfg['rho_g'],
                               blaze=math.radians(cfg['blaze_deg']),
                               antiblaze=PI * 0.4999))
    m4 = ('ellipse', _ellipse(cfg['m4_p'], cfg['d_m45'] + cfg['p_exp'],
                              pitch))
    m5 = ('ellipse', _ellipse(cfg['d_m4_es'] + cfg['d_m45'], cfg['p_exp'],
                              pitch))
    return dict(m1=('aperture', {}), m2=m1, pg=('flat', {}), m3=grating,
                es=m3, m4=('aperture', {}), m5=m4, scr0=m5, scr1=m5,
                scr2=m5)


def normal(kind, prm, x, y, z):
    """The sender's local surface normal at its local points."""
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    if kind == 'aperture':
        return zero, one, zero
    if kind == 'flat':
        return zero, zero, one
    if kind == 'toroid':
        a = -x / prm['r'] / torch.sqrt(1 - (x / prm['r']) ** 2)
        b = -y / prm['R']
        nrm = torch.sqrt(a * a + b * b + 1)
        return a / nrm, b / nrm, 1 / nrm
    if kind == 'grating':
        period = 1.0 / prm['rho']
        tanB, tanA = math.tan(prm['blaze']), math.tan(prm['antiblaze'])
        yL = y - torch.floor(y / period) * period
        on_blaze = yL > period / (1 + tanA / tanB)
        b = torch.where(on_blaze, -math.sin(prm['blaze']) * one,
                        math.sin(prm['antiblaze']) * one)
        c = torch.where(on_blaze, math.cos(prm['blaze']) * one,
                        math.cos(prm['antiblaze']) * one)
        return zero, b, c
    if kind == 'ellipse':
        s = prm['cg'] * (y - prm['y0']) - prm['sg'] * (z - prm['z0'])
        nr = -prm['B'] / prm['A'] * s / torch.sqrt(prm['A'] ** 2 - s * s)
        nrm = torch.sqrt(nr * nr + 1)
        b, c = nr / nrm, 1 / nrm
        return zero, prm['cg'] * b + prm['sg'] * c, \
            -prm['sg'] * b + prm['cg'] * c
    raise ValueError(kind)


def kirchhoff_sums(dst, src, E, chunk=8192):
    """The Kirchhoff sums (sum Es U, sum Ep U) at destinations *dst* =
    (x, y, z) from sources *src* = (x, y, z, Es, Ep, nx, ny, nz, n . dir,
    weight), all in the sender's local frame, in *dst*'s dtype:
    U = i k / (4 pi) (n . dir + n . r / |r|) exp(i k |r|) / |r| w."""
    xd, yd, zd = (v[:, None] for v in dst)
    k = E / CHBAR * 1e7
    cdt = torch.complex128 if xd.dtype == torch.float64 else \
        torch.complex64
    Es_acc = torch.zeros(xd.shape[0], dtype=cdt, device=xd.device)
    Ep_acc = torch.zeros_like(Es_acc)
    ns = src[0].shape[0]
    for j in range(0, ns, chunk):
        xs, ys, zs, Es, Ep, nx, ny, nz, nl, w = (v[None, j:j + chunk]
                                                 for v in src)
        a, b, c = xd - xs, yd - ys, zd - zs
        r = torch.sqrt(a * a + b * b + c * c)
        nsr = (a * nx + b * ny + c * nz) / r
        U = torch.polar(k / (4 * PI) * (nl + nsr) * w / r, k * r)
        U = U * 1j
        Es_acc += torch.sum(Es * U, dim=1)
        Ep_acc += torch.sum(Ep * U, dim=1)
    return Es_acc, Ep_acc


def _rel(prog, ref):
    """Relative RMS difference of stacked complex or real fields."""
    num = sum(float(torch.sum(torch.abs(p - r) ** 2))
              for p, r in zip(prog, ref))
    den = sum(float(torch.sum(torch.abs(r) ** 2)) for r in ref)
    return math.sqrt(num / den) if den > 0 else float('inf')


def compare(cfg, keep, images, seed, n_dst, lowered=False):
    """The numbers that decide ``correct``: {'source_err', 'stage_err',
    'focus_err'} and the per-step readings under 'steps'.

    *keep* holds the program's state that the check reads (see
    ``configs/softimax.free_program``), *images* the focal images the
    checked run returned.  *lowered*: the control, the reference in
    float32 with plain float32 phases in the program's place."""
    dt = torch.float32 if lowered else torch.float64
    cdt = torch.complex64 if lowered else torch.complex128
    gen = torch.Generator().manual_seed(int(seed) + 3)

    def pos(d):
        """Receiving points: the float64 sum of each (hi, lo) pair, or the
        float32 hi part alone for the control."""
        xh, xl, yh, yl, zh, zl = d
        if lowered:
            return xh.float(), yh.float(), zh.float()
        return tuple(h.double() + (0 if lo is None else lo.double())
                     for h, lo in ((xh, xl), (yh, yl), (zh, zl)))

    def f64(v):
        return v.to(torch.float64)

    # the source field on the slit samples
    sh = keep['shine']
    area = cfg['accept_h'] * cfg['p_fe'] * cfg['accept_v'] * cfg['p_fe']
    Es_r, Ep_r = undulator_field(cfg, *(f64(v) for v in pos(sh['dst'])),
                                 area)
    if lowered:
        Es_p, Ep_p = undulator_field(cfg, *pos(sh['dst']), area)
    else:
        Es_p, Ep_p = sh['Es'], sh['Ep']
    out = dict(source_err=_rel((Es_p.to(torch.complex128),
                                Ep_p.to(torch.complex128)), (Es_r, Ep_r)))

    steps = {}
    focal = {}
    for name, (kind, prm) in senders(cfg).items():
        k = keep[name]
        sb = k['src_beam']
        xs, ys, zs = sb.x, sb.y, sb.z
        nx, ny, nz = normal(kind, prm, f64(xs), f64(ys), f64(zs))
        nl = f64(sb.a) * nx + f64(sb.b) * ny + f64(sb.c) * nz
        w = (sb.state == 1).to(torch.float64)
        E = float(sb.E[0])
        d = pos(k['dst'])
        nd = d[0].shape[0]
        if name.startswith('scr') or nd <= n_dst:
            idx = torch.arange(nd)
        else:
            idx = torch.randperm(nd, generator=gen)[:n_dst]
        idx = idx.to(d[0].device)
        dsel = tuple(v[idx] for v in d)

        def src(dtype, cdtype):
            return tuple(v.to(dtype) for v in (xs, ys, zs)) + (
                sb.Es.to(cdtype), sb.Ep.to(cdtype)) + tuple(
                v.to(dtype) for v in (nx, ny, nz, nl, w))
        ref = kirchhoff_sums(tuple(f64(v) for v in dsel),
                             src(torch.float64, torch.complex128), E)
        if lowered:
            prog = kirchhoff_sums(dsel, src(dt, cdt), E)
        else:
            prog = (k['EsAcc'][idx], k['EpAcc'][idx])
        prog = tuple(v.to(torch.complex128) for v in prog)
        steps[name] = _rel(prog, ref)
        if name.startswith('scr'):
            focal[name] = (prog, ref)
    out['stage_err'] = max(steps.values())

    # the focal images, each against its own peak
    errs = []
    for i in range(3):
        prog, ref = focal[f'scr{i}']
        Ir = (torch.abs(ref[0]) ** 2 + torch.abs(ref[1]) ** 2).cpu().numpy()
        if lowered:
            Ip = (torch.abs(prog[0]) ** 2 + torch.abs(prog[1]) ** 2) \
                .cpu().numpy()
        else:
            Ip = np.asarray(images[i], np.float64).ravel()
        if not (Ir.max() > 0 and Ip.max() > 0):
            errs.append(float('inf'))
            continue
        Ir, Ip = Ir / Ir.max(), Ip / Ip.max()
        errs.append(float(np.max(np.abs(Ip - Ir))))
    out['focus_err'] = max(errs)
    out['steps'] = steps
    return out
