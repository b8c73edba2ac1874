"""The plain reference of the diced Johansson analyzer, in float64 PyTorch.

It imports nothing of the program under test.  From the configuration file
and the raw scattering tables (a frozen copy of the two rows of Chantler's
Si table around the working energy, and Si's Waasmaier-Kirfel f0
coefficients) it works out the crystal's susceptibilities, the working
energy E0, the analyzer's surface (a Johansson toroid cut into facets, the
facet of a point rounded half to even), the intersection of each ray with
it (bisection on the bracket of xrt's search), the reflection through the
Bragg planes' grating vector and the Belyakov-Dmitrienko two-beam
amplitudes of a thick Bragg crystal, the detector's plane, and the three
plots' histograms.  The formulas follow xrt's (``raycing/oes.py``,
``raycing/materials.py``); the facet normal is xrt's sum of the facet
centre's surface normal and the facet's own bend.

What it takes from a run, and only to judge it: each checked pass's source
rays (random draws, which it holds to their laws and then traces itself),
the crystal's local and global beams, the detector's beam and the plots'
totals before and after the pass.

``compare(..., lowered=True)`` is the control: the same reference in
bfloat16 (the step below the configuration's float32; the complex
amplitudes, which bfloat16 lacks, in complex64 from bfloat16 angles) put
in the program's place.
"""
import math

import numpy as np
import torch

PI = math.pi
CH = 6.626069573e-27 * 2.99792458e10 / 1.602176565e-12 * 1e8   # eV A
R0_A = 2.817940285e-5          # classical electron radius, A
#: Si, 'Chantler total': (E [eV], f1, f2) at the rows around 9.1 keV, as
#: the raw table stores them (float32)
SI_F1F2 = ((9030.7939453125, 0.23729991912841797, 0.26890042424201965),
           (9653.9189453125, 0.2193002700805664, 0.23543143272399902))
#: Si, Waasmaier-Kirfel: a1..a5, c, b1..b5
SI_F0 = (4.98816795, 3.35710271, 1.50292204, 1.22172882, 2.76143663,
         0.15142442, 2.53600438, 29.97580504, 0.08254945, 88.73513838,
         1.1671239)
MAX_DEPTH, DT_MARGIN = 100.0, 1e-5
BISECTIONS = 80

#: per-ray tolerances of "the same answer": local and detector positions
#: (mm), directions, and each polarization's reflectivity (|r|^2 J0 of the
#: unpolarized 0.5)
TOL_POS, TOL_DIR, TOL_J = 1e-2, 1e-5, 2e-2


class Crystal:
    """Si(hkl) of the diamond lattice from the configuration."""

    def __init__(self, cfg):
        cr = cfg['crystal']
        h = cr['hkl']
        self.d = cr['d111'] / h[0]
        self.V = (self.d * math.sqrt(sum(i * i for i in h))) ** 3
        self.Z, self.DW = cr['Z'], cr['factDW']
        s = sum(h)
        self.dj = complex(1 + math.cos(0.5 * PI * s), math.sin(0.5 * PI * s))
        q2 = (0.5 / self.d) ** 2
        a, c, b = SI_F0[0:5], SI_F0[5], SI_F0[6:11]
        self.f0 = c + sum(ai * math.exp(-bi * q2) for ai, bi in zip(a, b))

    def f1f2(self, E):
        (e0, a0, b0), (e1, a1, b1) = SI_F1F2
        w = (E - e0) / (e1 - e0)
        return torch.complex(a0 + w * (a1 - a0), b0 + w * (b1 - b0))

    def chi(self, E):
        """(chi0, chih, chih_) at energies *E* (eV, tensor)."""
        f = self.f1f2(E.double())
        F0 = 4 * (self.Z + f) * self.DW * 2
        Fh = 4 * (self.f0 + f) * self.DW * self.dj
        Fh_ = 4 * (self.f0 + f) * self.DW * self.dj.conjugate()
        lam = CH / E.double()
        k = -R0_A / PI / self.V * lam * lam
        return (torch.conj(F0) * k, torch.conj(Fh) * k, torch.conj(Fh_) * k)

    def E0(self, theta):
        """The speed test's working energy: the Bragg energy at theta with
        the refraction shift chi0 / sin(2 theta_B)."""
        E = torch.tensor([CH / (2 * self.d * math.sin(theta))],
                         dtype=torch.float64)
        chi0 = self.chi(E)[0]
        thB = math.asin(CH / (2 * self.d * float(E)))
        dth = float(chi0.real) / math.sin(2 * thB)
        return CH / (2 * self.d * math.sin(theta + dth))

    def amplitude(self, E, inSN, outSN, inHN):
        """Thick Bragg two-beam amplitudes (s, p), with the |b|^-1/2 flux
        factor."""
        chi0, chih, chih_ = self.chi(E)
        lam = CH / E
        k = 2 * PI / lam
        k0s, kHs = -inSN * k, -outSN * k
        b = k0s / kHs
        HoverK = lam / self.d
        alpha = HoverK * (0.5 * HoverK - torch.abs(inHN)) + \
            chi0 / 2 * (1 / b - 1)
        thB = torch.asin(CH / (2 * self.d * E))
        out = []
        for pol in (torch.ones_like(E), torch.cos(2 * thB)):
            delta = torch.sqrt(alpha * alpha + pol * pol * chih * chih_ / b)
            ra = chih * pol / (alpha + delta)
            rb = chih * pol / (alpha - delta)
            ra = torch.where(torch.isnan(torch.abs(ra)) |
                             (torch.abs(rb) < torch.abs(ra)), rb, ra)
            out.append(ra / torch.sqrt(torch.abs(b)))
        return out


class Analyzer:
    """The diced Johansson toroid and the detector, from the
    configuration."""

    def __init__(self, cfg):
        self.R = cfg['R']
        th = math.radians(cfg['theta_deg'])
        self.theta = th
        self.Rs = 2 * self.R * math.sin(th) ** 2
        self.p = 2 * self.R * math.sin(th)
        fc = cfg['facet']
        self.fx, self.fy = fc['dx'], fc['dy']
        self.sx, self.sy = fc['dx'] + fc['dx_gap'], fc['dy'] + fc['dy_gap']
        self.lim = (cfg['crystal_size'][0] / 2, cfg['crystal_size'][1] / 2)
        s2, c2 = math.sin(2 * th), math.cos(2 * th)
        self.det_c = (0.0, self.p + self.p * c2, self.p * s2)
        self.det_ex, self.det_ey, self.det_ez = (1.0, 0, 0), (0, c2, s2), \
            (0, -s2, c2)

    def facets(self, x, y):
        cx = torch.round(x / self.sx) * self.sx
        cy = torch.round(y / self.sy) * self.sy
        return cx, cy, x - cx, y - cy

    def center_surface(self, cx, cy):
        """(z, surface normal, Bragg-plane normal) of the Johansson toroid
        at the facet centres."""
        R, Rs = self.R, self.Rs
        root = torch.sqrt(torch.clamp(R * R - cy * cy, min=1e-30))
        z0 = R - Rs - root
        cos0 = torch.sqrt(torch.clamp(z0 * z0 - cx * cx, min=1e-30)) / \
            torch.abs(z0)
        z = cos0 * z0 + Rs
        r = Rs - (R - root)
        cosr = torch.sqrt(torch.clamp(r * r - cx * cx, min=1e-30)) / r
        sinr = -cx / r
        cs = root / R
        ns = (sinr * cs, -cy / R, cosr * cs)
        bb, cb = -cy, root + R
        nrm = torch.sqrt(bb * bb + cb * cb)
        bb, cb = bb / nrm, cb / nrm
        nb = (sinr * cb, bb, cosr * cb)
        return z, ns, nb

    def local_z(self, x, y):
        cx, cy, fx, fy = self.facets(x, y)
        z, ns, _ = self.center_surface(cx, cy)
        return z + (fy * fy / 2 / self.R - ns[0] * fx - ns[1] * fy) / ns[2]

    def normals(self, x, y):
        """(surface normal, Bragg-plane normal) at local points: the facet
        centre's surface normal plus the facet's own bend, normalized."""
        cx, cy, fx, fy = self.facets(x, y)
        _, ns, nb = self.center_surface(cx, cy)
        bd = -fy / self.R
        nd = torch.sqrt(bd * bd + 1)
        n1, n2, n3 = ns[2] + 1 / nd, ns[1] + bd / nd, ns[0]
        nrm = torch.sqrt(n1 * n1 + n2 * n2 + n3 * n3)
        return (n3 / nrm, n2 / nrm, n1 / nrm), nb

    def good(self, x, y):
        _, _, fx, fy = self.facets(x, y)
        inside = (x >= -self.lim[0]) & (x <= self.lim[0]) & \
            (y >= -self.lim[1]) & (y <= self.lim[1])
        return inside & (torch.abs(fx) <= self.fx / 2) & \
            (torch.abs(fy) <= self.fy / 2)

    def to_local(self, x, y, z, a, b, c):
        c0, s0 = math.cos(self.theta), math.sin(self.theta)
        y = y - self.p
        return (x, c0 * y + s0 * z, -s0 * y + c0 * z,
                a, c0 * b + s0 * c, -s0 * b + c0 * c)

    def to_global(self, x, y, z, a, b, c):
        c0, s0 = math.cos(self.theta), math.sin(self.theta)
        return (x, c0 * y - s0 * z + self.p, s0 * y + c0 * z,
                a, c0 * b - s0 * c, s0 * b + c0 * c)

    def bracket(self, x, y, z, a, b, c):
        def set_t(v, d, lo, hi):
            ds = torch.where(d == 0, torch.full_like(d, 1e-30), d)
            t1, t2 = (lo - v) / ds, (hi - v) / ds
            pos = d > 0
            return (torch.where(pos, t1, t2) - DT_MARGIN,
                    torch.where(pos, t2, t1) + DT_MARGIN)
        tx = set_t(x, a, -self.lim[0], self.lim[0])
        ty = set_t(y, b, -self.lim[1], self.lim[1])
        tz = set_t(z, c, -MAX_DEPTH, MAX_DEPTH)
        aa, ab, ac = torch.abs(a), torch.abs(b), torch.abs(c)
        useX = (aa >= ab) & (aa >= ac)
        useY = (ab > aa) & (ab >= ac)
        tMin = torch.where(useX, tx[0], torch.where(useY, ty[0], tz[0]))
        tMax = torch.where(useX, tx[1], torch.where(useY, ty[1], tz[1]))
        return tMin, torch.maximum(tMax, tMin)

    def intersect(self, x, y, z, a, b, c):
        """(t, hit) of each ray with the faceted surface: bisection of
        z(t) - surface(t) on the search's bracket; *hit* is False where the
        ray starts below the surface or never crosses it."""
        def F(t):
            return (z + c * t) - self.local_z(x + a * t, y + b * t)
        ta, tb = self.bracket(x, y, z, a, b, c)
        fa, fb = F(ta), F(tb)
        hit = (fa > 0) & (fb < 0)
        for _ in range(BISECTIONS):
            tm = 0.5 * (ta + tb)
            fm = F(tm)
            above = fm > 0
            ta = torch.where(above, tm, ta)
            tb = torch.where(above, tb, tm)
        return 0.5 * (ta + tb), hit


def trace(cfg, beam, dtype=torch.float64):
    """The reference's trace of the source rays *beam* (dict of tensors in
    the global frame): {'loc': local hit and outgoing ray with Jss, Jpp,
    'glo': the outgoing ray in the global frame, 'det': the detector's
    (x, z), 'good'} in *dtype* (bfloat16 for the control; its amplitudes in
    complex64)."""
    an, cr = Analyzer(cfg), Crystal(cfg)
    v = {k: beam[k].to(dtype) for k in 'xyzabcE'}
    x, y, z, a, b, c = an.to_local(v['x'], v['y'], v['z'], v['a'], v['b'],
                                   v['c'])
    t, hit = an.intersect(x, y, z, a, b, c)
    x, y, z = x + a * t, y + b * t, z + c * t
    good = hit & an.good(x, y)
    ns, nb = an.normals(x, y)
    inHN = a * nb[0] + b * nb[1] + c * nb[2]
    inSN = a * ns[0] + b * ns[1] + c * ns[2]
    nDotNs = nb[0] * ns[0] + nb[1] * ns[1] + nb[2] * ns[2]
    sg = 1.0 if float(torch.mean(torch.clamp(inHN, -1, 1).float())) < 0 \
        else -1.0
    wHd = 1.0 / (cr.d * 1e-7)
    g = [(nb[i] - nDotNs * ns[i]) * wHd * sg for i in range(3)]
    E = v['E']
    oL = CH / E * 1e-7
    inG = a * g[0] + b * g[1] + c * g[2]
    G2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
    u = inSN * inSN - 2 * inG * oL - G2 * oL * oL
    dn = inSN - torch.sqrt(torch.abs(u))
    ao = a - ns[0] * dn + g[0] * oL
    bo = b - ns[1] * dn + g[1] * oL
    co = c - ns[2] * dn + g[2] * oL
    nrm = torch.sqrt(ao * ao + bo * bo + co * co)
    ao, bo, co = ao / nrm, bo / nrm, co / nrm
    outSN = ao * ns[0] + bo * ns[1] + co * ns[2]
    adt = torch.float64 if dtype == torch.float64 else torch.float32
    rs, rp = cr.amplitude(E.to(adt), inSN.to(adt), outSN.to(adt),
                          inHN.to(adt))
    Jss = 0.5 * torch.nan_to_num(torch.abs(rs) ** 2)
    Jpp = 0.5 * torch.nan_to_num(torch.abs(rp) ** 2)
    gx, gy, gz, ga, gb, gc = an.to_global(x, y, z, ao, bo, co)
    # the detector plane
    d = [gv - cv for gv, cv in zip((gx, gy, gz), an.det_c)]
    ex, ey, ez = an.det_ex, an.det_ey, an.det_ez

    def dot(p, e):
        return p[0] * e[0] + p[1] * e[1] + p[2] * e[2]
    lx, ly, lz = dot(d, ex), dot(d, ey), dot(d, ez)
    la, lb, lc = dot((ga, gb, gc), ex), dot((ga, gb, gc), ey), \
        dot((ga, gb, gc), ez)
    path = -ly / lb
    return dict(loc=(x, y, z, ao, bo, co, Jss.to(dtype), Jpp.to(dtype)),
                glo=(gx, gy, gz, ga, gb, gc),
                det=(lx + la * path, lz + lc * path), good=good)


def source_z(cfg, src, si, E0):
    """The largest |z-score| of the source rays' moments against their
    laws (x, z normal; x', z' flat; the energy flat or on its lines), or
    inf where a ray breaks an exact property of its law."""
    R = cfg['R']
    th = math.radians(cfg['theta_deg'])
    dxc, dyc = cfg['crystal_size']
    pdp = 2 * R * math.sin(th - dyc / 6 / R)
    dxp, dzp = dxc / pdp, dyc * math.sin(th) / pdp
    v = {k: src[k].double() for k in 'xyzabcE'}
    v.update(Jss=src['Jss'].double(), Jpp=src['Jpp'].double())
    n = v['x'].shape[0]
    exact = bool(torch.all(v['y'] == 0)) and \
        bool(torch.all((v['Jss'] == 0.5) & (v['Jpp'] == 0.5))) and \
        bool(torch.all(src['state'] == 1))
    # the drawn divergences (b follows from them: a^2 + c^2 < 1)
    xp, zp = v['a'], v['c']
    slack = 1 + 1e-6
    exact &= bool(torch.all(torch.abs(xp) <= dxp / 2 * slack)) and \
        bool(torch.all(torch.abs(zp) <= dzp / 2 * slack))
    exact &= bool(torch.all(torch.abs(v['a'] ** 2 + v['b'] ** 2 +
                                      v['c'] ** 2 - 1) < 1e-6))
    zs = []

    def normal(s, sigma):
        m, var = float(s.mean()), float(s.var())
        zs.extend([m / (sigma / math.sqrt(n)),
                   (var / sigma ** 2 - 1) / math.sqrt(2 / (n - 1))])

    def flat(s, lo, hi):
        w = hi - lo
        m, var = float(s.mean()), float(s.var())
        zs.extend([(m - 0.5 * (lo + hi)) / (w / math.sqrt(12 * n)),
                   (var - w * w / 12) / (w * w / math.sqrt(180 * n))])
    normal(v['x'], cfg['beam_h'])
    normal(v['z'], cfg['beam_v'])
    flat(xp, -dxp / 2, dxp / 2)
    flat(zp, -dzp / 2, dzp / 2)
    s = cfg['sources'][si]
    ef = cfg['e_axis_flat']
    if s['distE'] == 'flat':
        lo, hi = E0 * (1 - ef), E0 * (1 + ef)
        exact &= bool(torch.all((v['E'] >= lo * (1 - 1e-6)) &
                                (v['E'] <= hi * (1 + 1e-6))))
        flat(v['E'], lo, hi)
    else:
        lines = torch.tensor([E0 + i * E0 * ef * cfg['line_step']
                              for i in s['lines']], dtype=torch.float64,
                             device=v['E'].device)
        dist = torch.min(torch.abs(v['E'][:, None] - lines[None]), dim=1)
        exact &= bool(torch.all(dist.values <= 1e-6 * E0))
        k = len(s['lines'])
        if k > 1:
            counts = torch.bincount(dist.indices, minlength=k).double()
            p = 1.0 / k
            zs.extend(((counts - n * p) / math.sqrt(n * p * (1 - p)))
                      .tolist())
    return max(abs(zz) for zz in zs) if exact else float('inf')


def _bin(v, lim, bins):
    """xrt's bin of each value: floor((v - lo) / span * bins) as a
    subtract, a division and a multiply in the values' own precision
    (float32 rays: the lower limit and the span hi - lo each rounded to
    float32 once), -1 outside."""
    lo = torch.tensor(lim[0], dtype=v.dtype, device=v.device)
    span = torch.tensor(lim[1] - lim[0], dtype=v.dtype, device=v.device)
    nb = torch.tensor(float(bins), dtype=v.dtype, device=v.device)
    i = torch.floor((v - lo) / span * nb)
    return torch.where((i >= 0) & (i < bins), i, -1).long()


def _hist1(v, w, bins, lim):
    """A pass's 1D histogram, float64 sums; rays outside left out."""
    i = _bin(v, lim, bins)
    ok = i >= 0
    return torch.zeros(bins, dtype=torch.float64, device=v.device) \
        .index_add_(0, i[ok], w[ok])


def _hist2(x, y, w, bins, xl, yl):
    """A pass's 2D histogram (y bins, x bins), float64 sums."""
    ix, iy = _bin(x, xl, bins), _bin(y, yl, bins)
    ok = (ix >= 0) & (iy >= 0)
    return torch.zeros(bins * bins, dtype=torch.float64, device=x.device) \
        .index_add_(0, iy[ok] * bins + ix[ok], w[ok]).reshape(bins, bins)


def compare(cfg, kept, lowered=False):
    """The numbers that decide ``correct``: 'source_z', 'rays_off' (the
    largest share, over the checked passes, of rays whose state, local or
    detector position, direction or reflectivity is not the reference's
    within the per-ray tolerances), 'flux_err' (the largest relative
    difference of a pass's reflected flux, s or p, over the rays good on
    both sides) and 'hist_err' (the largest relative L1 difference of a
    plot's pass histograms from the reference's histograms of the same
    rays)."""
    cr = Crystal(cfg)
    E0 = cr.E0(math.radians(cfg['theta_deg']))
    ef = cfg['e_axis_flat']
    names = ('source_z', 'rays_off', 'flux_err', 'hist_err')
    if not kept or any('after' not in k for k in kept.values()):
        return dict({k: float('inf') for k in names}, passes=len(kept))
    out = dict({k: 0.0 for k in names}, passes=len(kept))
    for (si, _), k in sorted(kept.items()):
        s = k['source']
        src = {f: getattr(s, f) for f in 'xyzabcE'}
        src.update(Jss=s.Jss, Jpp=s.Jpp, state=s.state)
        ref = trace(cfg, src)
        if lowered:
            # the control's source: the same draws in bfloat16
            src = {f: v.to(torch.bfloat16) if v.is_floating_point() else v
                   for f, v in src.items()}
            low = trace(cfg, src, torch.bfloat16)
            prog_loc = tuple(t.double() for t in low['loc'])
            prog_glo = tuple(t.double() for t in low['glo'])
            prog_det = tuple(t.double() for t in low['det'])
            prog_good = low['good']
        else:
            loc, glo, det = k['loc'], k['glo'], k['det']
            prog_loc = tuple(getattr(loc, f).double()
                             for f in ('x', 'y', 'z', 'a', 'b', 'c', 'Jss',
                                       'Jpp'))
            prog_glo = tuple(getattr(glo, f).double() for f in 'xyzabc')
            prog_det = (det.x.double(), det.z.double())
            prog_good = loc.state == 1
        out['source_z'] = max(out['source_z'], source_z(cfg, src, si, E0))
        both = prog_good & ref['good']
        off = prog_good != ref['good']
        rl = ref['loc']
        for i in range(3):
            off |= both & (torch.abs(prog_loc[i] - rl[i]) > TOL_POS)
        for i in range(3, 6):
            off |= both & (torch.abs(prog_loc[i] - rl[i]) > TOL_DIR)
            off |= both & (torch.abs(prog_glo[i] - ref['glo'][i]) > TOL_DIR)
        for i in range(6, 8):
            off |= both & (torch.abs(prog_loc[i] - rl[i]) > TOL_J * 0.5)
        for i in range(2):
            off |= both & (torch.abs(prog_det[i] - ref['det'][i]) > TOL_POS)
        out['rays_off'] = max(out['rays_off'], float(off.double().mean()))
        # the pass's reflected flux in each polarization over the rays good
        # on both sides
        for i in (6, 7):
            fp = float(torch.sum(prog_loc[i] * both))
            fr = float(torch.sum(rl[i].double() * both))
            err = abs(fp - fr) / fr if fr > 0 else float('inf')
            out['flux_err'] = max(out['flux_err'], err)

        # the plots' histograms of this pass, from the program's rays
        before, after = k['before'], k['after']
        if lowered:
            beams = dict(local=(prog_loc[0], prog_loc[1]),
                         detector=(prog_det[0], prog_det[1]))
            E = src['E'].double()
        else:
            beams = dict(local=(k['loc'].x, k['loc'].y),
                         detector=(k['det'].x, k['det'].z))
            E = src['E']
        w = (prog_loc[6] + prog_loc[7]) * prog_good.double()
        for pi, p in enumerate(cfg['plots']):
            xv, yv = beams[p['beam']]
            xl, yl, cl = k['limits'][pi]
            h2 = _hist2(xv, yv, w, p['bins'], xl, yl)
            hx = _hist1(xv, w, p['bins'], xl)
            hy = _hist1(yv, w, p['bins'], yl)
            hc = _hist1(E, w, cfg['c_bins'], cl)
            if lowered:
                # the control's histograms: its rays binned in bfloat16
                b16 = [t.to(torch.bfloat16) for t in (xv, yv, E, w)]
                low = dict(total2D=_hist2(b16[0], b16[1], w, p['bins'],
                                          xl, yl),
                           x=_hist1(b16[0], w, p['bins'], xl),
                           y=_hist1(b16[1], w, p['bins'], yl),
                           c=_hist1(b16[2], w, cfg['c_bins'], cl))
            for key, h in (('total2D', h2), ('x', hx), ('y', hy),
                           ('c', hc)):
                got = low[key].cpu().numpy() if lowered else \
                    after[pi][key] - before[pi][key]
                ref_h = h.cpu().numpy()
                den = np.abs(ref_h).sum()
                err = np.abs(got - ref_h).sum() / den if den > 0 else \
                    (0.0 if np.abs(got).sum() == 0 else float('inf'))
                out['hist_err'] = max(out['hist_err'], float(err))
    return out
