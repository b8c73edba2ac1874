"""The Kirchhoff double sum in float32: plain PyTorch versions and the
wrapper of the hand-written CUDA kernels.

The phase k*r (~1e11 rad, needed to ~1e-3 rad) is carried in double-float
(f32-pair) arithmetic (:mod:`xrt_tpu_torch.ops.dd`); the amplitude factors
stay in plain f32.  Positions enter as (hi, lo) f32 pairs made from host
float64 by :func:`dd.from_f64`.

Two schemes, each with a plain version here and a CUDA kernel in
``csrc/``:

* recentred (:func:`kirchhoff_integral_recentred`, kernel
  ``csrc/kirchhoff_recentred.cu``): all double-float work is O(N) per-point
  precomputation (:func:`recentre_kirchhoff_inputs`); the per-pair work is
  plain f32 on small transverse offsets;
* per-pair double-float phase (:func:`kirchhoff_integral_dd`, kernel
  ``csrc/kirchhoff_ddphase.cu``), 'fast' or 'exact', for geometries
  outside the recentred envelope.

:func:`kirchhoff_integral_kernel` takes either scheme: on CPU tensors it
runs the plain version, on CUDA tensors it launches the kernel (or raises).

Every double-float step is written as separate ``+``/``*`` operations:
``addcmul`` or ``torch.compile`` would contract them into FMAs and break
the Dekker splits.
"""
from __future__ import annotations

import collections
import ctypes
import warnings

import numpy as np
import torch

from ..physconsts import PI
from . import dd

SRC_CHUNK = 512

#: kernel launches by 'kernel:variant', counted where each kernel launches
#: (``LAUNCHES.clear()`` before a run, read after it)
LAUNCHES: collections.Counter = collections.Counter()


def _astuple(v):
    if isinstance(v, tuple):
        return v
    return (v, torch.zeros_like(v))


def _broadcast_n(n, Ns, like):
    return [torch.broadcast_to(torch.as_tensor(ni, dtype=like.dtype,
                                               device=like.device), (Ns,))
            for ni in n]


def _pad(v, npad):
    if not npad:
        return v
    return torch.cat([v, torch.zeros((npad,), dtype=v.dtype,
                                     device=v.device)])


def _cx(re, im):
    return torch.complex(re, im)


# ---------------------------------------------------------------------------
# per-pair double-float phase (the 'fast'/'exact' scheme)
# ---------------------------------------------------------------------------

def _phase_dd(xd, yd, zd, xs, ys, zs, k):
    """Reduced phase (k*r mod 2pi, radians) and plain-f32 r for dd
    coordinate pairs; returns (phase, r, dx, dy, dz)."""
    dx_h, dx_l = dd.sub(xd[0], xd[1], xs[0], xs[1])
    dy_h, dy_l = dd.sub(yd[0], yd[1], ys[0], ys[1])
    dz_h, dz_l = dd.sub(zd[0], zd[1], zs[0], zs[1])
    x2_h, x2_l = dd.sqr(dx_h, dx_l)
    y2_h, y2_l = dd.sqr(dy_h, dy_l)
    z2_h, z2_l = dd.sqr(dz_h, dz_l)
    r2_h, r2_l = dd.add(x2_h, x2_l, y2_h, y2_l)
    r2_h, r2_l = dd.add(r2_h, r2_l, z2_h, z2_l)
    r_h, r_l = dd.sqrt(r2_h, r2_l)
    ka_h, ka_l = dd.mul(k[0], k[1],
                        torch.full_like(k[0], float(dd.INV_TWO_PI_HI)),
                        torch.full_like(k[0], float(dd.INV_TWO_PI_LO)))
    m_h, m_l = dd.mul(ka_h, ka_l, r_h, r_l)
    phase = dd.frac_two_pi(m_h, m_l)
    return phase, r_h, dx_h, dy_h, dz_h


def _phase_dd_fast(xd_t, yd_t, zd_t, xs_t, ys_t, zs_t, ka_t):
    """Lean dd phase: exact two-prod squares with one unnormalized
    low-order channel, a single reciprocal, and the frac(kappa*r)
    reduction.  *ka_t* is kappa = k/(2 pi) as a dd pair.  Returns
    (cycles, r, 1/r, dx, dy, dz)."""
    dxh, dxl = dd.sub(xd_t[0], xd_t[1], xs_t[0], xs_t[1])
    dyh, dyl = dd.sub(yd_t[0], yd_t[1], ys_t[0], ys_t[1])
    dzh, dzl = dd.sub(zd_t[0], zd_t[1], zs_t[0], zs_t[1])
    p1, e1 = dd.two_prod(dxh, dxh)
    p2, e2 = dd.two_prod(dyh, dyh)
    p3, e3 = dd.two_prod(dzh, dzh)
    s1, t1 = dd.two_sum(p1, p2)
    s2, t2 = dd.two_sum(s1, p3)
    lo = t1 + t2 + e1 + e2 + e3 + 2.0 * (dxh * dxl + dyh * dyl +
                                         dzh * dzl)
    s0 = dd.sqrt_rn(s2)
    rinv = 1.0 / s0
    q, eq = dd.two_prod(s0, s0)
    corr = ((s2 - q) + (lo - eq)) * (0.5 * rinv)
    mh, me = dd.two_prod(ka_t[0], s0)
    ml = me + ka_t[0] * corr + ka_t[1] * s0
    cyc = dd.frac_cycles(mh, ml)
    return cyc, s0, rinv, dxh, dyh, dzh


#: src keys of the per-pair dd scheme, in the kernel's row order
_DD_SRC_KEYS = ('xsh', 'xsl', 'ysh', 'ysl', 'zsh', 'zsl', 'kp0', 'kp1',
                'kwnl', 'kw', 'k2', 'esr', 'esi', 'epr', 'epi', 'ser', 'sei',
                'n0', 'n1', 'n2')
_DD_DST_KEYS = ('xdh', 'xdl', 'ydh', 'ydl', 'zdh', 'zdl')


def ddphase_inputs(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, weights,
                   phase_mode):
    """Per-point folding of the per-pair dd scheme: kappa = k/(2 pi) in
    dd (for 'fast') and the amplitude prefactors kw = k w/(4 pi),
    kwnl = kw nl, k2 = k^2/(4 pi).  Returns (dst, src) dicts of f32
    tensors keyed by :data:`_DD_DST_KEYS` / :data:`_DD_SRC_KEYS`."""
    f32 = xd[0].dtype
    Ns = xs[0].shape[0]
    kah, kal = dd.mul(k[0], k[1],
                      torch.full_like(k[0], float(dd.INV_TWO_PI_HI)),
                      torch.full_like(k[0], float(dd.INV_TWO_PI_LO)))
    kw = k[0] * weights * (1.0 / (4 * PI))
    esr = Es.real.to(f32)
    esi = Es.imag.to(f32)
    epr = Ep.real.to(f32)
    epi = Ep.imag.to(f32)
    kp = (kah, kal) if phase_mode == 'fast' else (k[0], k[1])
    n3 = _broadcast_n(n, Ns, xs[0])
    src = dict(xsh=xs[0], xsl=xs[1], ysh=ys[0], ysl=ys[1], zsh=zs[0],
               zsl=zs[1], kp0=kp[0], kp1=kp[1], kwnl=kw * nl, kw=kw,
               k2=k[0] ** 2 * (1.0 / (4 * PI)), esr=esr, esi=esi, epr=epr,
               epi=epi, ser=esr + epr, sei=esi + epi,
               n0=n3[0], n1=n3[1], n2=n3[2])
    dst = dict(xdh=xd[0], xdl=xd[1], ydh=yd[0], ydl=yd[1], zdh=zd[0],
               zdl=zd[1])
    return dst, src


def _ddphase_pair(d, s, phase_mode):
    """Per-pair factors of the dd scheme for broadcast-compatible dicts:
    (U_r, U_i, g_r, g_i, a, b, c)."""
    xd_t, yd_t, zd_t = (d['xdh'], d['xdl']), (d['ydh'], d['ydl']), \
        (d['zdh'], d['zdl'])
    xs_t, ys_t, zs_t = (s['xsh'], s['xsl']), (s['ysh'], s['ysl']), \
        (s['zsh'], s['zsl'])
    k_t = (s['kp0'], s['kp1'])
    if phase_mode == 'fast':
        cyc, r, rinv, a, b, c = _phase_dd_fast(xd_t, yd_t, zd_t, xs_t, ys_t,
                                               zs_t, k_t)
        sph, cph = dd.sincos_cycles(cyc)
    else:
        phase, r, a, b, c = _phase_dd(xd_t, yd_t, zd_t, xs_t, ys_t, zs_t,
                                      k_t)
        rinv = 1.0 / r
        cph = torch.cos(phase)
        sph = torch.sin(phase)
    nsk = (a * s['n0'] + b * s['n1'] + c * s['n2']) * (rinv * s['kw'])
    pre = (s['kwnl'] + nsk) * rinv
    U_r = -pre * sph
    U_i = pre * cph
    f = s['k2'] * rinv
    g_r = f * (s['ser'] * U_r - s['sei'] * U_i)
    g_i = f * (s['ser'] * U_i + s['sei'] * U_r)
    return U_r, U_i, g_r, g_i, a, b, c


def kirchhoff_integral_dd(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl,
                          weights, phase_mode='exact', src_chunk=None):
    """Five Kirchhoff accumulators with per-pair double-float phases —
    the plain version of the ``csrc/kirchhoff_ddphase.cu`` kernel.

    Positional args xd..zs and k are (hi, lo) tuples of f32 tensors;
    Es/Ep complex64; n a 3-list over src; nl, weights f32 over src.
    *phase_mode* 'exact' (renormalized dd chain, radian phase, cos/sin) or
    'fast' (:func:`_phase_dd_fast`).  Returns complex64 (Es, Ep, aE, bE,
    cE) over dst."""
    if phase_mode not in ('fast', 'exact'):
        raise ValueError(f'phase_mode {phase_mode!r}')
    dst, src = ddphase_inputs(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl,
                              weights, phase_mode)
    return _chunked_sum(dst, src, src_chunk,
                        lambda d, s: _ddphase_pair(d, s, phase_mode))


def _chunked_sum(dst, src, src_chunk, pair_fn):
    """Sum the per-pair factors of *pair_fn* over source chunks (sources
    zero-padded: zero weights and fields contribute nothing)."""
    Ns = next(iter(src.values())).shape[0]
    Nd = next(iter(dst.values())).shape[0]
    some = next(iter(dst.values()))
    chunk = src_chunk or SRC_CHUNK
    npad = (-Ns) % chunk
    srcp = {kk: _pad(v, npad) for kk, v in src.items()}
    dcol = {kk: v[:, None] for kk, v in dst.items()}
    acc = [torch.zeros((Nd,), dtype=some.dtype, device=some.device)
           for _ in range(10)]
    for j in range(0, Ns + npad, chunk):
        srow = {kk: v[None, j:j + chunk] for kk, v in srcp.items()}
        vals = pair_fn(dcol, srow)
        acc = _accumulate(acc, *vals, srow, 1)
    return (_cx(acc[0], acc[1]), _cx(acc[2], acc[3]), _cx(acc[4], acc[5]),
            _cx(acc[6], acc[7]), _cx(acc[8], acc[9]))


# ---------------------------------------------------------------------------
# recentred transverse-offset phase (the fast path)
# ---------------------------------------------------------------------------
#
# With D0/S0 reference points near the dst/src clouds, C = D0 - S0,
# R0 = |C|, L = C/R0, u = d - D0, v = s - S0 and w = u - v, the pair
# distance obeys the exact identity
#
#   r^2 = (R0 + L.w)^2 + |w_perp|^2,   w_perp = w - (L.w) L,
#
# i.e. r = A*sqrt(1 + wp2/A^2) with A = R0 + L.u - L.v and
# wp2 = |t_d - t_s|^2 where t = (u - (L.u) L) are the transverse offsets.
# All large quantities (L.u, L.v, R0, the phase kappa*(R0 - L.v)) are
# per-point double-float precomputations; the per-pair work is plain f32
# on small numbers plus a truncated sqrt series for delta = r - A.
# Phase error ~ 2*pi*(1.2e-7 * kappa*delta + 4e-7) rad.


def _presplit(a):
    """Dekker split halves of f32 *a* (each with <=12 mantissa bits), for
    exact products against another pre-split factor."""
    c = dd._SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def recentre_kirchhoff_inputs(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl,
                              weights, monochromatic=False,
                              narrowband=False):
    """Per-point precomputations for the recentred Kirchhoff phase.

    All inputs as in :func:`kirchhoff_integral_dd`.  Returns (dst, src,
    params) dicts of f32 tensors (params are 0-d) consumed by
    :func:`_recentred_pair` and the CUDA kernel — O(Nd)+O(Ns)
    double-float work.

    *narrowband* (polychromatic only): kappa_s = kappa_0 + dk_s about the
    first sample's kappa_0; the per-pair cross term dk_s*(L.u)_d is one
    f32 product (error bound :func:`narrowband_err_cycles`)."""
    f32 = xd[0].dtype
    Ns = xs[0].shape[0]

    def mean_h(t):
        # sum times the f32 reciprocal of the count, as XLA lowers a mean
        return torch.sum(t[0]) * (1.0 / t[0].shape[0])
    D0 = (mean_h(xd), mean_h(yd), mean_h(zd))
    S0 = (mean_h(xs), mean_h(ys), mean_h(zs))
    C = [dd.two_sum(D0[i], -S0[i]) for i in range(3)]
    c2 = dd.sqr(*C[0])
    c2 = dd.add(*c2, *dd.sqr(*C[1]))
    c2 = dd.add(*c2, *dd.sqr(*C[2]))
    R0 = dd.sqrt(*c2)
    rho_h, rho_l = dd.sub(*c2, *dd.sqr(*R0))
    rho = rho_h + rho_l
    L = [dd.div(*C[i], *R0) for i in range(3)]

    u = [dd.add_f(xd[0], xd[1], -D0[0]), dd.add_f(yd[0], yd[1], -D0[1]),
         dd.add_f(zd[0], zd[1], -D0[2])]
    v = [dd.add_f(xs[0], xs[1], -S0[0]), dd.add_f(ys[0], ys[1], -S0[1]),
         dd.add_f(zs[0], zs[1], -S0[2])]

    def ldot(w):
        m = dd.mul(L[0][0], L[0][1], w[0][0], w[0][1])
        m = dd.add(*m, *dd.mul(L[1][0], L[1][1], w[1][0], w[1][1]))
        m = dd.add(*m, *dd.mul(L[2][0], L[2][1], w[2][0], w[2][1]))
        return m
    pdh, pdl = ldot(u)         # L.u per dst (dd)
    lvh, lvl = ldot(v)         # L.v per src (dd)

    def transverse(w, ph, pl):
        out = []
        for i in range(3):
            proj = dd.mul(ph, pl, L[i][0], L[i][1])
            th, tl = dd.sub(w[i][0], w[i][1], proj[0], proj[1])
            out.append(th + tl)
        return out
    td = transverse(u, pdh, pdl)
    ts = transverse(v, lvh, lvl)

    kah, kal = dd.mul(k[0], k[1],
                      torch.full_like(k[0], float(dd.INV_TWO_PI_HI)),
                      torch.full_like(k[0], float(dd.INV_TWO_PI_LO)))
    qh, ql = dd.add_f(-lvh, -lvl, R0[0])
    qh, ql = dd.add_f(qh, ql, R0[1])
    mh, ml = dd.mul(kah, kal, qh, ql)
    phis = dd.frac_cycles(mh, ml)

    halfR0 = 0.5 * (R0[0] + R0[1])
    dst = dict(tdx=td[0], tdy=td[1], tdz=td[2],
               ad=halfR0 + (pdh + pdl), pdh=pdh, pdl=pdl)
    src = dict(tsx=ts[0], tsy=ts[1], tsz=ts[2],
               as_=halfR0 - (lvh + lvl), lvh=lvh, phis=phis)

    n = [v_.to(f32) for v_ in _broadcast_n(n, Ns, xs[0])]
    kw = k[0] * weights * (1.0 / (4 * PI))
    Ch = [C[i][0] + C[i][1] for i in range(3)]
    Lh = [L[i][0] + L[i][1] for i in range(3)]
    src.update(
        kw=kw, kwnl=kw * nl, k2=k[0] ** 2 * (1.0 / (4 * PI)),
        Lns=Lh[0] * n[0] + Lh[1] * n[1] + Lh[2] * n[2],
        Cns=Ch[0] * n[0] + Ch[1] * n[1] + Ch[2] * n[2],
        n0=n[0], n1=n[1], n2=n[2],
        esr=Es.real.to(f32), esi=Es.imag.to(f32),
        epr=Ep.real.to(f32), epi=Ep.imag.to(f32))
    src['ser'] = src['esr'] + src['epr']
    src['sei'] = src['esi'] + src['epi']
    params = dict(Cx=Ch[0], Cy=Ch[1], Cz=Ch[2],
                  Lx=Lh[0], Ly=Lh[1], Lz=Lh[2], rho=rho,
                  invR0=1.0 / (R0[0] + R0[1]))
    if monochromatic:
        ka0 = (kah[0], kal[0])
        mdh, mdl = dd.mul_f(*ka0, pdh)
        mdl = mdl + ka0[0] * pdl
        dst['phid'] = dd.frac_cycles(mdh, mdl)
        params['kappa_h'] = ka0[0]
        params['kappa_l'] = ka0[1]
    elif narrowband:
        ka0 = (kah[0], kal[0])
        mdh, mdl = dd.mul_f(*ka0, pdh)
        mdl = mdl + ka0[0] * pdl
        dst['phid'] = dd.frac_cycles(mdh, mdl)
        # kah - kah[0] is exact for any %-scale bandwidth (Sterbenz)
        src.update(kah=kah, kal=kal,
                   dks=(kah - ka0[0]) + (kal - ka0[1]))
    else:
        ka1, ka2 = _presplit(kah)
        pd1, pd2 = _presplit(pdh)
        src.update(kah=kah, kal=kal, ka1=ka1, ka2=ka2)
        dst.update(pd1=pd1, pd2=pd2)
    return dst, src, params


def narrowband_err_cycles(k, xd, yd, zd, xs, ys, zs):
    """Worst-case phase error (cycles) of the narrowband polychromatic
    factorization: the single-f32 cross product dk*(L.u) rounds at 2^-24
    relative.  Host helper (float64, hi parts)."""
    kh = _host64(k)
    if kh.size == 0:
        return 0.0
    dk_max = float(np.max(np.abs(kh - kh.flat[0]))) / (2 * np.pi)
    d = np.stack([_host64(xd), _host64(yd), _host64(zd)])
    s = np.stack([_host64(xs), _host64(ys), _host64(zs)])
    D0 = d.mean(axis=1)
    S0 = s.mean(axis=1)
    C = D0 - S0
    R0 = float(np.sqrt(np.sum(C * C)))
    if R0 == 0.0:
        return float('inf')
    L = C / R0
    pd_max = float(np.max(np.abs(L @ (d - D0[:, None]))))
    return dk_max * pd_max * 2.0 ** -24


def _host64(v):
    """float64 numpy array of *v* (its hi part if a (hi, lo) pair)."""
    v = v[0] if isinstance(v, tuple) else v
    if isinstance(v, torch.Tensor):
        return v.detach().to('cpu', torch.float64).numpy()
    return np.asarray(v, np.float64)


# delta = r - A = A*(sqrt(1+x) - 1) = wp2*rinv*(1/2 - x/8 + x^2/16 - ...)
_DELTA_C1 = 0.125
_DELTA_C2 = 0.0625
_DELTA_C3 = 0.0390625

# validity envelope of the separable 1/A direction-weight series of the
# 'mxu*' accumulations (weight error ~ e^3; 0.1 -> <=0.1%)
SERIES_E_MAX = 0.1
# envelope of the two-term series ('mxu2': weight error ~ e^2)
SERIES_E2_MAX = 0.03


def recentred_series_e_max(xd, yd, zd, xs, ys, zs):
    """Upper bound on the 1/A-series parameter |e| = |L.u - L.v|/R0 for
    the given destination/source clouds (hi parts; float64 on the host)."""
    d = np.stack([_host64(xd), _host64(yd), _host64(zd)])
    s = np.stack([_host64(xs), _host64(ys), _host64(zs)])
    D0 = d.mean(axis=1)
    S0 = s.mean(axis=1)
    C = D0 - S0
    R0 = float(np.sqrt(np.sum(C * C)))
    if R0 == 0.0:
        return float('inf')
    L = C / R0
    pd = L @ (d - D0[:, None])
    lv = L @ (s - S0[:, None])
    return float((np.max(np.abs(pd)) + np.max(np.abs(lv))) / R0)


def _recentred_core(d, s, params, monochromatic, narrowband=False):
    """Per-pair propagator for broadcast-compatible dst/src dicts:
    (U_r, U_i, rinv, tx, ty, tz, lw)."""
    tx = d['tdx'] - s['tsx']
    ty = d['tdy'] - s['tsy']
    tz = d['tdz'] - s['tsz']
    wp2 = tx * tx + ty * ty + tz * tz + params['rho']
    A = d['ad'] + s['as_']
    rinv = 1.0 / A
    x = wp2 * rinv * rinv
    poly = 0.5 - x * (_DELTA_C1 - x * (_DELTA_C2 - _DELTA_C3 * x))
    delta = wp2 * rinv * poly
    if monochromatic:
        phic = params['kappa_h'] * delta
        lo2 = d['phid'] + s['phis'] + params['kappa_l'] * delta
        m = lo2 - torch.round(lo2) + (phic - torch.round(phic))
    elif narrowband:
        phic = s['kah'] * delta
        u = s['dks'] * d['pdh']
        lo2 = d['phid'] + s['phis'] + (u - torch.round(u)) + \
            s['kal'] * delta
        m = lo2 - torch.round(lo2) + (phic - torch.round(phic))
    else:
        # exact kappa_s * (L.u)_d via pre-split two-product
        p = s['kah'] * d['pdh']
        e = ((s['ka1'] * d['pd1'] - p) + s['ka1'] * d['pd2'] +
             s['ka2'] * d['pd1']) + s['ka2'] * d['pd2']
        phic = s['kah'] * delta
        lo2 = e + s['kal'] * d['pdh'] + s['kah'] * d['pdl'] + s['phis'] + \
            s['kal'] * delta
        c0 = dd.frac_cycles(p, lo2)
        m = c0 + (phic - torch.round(phic))
    c = m - torch.round(m)
    sph, cph = dd.sincos_cycles(c)

    lw = d['pdh'] - s['lvh']
    num = s['Cns'] + tx * s['n0'] + ty * s['n1'] + tz * s['n2'] + \
        lw * s['Lns']
    pre = (s['kwnl'] + num * rinv * s['kw']) * rinv
    U_r = -pre * sph
    U_i = pre * cph
    return U_r, U_i, rinv, tx, ty, tz, lw


def _recentred_pair(d, s, params, monochromatic, narrowband=False):
    """Per-pair Kirchhoff factors: (U_r, U_i, g_r, g_i, ax, ay, az) — the
    propagator, the direction-integral weight g = k^2/(4 pi)/r (Es+Ep) U
    and the un-normalized direction numerators."""
    U_r, U_i, rinv, tx, ty, tz, lw = _recentred_core(
        d, s, params, monochromatic, narrowband)
    ax = params['Cx'] + tx + lw * params['Lx']
    ay = params['Cy'] + ty + lw * params['Ly']
    az = params['Cz'] + tz + lw * params['Lz']
    f = s['k2'] * rinv
    g_r = f * (s['ser'] * U_r - s['sei'] * U_i)
    g_i = f * (s['ser'] * U_i + s['sei'] * U_r)
    return U_r, U_i, g_r, g_i, ax, ay, az


_DST_KEYS_MONO = ('tdx', 'tdy', 'tdz', 'ad', 'pdh', 'phid')
_DST_KEYS_POLY = ('tdx', 'tdy', 'tdz', 'ad', 'pdh', 'pdl', 'pd1', 'pd2')
_SRC_KEYS_COMMON = ('tsx', 'tsy', 'tsz', 'as_', 'lvh', 'phis', 'kw',
                    'kwnl', 'k2', 'Lns', 'Cns', 'n0', 'n1', 'n2',
                    'esr', 'esi', 'epr', 'epi', 'ser', 'sei')
_SRC_KEYS_POLY = _SRC_KEYS_COMMON + ('kah', 'kal', 'ka1', 'ka2')
_SRC_KEYS_NARROW = _SRC_KEYS_COMMON + ('kah', 'kal', 'dks')
_PARAM_KEYS = ('Cx', 'Cy', 'Cz', 'Lx', 'Ly', 'Lz', 'rho', 'invR0',
               'kappa_h', 'kappa_l')


def _mode_keys(monochromatic, narrowband):
    if monochromatic:
        return _DST_KEYS_MONO, _SRC_KEYS_COMMON
    if narrowband:
        return _DST_KEYS_MONO, _SRC_KEYS_NARROW
    return _DST_KEYS_POLY, _SRC_KEYS_POLY


def _accumulate(acc, U_r, U_i, g_r, g_i, ax, ay, az, s, axis):
    esr, esi = s['esr'], s['esi']
    epr, epi = s['epr'], s['epi']
    return (acc[0] + torch.sum(esr * U_r - esi * U_i, dim=axis),
            acc[1] + torch.sum(esr * U_i + esi * U_r, dim=axis),
            acc[2] + torch.sum(epr * U_r - epi * U_i, dim=axis),
            acc[3] + torch.sum(epr * U_i + epi * U_r, dim=axis),
            acc[4] + torch.sum(g_r * ax, dim=axis),
            acc[5] + torch.sum(g_i * ax, dim=axis),
            acc[6] + torch.sum(g_r * ay, dim=axis),
            acc[7] + torch.sum(g_i * ay, dim=axis),
            acc[8] + torch.sum(g_r * az, dim=axis),
            acc[9] + torch.sum(g_i * az, dim=axis))


def kirchhoff_integral_recentred(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl,
                                 weights, monochromatic=False,
                                 src_chunk=None, narrowband=False):
    """Plain PyTorch evaluation of the recentred scheme — the plain
    version of the ``csrc/kirchhoff_recentred.cu`` kernel (the exact
    per-pair f32 contraction).  Returns complex64 (Es, Ep, aE, bE, cE)."""
    dst, src, params = recentre_kirchhoff_inputs(
        xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, weights, monochromatic,
        narrowband)
    dkeys, skeys = _mode_keys(monochromatic, narrowband)
    return _chunked_sum(
        {kk: dst[kk] for kk in dkeys}, {kk: src[kk] for kk in skeys},
        src_chunk,
        lambda d, s: _recentred_pair(d, s, params, monochromatic,
                                     narrowband))


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

#: sources per shared-memory stage of both CUDA kernels (csrc: CHUNK);
#: the wrappers zero-pad the sources to a multiple of it
KERNEL_SRC_CHUNK = 256
_RECENTRED_VARIANTS = {'mono': 0, 'narrowband': 1, 'poly': 2}
_DD_VARIANTS = {'fast': 0, 'exact': 1}


class _RecentredParams(ctypes.Structure):
    _fields_ = [(kk, ctypes.c_float) for kk in _PARAM_KEYS]


# (variant, dst, nd, src, ns_pad[, params], out, stream) of the C entries
_RECENTRED_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, _RecentredParams,
                       ctypes.c_void_p, ctypes.c_void_p]
_DDPHASE_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p]


def _soa(d, keys, npad=0):
    """(len(keys), N + npad) contiguous f32 CUDA structure-of-arrays, zero
    padded; raises on what the kernels do not take."""
    dev = d[keys[0]].device
    for kk in keys:
        t = d[kk]
        if t.dtype != torch.float32:
            raise TypeError(f'the Kirchhoff kernels take float32, not '
                            f'{t.dtype} ({kk})')
        if t.device != dev or dev.type != 'cuda':
            raise ValueError(f'Kirchhoff kernel input {kk} on {t.device}, '
                             f'expected one CUDA device')
    return torch.stack([_pad(d[kk], npad) for kk in keys]).contiguous()


def _launch_recentred(dst, src, params, variant, Nd, Ns):
    from . import _cuda
    dkeys, skeys = {0: _mode_keys(True, False),
                    1: _mode_keys(False, True),
                    2: _mode_keys(False, False)}[variant]
    npad = (-Ns) % KERNEL_SRC_CHUNK
    D = _soa(dst, dkeys)
    S = _soa(src, skeys, npad)
    if S.device != D.device:
        raise ValueError('Kirchhoff sources and destinations on two devices')
    dev = D.device
    out = torch.empty((10, Nd), dtype=torch.float32, device=dev)
    p = _RecentredParams(*[float(params[kk]) if kk in params else 0.0
                           for kk in _PARAM_KEYS])
    fn = _cuda.entry('kirchhoff_recentred', 'kirchhoff_recentred_launch',
                     _RECENTRED_ARGTYPES)
    err = fn(variant, D.data_ptr(), Nd, S.data_ptr(), Ns + npad, p,
             out.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(err, 'kirchhoff_recentred')
    name = {v: k for k, v in _RECENTRED_VARIANTS.items()}[variant]
    LAUNCHES[f'kirchhoff_recentred:{name}'] += 1
    return out


def _launch_ddphase(dst, src, variant, Nd, Ns):
    from . import _cuda
    npad = (-Ns) % KERNEL_SRC_CHUNK
    D = _soa(dst, _DD_DST_KEYS)
    S = _soa(src, _DD_SRC_KEYS, npad)
    if S.device != D.device:
        raise ValueError('Kirchhoff sources and destinations on two devices')
    dev = D.device
    out = torch.empty((10, Nd), dtype=torch.float32, device=dev)
    fn = _cuda.entry('kirchhoff_ddphase', 'kirchhoff_ddphase_launch',
                     _DDPHASE_ARGTYPES)
    err = fn(variant, D.data_ptr(), Nd, S.data_ptr(), Ns + npad,
             out.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(err, 'kirchhoff_ddphase')
    name = {v: k for k, v in _DD_VARIANTS.items()}[variant]
    LAUNCHES[f'kirchhoff_ddphase:{name}'] += 1
    return out


def _complex5(out):
    return tuple(_cx(out[2 * i], out[2 * i + 1]) for i in range(5))


def kirchhoff_integral_kernel(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl,
                              weights, phase_mode='recentred',
                              monochromatic=False, accumulate='mxu',
                              narrowband='auto'):
    """The Kirchhoff double sum in float32: the CUDA kernel for CUDA
    tensors, its plain PyTorch version for CPU tensors.

    Accepts plain f32 tensors (lo parts zero) or (hi, lo) tuples.
    *phase_mode*: 'recentred' (transverse-offset scheme, phase error
    ~1e-4 rad typical), 'fast' or 'exact' (per-pair double-float
    distances, any geometry).  *narrowband* ('recentred', polychromatic):
    True/False, or 'auto' to enable it when its error bound
    (:func:`narrowband_err_cycles`) is below 1e-3 cycles.

    *accumulate* ('recentred' only) names the TPU contraction the caller
    budgeted for ('mxu', 'mxu2', 'mxu-fast', 'mxu32' or 'vpu').  The CUDA
    kernel runs the exact per-pair f32 contraction for every value; the
    envelope of the 'mxu*' 1/A direction series is still checked, and a
    geometry outside it falls back to 'vpu' with a warning."""
    xd, yd, zd = _astuple(xd), _astuple(yd), _astuple(zd)
    xs, ys, zs = _astuple(xs), _astuple(ys), _astuple(zs)
    k = _astuple(k)
    if phase_mode == 'recentred':
        if narrowband == 'auto':
            narrowband = False if monochromatic else \
                narrowband_err_cycles(k, xd, yd, zd, xs, ys, zs) < 1e-3
        if accumulate.startswith('mxu'):
            e_max = recentred_series_e_max(xd, yd, zd, xs, ys, zs)
            if accumulate == 'mxu2' and e_max > SERIES_E2_MAX:
                accumulate = 'mxu'
            if e_max > SERIES_E_MAX:
                warnings.warn(
                    f"recentred 'mxu' accumulation: geometry exceeds the "
                    f"1/A-series envelope (e_max={e_max:.3f} > "
                    f"{SERIES_E_MAX}); falling back to the exact 'vpu' "
                    f"contraction for the direction integrals.",
                    stacklevel=2)
                accumulate = 'vpu'
    elif phase_mode not in ('fast', 'exact'):
        raise ValueError(f'phase_mode {phase_mode!r}')
    Ns = xs[0].shape[0]
    Nd = xd[0].shape[0]
    n3 = _broadcast_n(n, Ns, xs[0])
    if xd[0].device.type == 'cpu':
        if phase_mode == 'recentred':
            return kirchhoff_integral_recentred(
                xd, yd, zd, xs, ys, zs, Es, Ep, k, n3, nl, weights,
                monochromatic=monochromatic, narrowband=narrowband is True)
        return kirchhoff_integral_dd(xd, yd, zd, xs, ys, zs, Es, Ep, k, n3,
                                     nl, weights, phase_mode=phase_mode)
    if xd[0].device.type != 'cuda':
        raise ValueError(f'no Kirchhoff kernel for {xd[0].device}')
    if phase_mode == 'recentred':
        nb = narrowband is True and not monochromatic
        dst, src, params = recentre_kirchhoff_inputs(
            xd, yd, zd, xs, ys, zs, Es, Ep, k, n3, nl, weights,
            monochromatic, nb)
        variant = 0 if monochromatic else (1 if nb else 2)
        out = _launch_recentred(dst, src, params, variant, Nd, Ns)
    else:
        dst, src = ddphase_inputs(xd, yd, zd, xs, ys, zs, Es, Ep, k, n3,
                                  nl, weights, phase_mode)
        out = _launch_ddphase(dst, src, _DD_VARIANTS[phase_mode], Nd, Ns)
    return _complex5(out)
