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
On the card, with nothing to differentiate, the per-point preparation is
one more kernel, ``csrc/kirchhoff_prep.cu``, in place of the plain
:func:`_kernel_inputs`.

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
import torch.utils.checkpoint

from ..physconsts import PI
from ..profiler import count, stage
from . import dd

SRC_CHUNK = 512

#: kernel launches by 'kernel:variant', counted where each kernel launches
#: (``LAUNCHES.clear()`` before a run, read after it); the preparation
#: kernel's as 'prep:<mode>'.  While the profiler traces, each forward
#: launch (B1, B2) also adds to the counters ``kirchhoff.launches`` and
#: ``kirchhoff.pairs`` (its destinations x sources), each preparation by
#: the kernel to ``kirchhoff.prep_fused``, and the per-point preparation
#: around the kernels is the span ``waves.prep``.
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
    'fast' (:func:`_phase_dd_fast`).  Returns complex64 (Es, Ep, aE, bE, cE)
    over dst."""
    if phase_mode not in ('fast', 'exact'):
        raise ValueError(f'phase_mode {phase_mode!r}')
    dst, src = ddphase_inputs(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl,
                              weights, phase_mode)
    return _complex5(_chunked_sum(
        dst, src, src_chunk, lambda d, s: _ddphase_pair(d, s, phase_mode)))


def _chunked_sum(dst, src, src_chunk, pair_fn):
    """The ten real sums of the per-pair factors of *pair_fn* over source
    chunks (sources zero-padded: zero weights and fields contribute
    nothing).  While autograd records, each chunk's body runs under
    ``torch.utils.checkpoint``: the tape then keeps the (Nd,) chunk sums
    only and recomputes the (Nd, chunk) intermediates of one chunk at a
    time in the backward pass, instead of holding those of every chunk.
    The values are the same either way."""
    Ns = next(iter(src.values())).shape[0]
    Nd = next(iter(dst.values())).shape[0]
    some = next(iter(dst.values()))
    chunk = src_chunk or SRC_CHUNK
    npad = (-Ns) % chunk
    srcp = {kk: _pad(v, npad) for kk, v in src.items()}
    dcol = {kk: v[:, None] for kk, v in dst.items()}
    acc = [torch.zeros((Nd,), dtype=some.dtype, device=some.device)
           for _ in range(10)]

    def chunk_sums(srow):
        return _pair_sums(*pair_fn(dcol, srow), srow, 1)
    for j in range(0, Ns + npad, chunk):
        srow = {kk: v[None, j:j + chunk] for kk, v in srcp.items()}
        if torch.is_grad_enabled():
            part = torch.utils.checkpoint.checkpoint(
                chunk_sums, srow, use_reentrant=False,
                preserve_rng_state=False)
        else:
            part = chunk_sums(srow)
        acc = [a + p for a, p in zip(acc, part)]
    return acc


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
        # the sum in double, rounded, times the reciprocal of the count
        # (as XLA lowers a mean): the preparation kernel
        # (csrc/kirchhoff_prep.cu) sums in double too, in another order,
        # so a call with gradients recentres about the centre of one
        # without (the two roundings differ only within a double's
        # rounding of a tie)
        s = torch.sum(t[0], dtype=torch.float64).to(f32)
        return s * (1.0 / t[0].shape[0])
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


def _pair_sums(U_r, U_i, g_r, g_i, ax, ay, az, s, axis):
    """The ten sums of one chunk: Es, Ep (re, im) and the three direction
    integrals (re, im)."""
    esr, esi = s['esr'], s['esi']
    epr, epi = s['epr'], s['epi']
    return (torch.sum(esr * U_r - esi * U_i, dim=axis),
            torch.sum(esr * U_i + esi * U_r, dim=axis),
            torch.sum(epr * U_r - epi * U_i, dim=axis),
            torch.sum(epr * U_i + epi * U_r, dim=axis),
            torch.sum(g_r * ax, dim=axis),
            torch.sum(g_i * ax, dim=axis),
            torch.sum(g_r * ay, dim=axis),
            torch.sum(g_i * ay, dim=axis),
            torch.sum(g_r * az, dim=axis),
            torch.sum(g_i * az, dim=axis))


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
    return _complex5(_chunked_sum(
        {kk: dst[kk] for kk in dkeys}, {kk: src[kk] for kk in skeys},
        src_chunk,
        lambda d, s: _recentred_pair(d, s, params, monochromatic,
                                     narrowband)))


# ---------------------------------------------------------------------------
# the kernel wrappers: forward, adjoint, and the autograd functions
# ---------------------------------------------------------------------------
#
# The differentiable boundary is the per-point structure of arrays: the
# destination keys D (rows over Nd), the source keys S (rows over Ns) and,
# for the recentred scheme, the ten scalars P.  The O(N) double-float
# preparation above is plain torch under ordinary autograd; the O(Nd Ns)
# part is one ``torch.autograd.Function`` per scheme.  Its forward saves D,
# S and P only; its backward recomputes every pair.  On CUDA tensors forward
# and backward are the hand-written kernels of ``csrc/``; on CPU tensors
# they are the plain versions (:func:`_plain_rows`,
# :func:`kirchhoff_bwd_blocked`).
#
# Complex fields cross the boundary as their re/im rows, split and joined by
# ordinary torch operations, so a complex input's ``.grad`` follows
# PyTorch's convention dL/dRe + i dL/dIm (the reference package returns its
# conjugate, dL/dRe - i dL/dIm).

#: the autograd functions zero-pad the sources to a multiple of this, the
#: padding the adjoint kernels take (a multiple of ADJ_TILE)
KERNEL_SRC_CHUNK = 256
#: the forward kernels B1 and B2 (csrc/kirchhoff_fwd.cuh): destinations a
#: block (two a thread) and sources a shared-memory stage; the wrapper pads
#: the sources' rows to a multiple of the stage
FWD_TILE, FWD_CHUNK = 256, 128
#: at most this many source groups; each has private partial rows,
#: (groups, 10, Nd) floats of scratch
FWD_MAX_GROUPS = 64
#: (destination tiles) x (source groups) aimed at: several full waves of
#: the blocks an H100 holds at once, at both main-path hops
FWD_TARGET_BLOCKS = 4096
#: the one-pass adjoint kernels (csrc/kirchhoff_bwd.cuh): sources per tile
#: (one per thread; a divisor of KERNEL_SRC_CHUNK) and destinations per
#: shared-memory stage
ADJ_TILE, ADJ_CHUNK = 128, 64
#: at most this many source groups; each has a private set of destination
#: partial rows, (groups, rows, Nd) floats of scratch
ADJ_MAX_GROUPS = 128
#: (destination slabs) x (source groups) aimed at: about ten waves of the
#: blocks an H100 holds at once, so the last wave's tail is short
ADJ_TARGET_BLOCKS = 4096
_RECENTRED_VARIANTS = {'mono': 0, 'narrowband': 1, 'poly': 2}
_DD_VARIANTS = {'fast': 0, 'exact': 1}
_RECENTRED_NAMES = {v: kk for kk, v in _RECENTRED_VARIANTS.items()}
_DD_NAMES = {v: kk for kk, v in _DD_VARIANTS.items()}
_RECENTRED_KEYS = {0: _mode_keys(True, False), 1: _mode_keys(False, True),
                   2: _mode_keys(False, False)}

#: destinations per block and sources per chunk of the plain backward
#: (:func:`kirchhoff_bwd_blocked`), by device type, chosen by measurement.
#: A block keeps ~50 live (block, chunk) f32 intermediates of one
#: checkpointed chunk.  On an H100 80GB HBM3 (700 W) at 8192 x 16384,
#: recentred mono (``chip_smoke.py --sweep-plain-blocks``): 2048 x 512
#: 1658 ms (peak 0.21 GiB), 4096 x 1024 378 ms (0.80 GiB), 8192 x 512
#: 543 ms (0.80 GiB), 8192 x 2048 216 ms (3.19 GiB): eager launches
#: dominate, so the largest block wins.  On the CPU wide blocks with short
#: chunks were the fastest of those tried.
GRAD_DST_BLOCK = {'cpu': 2048, 'cuda': 8192}
GRAD_SRC_CHUNK = {'cpu': 256, 'cuda': 2048}

_P = ctypes.c_void_p
# the forward kernels' pass: (variant, dst, nd, src rows, ns_pad, params,
# ngroup, part, stream); their reduction: (part, ngroup, nd, out, stream)
_FWD_ARGTYPES = [ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, _P,
                 ctypes.c_int, _P, _P]
_FWD_REDUCE_ARGTYPES = [_P, ctypes.c_int, ctypes.c_int, _P, _P]
# the adjoints' pass: (variant, dst, nd, src, ns_pad, params, gout, nslab,
# slab, ngroup, dpart, spart, ppart, stream); their reduction: (variant,
# dpart, ngroup, nd, ddst, spart, nslab, ns_pad, dsrc, stream)
_ADJ_PASS_ARGTYPES = [ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, _P,
                      _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
                      _P, _P]
_ADJ_REDUCE_ARGTYPES = [ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P, _P,
                        ctypes.c_int, ctypes.c_int, _P, _P]
#: distinct cotangent rows (of a destination, of a source) of the adjoint
#: kernels by (scheme, variant): hi/lo halves share one
_ADJ_ROWS = {('recentred', 0): (6, 20), ('recentred', 1): (6, 23),
             ('recentred', 2): (7, 23), ('ddphase', 0): (3, 17),
             ('ddphase', 1): (3, 17)}


def _soa(d, keys):
    """(len(keys), N) structure of arrays of the per-point keys."""
    return torch.stack([d[kk] for kk in keys])


def _param_vector(params, like):
    """(10,) tensor of the recentred scalars in :data:`_PARAM_KEYS` order
    (zeros for those a variant does not have), on the device: no value
    travels to the host."""
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    return torch.stack([params.get(kk, zero) for kk in _PARAM_KEYS])


def _check_kernel_inputs(*tensors):
    """Raise on what the CUDA kernels do not take."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f'the Kirchhoff kernels take float32, not '
                            f'{t.dtype}')
        if t.device != dev or dev.type != 'cuda':
            raise ValueError(f'Kirchhoff kernel input on {t.device}, '
                             f'expected one CUDA device ({dev})')
    return dev


def _pad_sources(S):
    """*S* zero-padded along its last axis to a multiple of
    :data:`KERNEL_SRC_CHUNK`, contiguous."""
    npad = (-S.shape[1]) % KERNEL_SRC_CHUNK
    if npad:
        S = torch.cat([S, S.new_zeros((S.shape[0], npad))], dim=1)
    return S.contiguous()


def forward_sources(S):
    """The forward kernels' source rows: the structure of arrays *S* (keys,
    Ns) as (Ns padded to :data:`FWD_CHUNK`, keys padded to 4) rows, zeros
    past the last source and key; one copy."""
    nk, ns = S.shape
    rows = S.new_zeros((-(-ns // FWD_CHUNK) * FWD_CHUNK, -(-nk // 4) * 4))
    rows[:ns, :nk] = S.t()
    return rows


def forward_grid(nd, ns_pad):
    """(ntile, ngroup) of the forward kernels' grid for *nd* destinations
    and *ns_pad* padded sources: block (a, g) sums the source chunks g,
    g + ngroup, ... for the :data:`FWD_TILE` destinations of tile a."""
    ntile = -(-nd // FWD_TILE)
    ngroup = min(ns_pad // FWD_CHUNK, FWD_MAX_GROUPS,
                 -(-FWD_TARGET_BLOCKS // ntile))
    return ntile, max(ngroup, 1)


def _forward_inputs(D, S, P):
    """(D, source rows, P) as the forward kernels read them: *D* and *P*
    contiguous, the rows of *S* from :func:`forward_sources`; raises on
    what the kernels do not take."""
    dev = _check_kernel_inputs(*(t for t in (D, S, P) if t is not None))
    with stage('waves.prep', device=dev):
        P = None if P is None else P.contiguous()
        return D.contiguous(), forward_sources(S), P


def _forward_launch(scheme, variant, D, rows, P):
    """The pass of kernel B1 (*scheme* 'recentred') or B2 ('ddphase') on
    prepared inputs (:func:`_forward_inputs`): the source groups' partial
    sums (ngroup, 10, Nd)."""
    from . import _cuda
    dev = D.device
    nd, ns_pad = D.shape[1], rows.shape[0]
    _, ngroup = forward_grid(nd, ns_pad)
    part = torch.empty((ngroup, 10, nd), dtype=torch.float32, device=dev)
    _cuda.launch(f'kirchhoff_{scheme}', f'kirchhoff_{scheme}_launch',
                 _FWD_ARGTYPES, dev, variant, D.data_ptr(), nd,
                 rows.data_ptr(), ns_pad, None if P is None else P.data_ptr(),
                 ngroup, part.data_ptr())
    return part


def _forward_reduce(name, part):
    """The forward kernels' second kernel: the ten sums (10, Nd) of the
    partials *part* (ngroup, 10, Nd) of ``csrc/<name>.cu``, added in a
    fixed order in double."""
    from . import _cuda
    ngroup, _, nd = part.shape
    out = torch.empty((10, nd), dtype=torch.float32, device=part.device)
    _cuda.launch(name, f'{name}_reduce', _FWD_REDUCE_ARGTYPES, part.device,
                 part.data_ptr(), ngroup, nd, out.data_ptr())
    return out


def _forward_sums(scheme, variant, part):
    """The ten sums (10, Nd) of the pass's partials *part*: the second
    kernel, and one launch of the scheme's kernel in :data:`LAUNCHES`."""
    out = _forward_reduce(f'kirchhoff_{scheme}', part)
    names = _RECENTRED_NAMES if scheme == 'recentred' else _DD_NAMES
    LAUNCHES[f'kirchhoff_{scheme}:{names[variant]}'] += 1
    return out


def _count_forward(nd, ns):
    """The profiler's counters of one forward launch over *nd*
    destinations and *ns* sources (before their padding), while
    tracing."""
    count('kirchhoff.launches')
    count('kirchhoff.pairs', nd * ns)


def adjoint_grid(nd, ns_pad):
    """(nslab, slab, ngroup) of the adjoint kernels' grid for *nd*
    destinations and *ns_pad* padded sources: block (a, g) runs the source
    tiles g, g + ngroup, ... against the *slab* destinations of slab a."""
    ntiles = ns_pad // ADJ_TILE
    ngroup = min(ntiles, ADJ_MAX_GROUPS)
    nslab = min(-(-ADJ_TARGET_BLOCKS // ngroup), -(-nd // ADJ_CHUNK))
    slab = -(-nd // nslab)
    slab = -(-slab // ADJ_CHUNK) * ADJ_CHUNK
    return -(-nd // slab), slab, ngroup


def adjoint_scratch(scheme, variant, nd, ns_pad):
    """Shapes of the adjoint kernels' scratch: the destination partials
    (ngroup, rows, nd) and source partials (nslab, rows, ns_pad), float32,
    and the scalars' block partials (nslab * ngroup, 10), float64 (None for
    'ddphase')."""
    nslab, _, ngroup = adjoint_grid(nd, ns_pad)
    rd, rs = _ADJ_ROWS[(scheme, variant)]
    return ((ngroup, rd, nd), (nslab, rs, ns_pad),
            (nslab * ngroup, len(_PARAM_KEYS)) if scheme == 'recentred'
            else None)


def _adjoint_pass(scheme, variant, D, S, P, G):
    """The pass of the adjoint kernels (``csrc/kirchhoff_<scheme>_bwd.cu``,
    one pass over the pairs): its partials (dpart, spart, ppart)."""
    from . import _cuda
    dev = _check_kernel_inputs(*(t for t in (D, S, P, G) if t is not None))
    nd, ns_pad = D.shape[1], S.shape[1]
    if ns_pad % ADJ_TILE:
        raise ValueError(f'adjoint kernels: {ns_pad} sources are not padded '
                         f'to a multiple of {ADJ_TILE}')
    nslab, slab, ngroup = adjoint_grid(nd, ns_pad)
    dshape, sshape, pshape = adjoint_scratch(scheme, variant, nd, ns_pad)
    dpart = torch.empty(dshape, dtype=torch.float32, device=dev)
    spart = torch.empty(sshape, dtype=torch.float32, device=dev)
    ppart = None if pshape is None else \
        torch.empty(pshape, dtype=torch.float64, device=dev)
    _cuda.launch(f'kirchhoff_{scheme}_bwd', f'kirchhoff_{scheme}_bwd_launch',
                 _ADJ_PASS_ARGTYPES, dev, variant, D.data_ptr(), nd,
                 S.data_ptr(), ns_pad, None if P is None else P.data_ptr(),
                 G.data_ptr(), nslab, slab, ngroup, dpart.data_ptr(),
                 spart.data_ptr(), None if ppart is None else ppart.data_ptr())
    return dpart, spart, ppart


def _adjoint_reduce(scheme, variant, dpart, spart, D, S):
    """The adjoint kernels' second kernel: the partials summed in a fixed
    order into the cotangents of D and of the padded S."""
    from . import _cuda
    bD, bS = torch.empty_like(D), torch.empty_like(S)
    _cuda.launch(f'kirchhoff_{scheme}_bwd', f'kirchhoff_{scheme}_bwd_reduce',
                 _ADJ_REDUCE_ARGTYPES, D.device, variant, dpart.data_ptr(),
                 dpart.shape[0], D.shape[1], bD.data_ptr(), spart.data_ptr(),
                 spart.shape[0], S.shape[1], bS.data_ptr())
    return bD, bS


def _launch_adjoint(scheme, variant, D, S, P, G):
    """The adjoint kernels of B1 (*scheme* 'recentred') or B2 ('ddphase'):
    cotangents (of D, of the padded S, of P or None) for the output
    cotangents *G* (10, Nd); one launch in :data:`LAUNCHES`.  The scalars'
    block partials are summed in float64."""
    D, S, G = D.contiguous(), S.contiguous(), G.contiguous()
    P = None if P is None else P.contiguous()
    dpart, spart, ppart = _adjoint_pass(scheme, variant, D, S, P, G)
    bD, bS = _adjoint_reduce(scheme, variant, dpart, spart, D, S)
    names = _RECENTRED_NAMES if scheme == 'recentred' else _DD_NAMES
    LAUNCHES[f'kirchhoff_{scheme}_bwd:{names[variant]}'] += 1
    bP = None if ppart is None else ppart.sum(dim=0).to(torch.float32)
    return bD, bS, bP


def _launch_recentred_bwd(D, S, P, G, variant):
    """The adjoint kernel of B1: cotangents (of D, of the padded S, of
    P)."""
    return _launch_adjoint('recentred', variant, D, S, P, G)


def _launch_ddphase_bwd(D, S, G, variant):
    """The adjoint kernel of B2: cotangents (of D, of the padded S)."""
    return _launch_adjoint('ddphase', variant, D, S, None, G)[:2]


def _kernel_inputs(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, weights,
                   mode):
    """(scheme, variant, D, S, P) of the twelve inputs at the kernels'
    boundary: the per-point structure of arrays after the O(N)
    double-float preparation (plain differentiable torch).  *mode* 'mono',
    'narrowband' or 'poly' (scheme 'recentred') or 'fast' or 'exact'
    (scheme 'ddphase', P None)."""
    if mode in _RECENTRED_VARIANTS:
        variant = _RECENTRED_VARIANTS[mode]
        dst, src, params = recentre_kirchhoff_inputs(
            xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, weights,
            mode == 'mono', mode == 'narrowband')
        dkeys, skeys = _RECENTRED_KEYS[variant]
        return ('recentred', variant, _soa(dst, dkeys), _soa(src, skeys),
                _param_vector(params, xd[0]))
    dst, src = ddphase_inputs(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl,
                              weights, mode)
    return ('ddphase', _DD_VARIANTS[mode], _soa(dst, _DD_DST_KEYS),
            _soa(src, _DD_SRC_KEYS), None)


def _plain_rows(scheme, variant, D, S, P=None, src_chunk=None):
    """The plain version of kernels B1 / B2 at their own boundary: the ten
    sums (10, Nd) from the structure of arrays.  *scheme* 'recentred'
    (*variant* 0 mono, 1 narrowband, 2 poly; scalars *P*) or 'ddphase'
    (0 'fast', 1 'exact')."""
    if scheme == 'recentred':
        dkeys, skeys = _RECENTRED_KEYS[variant]
        params = {kk: P[i] for i, kk in enumerate(_PARAM_KEYS)}

        def pair(d, s):
            return _recentred_pair(d, s, params, variant == 0, variant == 1)
    else:
        dkeys, skeys = _DD_DST_KEYS, _DD_SRC_KEYS
        mode = _DD_NAMES[variant]

        def pair(d, s):
            return _ddphase_pair(d, s, mode)
    dst = {kk: D[i] for i, kk in enumerate(dkeys)}
    src = {kk: S[i] for i, kk in enumerate(skeys)}
    return torch.stack(_chunked_sum(dst, src, src_chunk, pair))


def kirchhoff_bwd_blocked(scheme, variant, D, S, P, G, dst_block=None,
                          src_chunk=None):
    """The plain version of the adjoint kernels: cotangents (of D, of S, of
    P; None for 'ddphase') of :func:`_plain_rows` for the output cotangents
    *G* (10, Nd).

    A loop over destination blocks; each block runs ``torch.autograd.grad``
    through the plain forward, whose source chunks are checkpointed
    (:func:`_chunked_sum`), so the live memory is O(dst_block x src_chunk),
    not O(Nd x Ns).  *dst_block* and *src_chunk* default to
    :data:`GRAD_DST_BLOCK` and :data:`GRAD_SRC_CHUNK` of the tensors'
    device type.  The ragged last block repeats the last destination (a
    zero-padded point could coincide with a source: r = 0, and NaN in
    every cotangent) with zero output cotangents.  The scalars' cotangents
    are summed over the blocks in float64."""
    dev = D.device.type
    Nd = D.shape[1]
    B = min(dst_block or GRAD_DST_BLOCK[dev], Nd)
    chunk = src_chunk or GRAD_SRC_CHUNK[dev]
    S0 = S.detach().requires_grad_(True)
    P0 = None if P is None else P.detach().requires_grad_(True)
    bS = torch.zeros_like(S)
    bP = None if P is None else torch.zeros(P.shape, dtype=torch.float64,
                                            device=P.device)
    bD = []
    for b in range(0, Nd, B):
        Db, Gb = D[:, b:b + B].detach(), G[:, b:b + B]
        npad = B - Db.shape[1]
        if npad:
            Db = torch.cat([Db, Db[:, -1:].expand(-1, npad)], dim=1)
            Gb = torch.cat([Gb, Gb.new_zeros((Gb.shape[0], npad))], dim=1)
        Db = Db.requires_grad_(True)
        with torch.enable_grad():
            out = _plain_rows(scheme, variant, Db, S0, P0, chunk)
        wrt = [Db, S0] + ([] if P0 is None else [P0])
        grads = torch.autograd.grad(out, wrt, Gb, allow_unused=True)
        bD.append(grads[0][:, :B - npad])
        bS += grads[1]
        if P0 is not None and grads[2] is not None:
            bP += grads[2].to(torch.float64)
    return (torch.cat(bD, dim=1), bS,
            None if bP is None else bP.to(P.dtype))


class _KirchhoffRecentred(torch.autograd.Function):
    """Kernel B1 with its adjoint: (D, S, P) -> the ten sums (10, Nd)."""

    @staticmethod
    def forward(ctx, D, S, P, variant):
        ctx.variant = variant
        ctx.ns = S.shape[1]
        if D.device.type == 'cpu':
            out = _plain_rows('recentred', variant, D, S, P)
        elif D.device.type == 'cuda':
            S = _pad_sources(S)
            out = _launch_rows('recentred', variant,
                               *_forward_inputs(D, S, P), ctx.ns)
        else:
            raise ValueError(f'no Kirchhoff kernel for {D.device}')
        ctx.save_for_backward(D, S, P)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, G):
        D, S, P = ctx.saved_tensors
        if D.device.type == 'cpu':
            bD, bS, bP = kirchhoff_bwd_blocked('recentred', ctx.variant, D,
                                               S, P, G)
        else:
            bD, bS, bP = _launch_recentred_bwd(D, S, P, G, ctx.variant)
            bS = bS[:, :ctx.ns]
        return bD, bS, bP, None


class _KirchhoffDDPhase(torch.autograd.Function):
    """Kernel B2 with its adjoint: (D, S) -> the ten sums (10, Nd)."""

    @staticmethod
    def forward(ctx, D, S, variant):
        ctx.variant = variant
        ctx.ns = S.shape[1]
        if D.device.type == 'cpu':
            out = _plain_rows('ddphase', variant, D, S)
        elif D.device.type == 'cuda':
            S = _pad_sources(S)
            out = _launch_rows('ddphase', variant,
                               *_forward_inputs(D, S, None), ctx.ns)
        else:
            raise ValueError(f'no Kirchhoff kernel for {D.device}')
        ctx.save_for_backward(D, S)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, G):
        D, S = ctx.saved_tensors
        if D.device.type == 'cpu':
            bD, bS, _ = kirchhoff_bwd_blocked('ddphase', ctx.variant, D, S,
                                              None, G)
        else:
            bD, bS = _launch_ddphase_bwd(D, S, G, ctx.variant)
            bS = bS[:, :ctx.ns]
        return bD, bS, None


def _complex5(out):
    return tuple(_cx(out[2 * i], out[2 * i + 1]) for i in range(5))


def kirchhoff_integral_kernel(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl,
                              weights, phase_mode='recentred',
                              monochromatic=False, accumulate='mxu',
                              narrowband='auto', check_envelope=True):
    """The Kirchhoff double sum in float32, differentiable in all twelve
    inputs: the CUDA kernels (forward and adjoint) for CUDA tensors, their
    plain PyTorch versions for CPU tensors.

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
    geometry outside it falls back to 'vpu' with a warning.  The check
    copies the positions to the host; a caller that chose the mode on the
    host already (a chain's build) passes ``check_envelope=False``, which
    reads nothing back and gives the same bits.

    The per-point preparation is ordinary differentiable torch; the pair
    sums are one ``torch.autograd.Function`` whose backward recomputes the
    pairs (nothing per pair is kept).  The envelope checks read detached
    float64 copies on the host.  On the card, when no argument requires
    grad, the preparation is instead the kernel ``csrc/kirchhoff_prep.cu``
    (:func:`_prep_kernel`): two launches in place of ~900 element-wise
    ones, and the same keys given the same recentring means, which it sums
    in another order.  It takes float32 tensors (complex fields) of the
    points' length or broadcast from one value, and raises on anything
    else, as the forward kernels do."""
    xd, yd, zd = _astuple(xd), _astuple(yd), _astuple(zd)
    xs, ys, zs = _astuple(xs), _astuple(ys), _astuple(zs)
    k = _astuple(k)
    with stage('waves.prep', device=xs[0]):
        mode = _resolved_mode(xd, yd, zd, xs, ys, zs, k, phase_mode,
                              monochromatic, accumulate, narrowband,
                              check_envelope)
        args = (xd, yd, zd, xs, ys, zs, Es, Ep, k,
                _broadcast_n(n, xs[0].shape[0], xs[0]), nl, weights)
        fused = _takes_prep_kernel(args)
        if fused:
            scheme, variant, D, rows, P = _prep_kernel(mode,
                                                       _flat_args(*args))
        else:
            scheme, variant, D, S, P = _kernel_inputs(*args, mode)
    if fused:
        out = _launch_rows(scheme, variant, D, rows, P, xs[0].shape[0])
    elif scheme == 'recentred':
        out = _KirchhoffRecentred.apply(D, S, P, variant)
    else:
        out = _KirchhoffDDPhase.apply(D, S, variant)
    with stage('waves.prep', device=D):
        return _complex5(out)


def _resolved_mode(xd, yd, zd, xs, ys, zs, k, phase_mode, monochromatic,
                   accumulate, narrowband, check_envelope):
    """The mode :func:`_kernel_inputs` takes ('mono', 'narrowband', 'poly',
    'fast' or 'exact') for :func:`kirchhoff_integral_kernel`'s options:
    narrowband 'auto' and the envelope check read the positions on the
    host."""
    if phase_mode in _DD_VARIANTS:
        return phase_mode
    if phase_mode != 'recentred':
        raise ValueError(f'phase_mode {phase_mode!r}')
    if narrowband == 'auto':
        narrowband = False if monochromatic else \
            narrowband_err_cycles(k, xd, yd, zd, xs, ys, zs) < 1e-3
    if accumulate.startswith('mxu') and check_envelope:
        e_max = recentred_series_e_max(xd, yd, zd, xs, ys, zs)
        if e_max > SERIES_E_MAX:
            warnings.warn(
                f"recentred 'mxu' accumulation: geometry exceeds the "
                f"1/A-series envelope (e_max={e_max:.3f} > "
                f"{SERIES_E_MAX}); falling back to the exact 'vpu' "
                f"contraction for the direction integrals.",
                stacklevel=3)
    if monochromatic:
        return 'mono'
    return 'narrowband' if narrowband is True else 'poly'


def _takes_prep_kernel(args):
    """Whether :func:`kirchhoff_integral_kernel` prepares its twelve
    arguments *args* (positions and k as (hi, lo) pairs, n as three
    members) by the kernel: the sources are on a card and nothing requires
    grad."""
    def leaves(v):
        return v if isinstance(v, (tuple, list)) else (v,)
    return args[3][0].is_cuda and not any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for v in args for t in leaves(v))


def _flat_args(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, weights):
    """The per-point arguments as the preparation kernel reads them
    (``csrc/kirchhoff_prep.cuh`` ``In``): the (hi, lo) positions, the
    fields' re and im parts as float32 views (a conjugate view resolved),
    k, the normal's three members, n . direction and the weights, each of
    the destinations' (the first six) or the sources' length, a single
    value (a number, or a tensor of one element) broadcast with a stride
    of 0.
    Raises on a real field, any other argument not float32, another device
    than the sources', or another length."""
    dev = xs[0].device

    def parts(z):
        if not isinstance(z, torch.Tensor) or not z.is_complex():
            raise TypeError(f'the Kirchhoff kernels take complex fields, '
                            f'not {getattr(z, "dtype", type(z).__name__)}')
        # another complex dtype rounded to complex64, as the plain version
        # rounds the parts
        return torch.view_as_real(
            z.resolve_conj().to(torch.complex64)).unbind(-1)
    flat = [*xd, *yd, *zd, *xs, *ys, *zs, *parts(Es), *parts(Ep), *k, *n, nl,
            weights]
    out = []
    for i, t in enumerate(flat):
        npt = xd[0].shape[0] if i < 6 else xs[0].shape[0]
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(float(t), dtype=torch.float32, device=dev)
        if t.dtype != torch.float32:
            raise TypeError(f'the Kirchhoff kernels take float32, not '
                            f'{t.dtype}')
        if t.device != dev:
            raise ValueError(f'Kirchhoff kernel input on {t.device}, '
                             f'expected {dev}')
        if t.dim() > 1 or t.numel() not in (1, npt):
            raise ValueError(f'Kirchhoff kernel input of shape '
                             f'{tuple(t.shape)}, expected ({npt},)')
        if t.shape != (npt,):
            t = t.reshape(()).expand(npt) if t.numel() == 1 else \
                t.reshape(npt)
        out.append(t)
    return out


#: the preparation kernel's variants (``csrc/kirchhoff_prep.cuh``)
_PREP_VARIANTS = {'mono': 0, 'narrowband': 1, 'poly': 2, 'fast': 3,
                  'exact': 4}
#: its centre buffer (floats; the first ten are P) and the blocks at most of
#: its centre launch, whose partial sums are (blocks, 6) doubles of scratch
PREP_CENTRE, PREP_MAX_BLOCKS = 27, 160
_PREP_ARGTYPES = [ctypes.c_int, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_longlong, _P, _P, _P, _P, _P, _P]


def _prep_kernel(mode, flat):
    """(scheme, variant, D, source rows, P) of the arguments *flat* (from
    :func:`_flat_args`, on a card) by ``csrc/kirchhoff_prep.cu``: the
    recentring centre, then every point's keys in the layouts the forward
    kernels read (:func:`_forward_inputs`), the sources zero-padded to a
    multiple of :data:`KERNEL_SRC_CHUNK` as the autograd functions pad
    them; one launch in :data:`LAUNCHES` under ``prep:<mode>`` (a name
    outside the forward kernels' ``kirchhoff_*``), and the counter
    ``kirchhoff.prep_fused`` while tracing."""
    dev = flat[0].device
    nd, ns = flat[0].shape[0], flat[6].shape[0]
    if mode in _DD_VARIANTS:
        scheme, variant, (dkeys, skeys) = 'ddphase', _DD_VARIANTS[mode], \
            (_DD_DST_KEYS, _DD_SRC_KEYS)
    else:
        scheme, variant = 'recentred', _RECENTRED_VARIANTS[mode]
        dkeys, skeys = _RECENTRED_KEYS[variant]
    ns_pad = -(-ns // KERNEL_SRC_CHUNK) * KERNEL_SRC_CHUNK
    D = torch.empty((len(dkeys), nd), dtype=torch.float32, device=dev)
    rows = torch.empty((ns_pad, -(-len(skeys) // 4) * 4),
                       dtype=torch.float32, device=dev)
    cen = scratch = None
    if scheme == 'recentred':
        from . import _cuda
        cen = torch.empty((PREP_CENTRE,), dtype=torch.float32, device=dev)
        # the centre launch's partial sums and, in the last double, the
        # ticket that tells its last block
        scratch = _cuda.scratch('kirchhoff_prep', 6 * PREP_MAX_BLOCKS + 1,
                                dev)
    _prep_launch(
        dev, _PREP_VARIANTS[mode],
        (_P * len(flat))(*(t.data_ptr() for t in flat)),
        (ctypes.c_longlong * len(flat))(*(t.stride(0) for t in flat)),
        nd, ns, ns_pad, D.data_ptr(), rows.data_ptr(),
        None if cen is None else cen.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if scratch is None else scratch[-1:].data_ptr())
    LAUNCHES[f'prep:{mode}'] += 1
    count('kirchhoff.prep_fused')
    return scheme, variant, D, rows, None if cen is None else cen[:10]


def _prep_launch(dev, *args):
    """``kirchhoff_prep_launch`` of ``csrc/kirchhoff_prep.cu`` on card
    *dev* with *args* (all but the stream); raises on a launch error."""
    from . import _cuda
    _cuda.launch('kirchhoff_prep', 'kirchhoff_prep_launch', _PREP_ARGTYPES,
                 dev, *args)


def _launch_rows(scheme, variant, D, rows, P, ns):
    """Kernel B1 (*scheme* 'recentred') or B2 ('ddphase') of
    :func:`kirchhoff_integral_kernel` on the prepared *D*, source *rows*
    and *P* (of :func:`_prep_kernel`, or :func:`_forward_inputs` after the
    plain preparation) for *ns* sources: the ten sums (10, Nd), one launch
    in :data:`LAUNCHES` and the tracing counters."""
    out = _forward_sums(scheme, variant,
                        _forward_launch(scheme, variant, D, rows, P))
    _count_forward(D.shape[1], ns)
    return out
