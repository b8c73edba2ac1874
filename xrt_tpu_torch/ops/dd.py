"""Double-float ("double-double" style) arithmetic on float32 pairs.

Port of the reference package's ``ops/dd.py``; the CUDA helpers in
``csrc/dd.cuh`` repeat it op for op.  A value is (hi, lo) with
value = hi + lo and |lo| <= ulp(hi)/2, giving ~48 bits of mantissa from
float32 arithmetic.
Used to carry the Kirchhoff phase k*r (~1e11 rad) to ~1e-4 rad.

Algorithms: Knuth two-sum, Dekker split/two-product.  Every step is a
separate tensor operation: a fused multiply-add (``addcmul``, or
``torch.compile`` contracting ``c - (c - a)``) would break the Dekker
split, so this module uses neither.  ``torch.round`` rounds half to even,
like ``jnp.round``.
"""
from __future__ import annotations

import numpy as np
import torch

_SPLIT = 4097.0  # 2^12 + 1 for float32 Dekker splitting


def two_sum(a, b):
    """Exact a + b = s + e (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Exact a + b = s + e, requires |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Exact a * b = p + e (Dekker)."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def add(ahi, alo, bhi, blo):
    """dd + dd."""
    s, e = two_sum(ahi, bhi)
    e = e + (alo + blo)
    return quick_two_sum(s, e)


def sub(ahi, alo, bhi, blo):
    return add(ahi, alo, -bhi, -blo)


def add_f(ahi, alo, b):
    s, e = two_sum(ahi, b)
    e = e + alo
    return quick_two_sum(s, e)


def mul(ahi, alo, bhi, blo):
    """dd * dd."""
    p, e = two_prod(ahi, bhi)
    e = e + (ahi * blo + alo * bhi)
    return quick_two_sum(p, e)


def mul_f(ahi, alo, b):
    """dd * float."""
    p, e = two_prod(ahi, b)
    e = e + alo * b
    return quick_two_sum(p, e)


def sqr(ahi, alo):
    p, e = two_prod(ahi, ahi)
    e = e + 2.0 * ahi * alo
    return quick_two_sum(p, e)


def div(ahi, alo, bhi, blo):
    """dd / dd by one Newton refinement of the f32 quotient."""
    q1 = ahi / bhi
    p_hi, p_lo = mul_f(bhi, blo, q1)
    r_hi, r_lo = sub(ahi, alo, p_hi, p_lo)
    q2 = (r_hi + r_lo) / bhi
    return quick_two_sum(q1, q2)


def sqrt_rn(x):
    """Correctly rounded square root.  PyTorch's vectorized CPU sqrt is off
    by one ulp on a fraction of a percent of float32 and float64 inputs;
    the double-float code and the float64 Kirchhoff phase need the IEEE
    result (one ulp of r is ~1e-6 rad at k r ~ 1e10).  On the CPU the root
    is taken by numpy; on the card torch's sqrt is IEEE already."""
    if x.device.type == 'cpu' and not x.requires_grad:
        try:
            arr = x.numpy()
        except RuntimeError:    # no storage: inside a torch.func transform
            return torch.sqrt(x)
        with np.errstate(invalid='ignore'):     # NaN below 0, as torch
            return torch.from_numpy(np.asarray(np.sqrt(arr)))
    return torch.sqrt(x)


def sqrt(ahi, alo):
    """dd sqrt by one Newton step: s = s0 + (a - s0^2)/(2 s0)."""
    s0 = sqrt_rn(ahi)
    s0 = torch.where(ahi <= 0, torch.zeros_like(s0), s0)
    s2_hi, s2_lo = two_prod(s0, s0)
    r_hi, r_lo = sub(ahi, alo, s2_hi, s2_lo)
    denom = torch.where(s0 == 0, torch.ones_like(s0), 2.0 * s0)
    corr = (r_hi + r_lo) / denom
    return quick_two_sum(s0, corr)


def from_f64(x64):
    """Split a host float64 array into an f32 (hi, lo) numpy pair."""
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


# 2*pi to double-float precision
_TWO_PI_64 = 2 * np.pi
_TWO_PI_HI = np.float32(_TWO_PI_64)
_TWO_PI_LO = np.float32(_TWO_PI_64 - np.float64(_TWO_PI_HI))

# 1/(2*pi) as a double-float constant
_INV_TWO_PI_64 = 1.0 / (2 * np.pi)
INV_TWO_PI_HI = np.float32(_INV_TWO_PI_64)
INV_TWO_PI_LO = np.float32(_INV_TWO_PI_64 - np.float64(INV_TWO_PI_HI))


def frac_cycles(m_hi, m_lo):
    """frac(m) in [-0.5, 0.5] cycles for dd m = phase/(2*pi), feeding
    :func:`sincos_cycles` so no further range reduction is needed."""
    n = torch.round(m_hi)
    f1 = m_hi - n          # exact
    n2 = torch.round(m_lo)
    f2 = m_lo - n2         # exact
    c = f1 + f2            # in [-1, 1]
    return c - torch.round(c)


# minimax-fitted polynomials for sin/cos of 2*pi*c on c in [-0.5, 0.5]
_SIN_C = (6.283183465409586, -41.34148025958734, 81.59765524711817,
          -76.59489967393306, 41.26979637356224, -12.37227202917199)
_COS_C = (0.999999443415578, -19.73903432200607, 64.93061147431378,
          -85.29594600637849, 58.91242234401467, -21.28277632550657)


def sincos_cycles(c):
    """(sin, cos) of 2*pi*c for c in [-0.5, 0.5] by degree-11/10
    polynomials (Horner; the coefficients round to c's dtype)."""
    c2 = c * c
    s = torch.full_like(c, _SIN_C[5])
    for k in (4, 3, 2, 1, 0):
        s = s * c2 + _SIN_C[k]
    s = s * c
    co = torch.full_like(c, _COS_C[5])
    for k in (4, 3, 2, 1, 0):
        co = co * c2 + _COS_C[k]
    return s, co


def frac_two_pi(m_hi, m_lo):
    """2*pi * frac(m) in [-2pi, 2pi] for dd m = phase/(2*pi): the integer
    parts of m_hi and m_lo are removed by exact f32 subtractions."""
    n = torch.round(m_hi)
    f1 = m_hi - n          # exact
    n2 = torch.round(m_lo)
    f2 = m_lo - n2         # exact
    f = f1 + f2
    return float(_TWO_PI_HI) * f + float(_TWO_PI_LO) * f


def selftest(a, b, c):
    """(7, n) rows two_sum(a, b), two_prod(a, b), frac_cycles(a, b) and
    sincos_cycles(c) of f32 tensors: on CUDA tensors by the
    ``csrc/dd_selftest.cu`` kernel (the device helpers of the Kirchhoff
    kernels), on CPU tensors by the functions above."""
    if a.device.type == 'cpu':
        return torch.stack([*two_sum(a, b), *two_prod(a, b),
                            frac_cycles(a, b), *sincos_cycles(c)])
    import ctypes
    from . import _cuda
    for t in (a, b, c):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.shape != a.shape or t.device != a.device:
            raise ValueError('dd selftest takes three contiguous f32 '
                             'tensors of one shape on one device')
    n = a.numel()
    out = torch.empty((7, n), dtype=torch.float32, device=a.device)
    fn = _cuda.entry('dd_selftest', 'dd_selftest_launch',
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] +
                     [ctypes.c_void_p] * 2)
    _cuda.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), n,
                   out.data_ptr(), _cuda.stream_ptr(a.device)),
                'dd_selftest')
    return out
