"""Takagi-Taupin equations for bent perfect crystals.

Port of the reference package's ``materials/tt.py``.  The host side (the
elastic constants, the compliance rotation, the reciprocal vectors, the
isotropic and the anisotropic fixed-shape plate models and
``compute_tt_params(_full)``) is float64 numpy, copied.  The device side,
``tt_amplitudes``, integrates the Takagi-Taupin equations with the
reference's fixed-step Lawson (integrating-factor) RK4 over the depth,
on the stacked (2 polarizations, N rays) complex tensors: the linear phase
of the Riccati equation is absorbed exactly in each step, which keeps a
thick bent crystal stable at any step size.  The reference's scan over the
steps is a Python loop that keeps only the carry; every step is a few
dozen element-wise launches (about 40), so one evaluation at the default
4000 steps is ~160k launches whatever the ray count below ~1e6.  The rays
outside the estimated reflectivity window (``autoLimits``) get zero
amplitude.  Everything is torch, so autograd differentiates the amplitudes
with respect to the deformation parameters (1/R, c1, c2) given as
tensors.

Units follow the reference: depths in um, wavevectors in 1/um.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..physconsts import CH, PI2
from .crystal import _over

# ---------------------------------------------------------------------------
# elastic constants (GPa*100 = 10^11 Pa), the published values pyTTE
# collects
CRYSTAL_ELASTIC = {
    'Ge': {'system': 'cubic', 'C11': 1.2835, 'C12': 0.4823, 'C44': 0.6666},
    'Si': {'system': 'cubic', 'C11': 1.6578, 'C12': 0.6394, 'C44': 0.7962},
    'Diamond': {'system': 'cubic', 'C11': 10.79, 'C12': 1.24, 'C44': 5.78},
    'GaAs': {'system': 'cubic', 'C11': 1.1877, 'C12': 0.5372,
             'C44': 0.5944},
    'InSb': {'system': 'cubic', 'C11': 0.6669, 'C12': 0.3645,
             'C44': 0.3020},
    'LiF': {'system': 'cubic', 'C11': 1.1397, 'C12': 0.4767, 'C44': 0.6364},
    'Copper': {'system': 'cubic', 'C11': 1.683, 'C12': 1.221, 'C44': 0.757},
    'Sapphire': {'system': 'trigonal', 'C11': 4.9735, 'C12': 1.6397,
                 'C13': 1.1220, 'C14': -0.2358, 'C33': 4.9911,
                 'C44': 1.4739},
}


def elastic_matrices(name):
    """(C, S) stiffness/compliance 6x6 Voigt matrices
    (elastic_tensors.py:267-345)."""
    d = CRYSTAL_ELASTIC[name]
    C = np.zeros((6, 6))
    if d['system'] == 'cubic':
        C11, C12, C44 = d['C11'], d['C12'], d['C44']
        C[:3, :3] = C12
        for i in range(3):
            C[i, i] = C11
        for i in range(3, 6):
            C[i, i] = C44
    elif d['system'] == 'trigonal':
        C11, C12, C13, C14 = d['C11'], d['C12'], d['C13'], d['C14']
        C33, C44 = d['C33'], d['C44']
        C[0, 0] = C[1, 1] = C11
        C[0, 1] = C[1, 0] = C12
        C[0, 2] = C[2, 0] = C[1, 2] = C[2, 1] = C13
        C[2, 2] = C33
        C[3, 3] = C[4, 4] = C44
        C[5, 5] = (C11 - C12) / 2
        C[0, 3] = C[3, 0] = C14
        C[1, 3] = C[3, 1] = -C14
        C[4, 5] = C[5, 4] = C14
    else:
        raise NotImplementedError(
            f"crystal system {d['system']} not supported yet")
    return C, np.linalg.inv(C)


_VOIGT = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]


def _s_matrix_to_tensor(S):
    """Voigt compliance 6x6 -> 3x3x3x3 with the standard factors of 2/4."""
    T = np.zeros((3, 3, 3, 3))
    for m, (i, j) in enumerate(_VOIGT):
        for n, (k, l) in enumerate(_VOIGT):
            f = (1.0 if m < 3 else 2.0) * (1.0 if n < 3 else 2.0)
            v = S[m, n] / f
            for (a, b) in {(i, j), (j, i)}:
                for (c, d) in {(k, l), (l, k)}:
                    T[a, b, c, d] = v
    return T


def _s_tensor_to_matrix(T):
    S = np.zeros((6, 6))
    for m, (i, j) in enumerate(_VOIGT):
        for n, (k, l) in enumerate(_VOIGT):
            f = (1.0 if m < 3 else 2.0) * (1.0 if n < 3 else 2.0)
            S[m, n] = T[i, j, k, l] * f
    return S


def rotate_compliance(S, R):
    """S'_ijkl = R_ia R_jb R_kc R_ld S_abcd (elastic_tensors.py:348-383)."""
    T = _s_matrix_to_tensor(S)
    T = np.einsum('ia,jb,kc,ld,abcd->ijkl', R, R, R, R, T)
    return _s_tensor_to_matrix(T)


def axis_angle(u, th):
    """Rotation matrix about axis *u* by *th* rad, counterclockwise
    (rotation_matrix.py:5-36)."""
    u = np.asarray(u, float)
    u = u / np.linalg.norm(u)
    c, s = math.cos(th), math.sin(th)
    ux, uy, uz = u
    return np.array([
        [c + ux*ux*(1-c), ux*uy*(1-c) - uz*s, ux*uz*(1-c) + uy*s],
        [ux*uy*(1-c) + uz*s, c + uy*uy*(1-c), uy*uz*(1-c) - ux*s],
        [ux*uz*(1-c) - uy*s, uy*uz*(1-c) + ux*s, c + uz*uz*(1-c)]])


def align_vector_with_z(h):
    """Rotation aligning *h* with +z (rotation_matrix.py:38-73)."""
    h = np.asarray(h, float)
    if h[0] or h[1]:
        u = np.array([h[1], -h[0], 0.0])
        th = math.acos(h[2] / np.linalg.norm(h))
        return axis_angle(u, th)
    if h[2] > 0:
        return np.eye(3)
    return axis_angle([0, -1, 0], math.pi)


def reciprocal_vectors(a, b, c, alpha=90.0, beta=90.0, gamma=90.0):
    """Reciprocal primitive vectors as columns, 1/A
    (crystal_vectors.py:5-58)."""
    al, be, ga = map(math.radians, (alpha, beta, gamma))
    a1 = a * np.array([1.0, 0.0, 0.0])
    a2 = b * np.array([math.cos(ga), math.sin(ga), 0.0])
    aux1 = math.cos(be) * math.sin(ga)
    aux2 = math.cos(al) - math.cos(be) * math.cos(ga)
    aux3 = math.sqrt(math.sin(ga)**2 - math.cos(al)**2 - math.cos(be)**2 -
                     2 * math.cos(al) * math.cos(be) * math.cos(ga))
    a3 = c / math.sin(ga) * np.array([aux1, aux2, aux3])
    V = np.dot(np.cross(a1, a2), a3)
    b1 = 2 * np.pi * np.cross(a2, a3) / V
    b2 = 2 * np.pi * np.cross(a3, a1) / V
    b3 = 2 * np.pi * np.cross(a1, a2) / V
    return np.stack([b1, b2, b3], axis=1)


def isotropic_plate_params(R1_um, R2_um, nu):
    """(c1, c2, invR1) of the isotropic displacement jacobian
    (deformation.py:7-95)."""
    return isotropic_plate_params_full(R1_um, R2_um, nu)[:3]


def isotropic_plate_params_full(R1_um, R2_um, nu):
    """Full 5-list [coef1, coef2, invR1, coef3, invR2] = djparams
    (deformation.py:95)."""
    invR1 = 0.0 if math.isinf(R1_um) else 1.0 / R1_um
    invR2 = 0.0 if math.isinf(R2_um) else 1.0 / R2_um
    return (nu / (1 - nu) * (invR1 + invR2), 0.0, invR1, 0.0, invR2)


def anisotropic_fixed_shape_params(R1_um, R2_um, S, thickness_um):
    """(c1, c2, invR1) for an anisotropic plate bent to a fixed shape
    (deformation.py:200-300).  *S* is the rotated compliance matrix."""
    invR1 = 0.0 if math.isinf(R1_um) else 1.0 / R1_um
    invR2 = 0.0 if math.isinf(R2_um) else 1.0 / R2_um
    meps = np.finfo(float).eps
    if abs(S[5, 0]) < meps and abs(S[5, 1]) < meps and \
            abs(S[1, 1] - S[0, 0]) < meps and \
            abs(S[0, 0] + S[1, 1] - 2 * S[0, 1] - S[5, 5]) < meps:
        alpha = 0.0
    else:
        Aa = S[5, 5] * (S[0, 0] + S[1, 1] + 2*S[0, 1]) - \
            (S[5, 0] + S[5, 1]) ** 2
        Ba = 2 * (S[5, 1] * (S[0, 1] + S[0, 0]) -
                  S[5, 0] * (S[0, 1] + S[1, 1]))
        Ca = S[5, 5] * (S[1, 1] - S[0, 0]) + S[5, 0]**2 - S[5, 1]**2
        Da = 2 * (S[5, 1] * (S[0, 1] - S[0, 0]) +
                  S[5, 0] * (S[0, 1] - S[1, 1]))
        num = Da * (invR2 + invR1) - Ba * (invR2 - invR1)
        den = Aa * (invR2 - invR1) - Ca * (invR2 + invR1)
        # for transversely isotropic cuts (e.g. Si 111) both arguments are
        # machine noise and atan2 returns an arbitrary angle (the reference
        # suffers the same); pin alpha to 0 there for determinism
        scale = np.abs(S).max() ** 2 * (abs(invR1) + abs(invR2))
        if math.hypot(num, den) < 1e-9 * scale:
            alpha = 0.0
        else:
            alpha = 0.5 * math.atan2(num, den)
    # NOTE: the reference feeds the radian-valued alpha into a
    # degrees-expecting rotation (deformation.py:266 -> inplane_rotation),
    # so the compliance pre-rotation is by alpha*pi/180 while cos(2*alpha)
    # below uses alpha in radians.  We reproduce that behavior exactly to
    # match the reference's published bent-crystal curves.
    Sp = rotate_compliance(S, axis_angle([0, 0, 1], math.radians(alpha)))
    m_div = 2 * (Sp[0, 0] * Sp[1, 1] - Sp[0, 1] * Sp[0, 1])
    mx = ((Sp[0, 1] - Sp[1, 1]) * (invR2 + invR1) +
          (Sp[0, 1] + Sp[1, 1]) * (invR2 - invR1) *
          math.cos(2 * alpha)) / m_div
    my = ((Sp[0, 1] - Sp[0, 0]) * (invR2 + invR1) -
          (Sp[0, 1] + Sp[0, 0]) * (invR2 - invR1) *
          math.cos(2 * alpha)) / m_div
    coef1 = Sp[2, 0] * mx + Sp[2, 1] * my
    coef2 = ((Sp[4, 0] * mx + Sp[4, 1] * my) * math.cos(alpha) -
             (Sp[3, 0] * mx + Sp[3, 1] * my) * math.sin(alpha))
    coef3 = ((Sp[4, 0] * mx + Sp[4, 1] * my) * math.sin(alpha) +
             (Sp[3, 0] * mx + Sp[3, 1] * my) * math.cos(alpha))
    return coef1, coef2, invR1, coef3, invR2


def compute_tt_params(crystal, alphaAsym=None, Rm=None, Rs=None,
                      inPlaneRotation=0.0):
    """(c1, c2, invR1) in 1/um — the subset used by the TT integration."""
    return compute_tt_params_full(crystal, alphaAsym, Rm, Rs,
                                  inPlaneRotation)[:3]


def compute_tt_params_full(crystal, alphaAsym=None, Rm=None, Rs=None,
                           inPlaneRotation=0.0):
    """Full djparams [coef1, coef2, invR1, coef3, invR2] in 1/um for
    *crystal* bent to meridional Rm and sagittal Rs [mm]
    (set_OE_properties, crystal.py:636-688 + ttcrystal.py:775-841).  Uses
    the crystal's ``nu`` (isotropic) if set, else the anisotropic
    fixed-shape model with the crystal's elastic constants looked up by
    name."""
    geotag = 0.0 if crystal.geom.startswith('B') else 0.5 * math.pi
    phi = (0.0 if alphaAsym is None else float(alphaAsym)) + geotag
    t_mm = 1.0 if crystal.t is None else float(crystal.t)
    t_um = t_mm * 1e3
    Rm_um = float(Rm) * 1e3 if Rm not in (None,) and np.isfinite(Rm) \
        else math.inf
    Rs_um = float(Rs) * 1e3 if Rs not in (None,) and np.isfinite(Rs) \
        else math.inf
    nu = getattr(crystal, 'nu', None)
    if nu is not None:
        return isotropic_plate_params_full(Rm_um, Rs_um, float(nu))
    # anisotropic: rotate the compliance matrix into the OE frame
    name = crystal.name or 'Si'
    if name not in CRYSTAL_ELASTIC:
        raise ValueError(
            f"no elastic constants for '{name}'; set nu= for the isotropic "
            'model')
    _, S = elastic_matrices(name)
    if hasattr(crystal, 'get_a'):
        a = b = c = float(crystal.get_a())
        ang = (90.0, 90.0, 90.0)
    elif hasattr(crystal, 'a') and crystal.a is not None:
        a = float(crystal.a)
        b = float(crystal.b_ or a)
        c = float(crystal.c or a)
        ang = (float(getattr(crystal, 'alpha', 90.0) or 90.0),
               float(getattr(crystal, 'beta', 90.0) or 90.0),
               float(getattr(crystal, 'gamma', 90.0) or 90.0))
    else:
        # d-spacing-only crystal: cubic assumption (crystal.py:210)
        sqrthkl2 = math.sqrt(sum(i ** 2 for i in crystal.hkl))
        a = b = c = float(crystal.d) * sqrthkl2
        ang = (90.0, 90.0, 90.0)
    B = reciprocal_vectors(a, b, c, *ang)
    hvec = B @ np.asarray(crystal.hkl, float)
    R1 = align_vector_with_z(hvec)
    R2 = axis_angle([0, 0, 1], float(inPlaneRotation))
    R3 = axis_angle([0, 1, 0], phi)
    Rmat = R3 @ R2 @ R1
    S_rot = rotate_compliance(S, Rmat)
    return anisotropic_fixed_shape_params(Rm_um, Rs_um, S_rot, t_um)


# ---------------------------------------------------------------------------
# device side: the Lawson RK4 of the Takagi-Taupin equations
#
# xi' = i [(strain0 + cz0t zfrac) xi + cbt xi^2 + cht] is a Riccati
# equation whose linear term grows as strain t^2 for a thick bent crystal;
# a plain RK4 explodes once dz |c0s| passes its imaginary stability bound.
# With xi = eta e^{i Psi(tau)}, Psi(tau) = c0s(z_n) tau + cz0t tau^2 / 2,
# the step integrates eta' = i (cbt eta^2 e^{i Psi} + cht e^{-i Psi}),
# which has no linear term.  The Laue case couples the transport
# d0' = -i (g0t + cbt xi) d0, non-stiff, in plain RK4 form.


def _expi(z):
    """exp(i z) of a complex tensor, in two launches (``crystal._expi``
    builds i z from the parts, one more launch in a loop of ~46 a step)."""
    return torch.exp(z * 1j)


def _bragg_lawson_step(xi, zf, dz, strain0, cz0t, cbt, cht, czh, czf):
    """One step of the Bragg Riccati from zfrac = *zf* to zf + dz; *czh*,
    *czf* are cz0t dz^2 / 8 and cz0t dz^2 / 2, the same for every step."""
    c0s = strain0 + cz0t * zf
    eh = _expi(c0s * (0.5 * dz) + czh)
    ef = _expi(c0s * dz + czf)

    def g(eta, e):
        return (cbt * eta * eta * e + cht / e) * 1j

    k1 = (cbt * xi * xi + cht) * 1j
    k2 = g(xi + 0.5 * dz * k1, eh)
    k3 = g(xi + 0.5 * dz * k2, eh)
    k4 = g(xi + dz * k3, ef)
    return (xi + dz / 6 * (k1 + 2 * k2 + 2 * k3 + k4)) * ef


def _laue_lawson_step(xi, d0, zf, dz, strain0, cz0t, cbt, cht, g0t, czh,
                      czf):
    """One step of the coupled Laue system from zfrac = *zf* to zf - dz
    (downward); *czh*, *czf* as in the Bragg step."""
    c0s = strain0 + cz0t * zf
    eh = _expi(c0s * (-0.5 * dz) + czh)
    ef = _expi(c0s * (-dz) + czf)

    def g(eta, d, e):
        deta = (cbt * eta * eta * e + cht / e) * 1j
        dd = ((g0t + cbt * (eta * e)) * d) * -1j
        return deta, dd

    k1 = ((cbt * xi * xi + cht) * 1j, ((g0t + cbt * xi) * d0) * -1j)
    k2 = g(xi - 0.5 * dz * k1[0], d0 - 0.5 * dz * k1[1], eh)
    k3 = g(xi - 0.5 * dz * k2[0], d0 - 0.5 * dz * k2[1], eh)
    k4 = g(xi - dz * k3[0], d0 - dz * k3[1], ef)
    eta = xi - dz / 6 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
    d0 = d0 - dz / 6 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
    return eta * ef, d0


def tt_amplitudes(E, beamInDotNormal, beamOutDotNormal, beamInDotHNormal,
                  crystal, c1, c2, invR1, alphaAsym=None, nsteps=4000,
                  autoLimits=True, limExtendFactor=None):
    """Bent-crystal complex amplitudes (curveS, curveP) by the fixed-step
    Lawson RK4 over *nsteps* steps through the depth, both polarizations
    at once.  *c1, c2, invR1*: the deformation parameters in 1/um from
    :func:`compute_tt_params` (numbers, or tensors to differentiate).
    With *autoLimits* the rays outside the estimated reflectivity window
    (the reference's ``estimate_bent_width``, widened by
    *limExtendFactor*: 3 for an unbent crystal, else 1.5) get zero
    amplitude.  Bragg-transmitted geometry falls back to the two-beam
    amplitudes."""
    if beamOutDotNormal is None:
        beamOutDotNormal = -beamInDotNormal
    if beamInDotHNormal is None:
        beamInDotHNormal = beamInDotNormal
    geom = crystal.geom
    isLaue = geom.startswith('L')
    transmitted = geom.endswith('transmitted')
    if not isLaue and transmitted:
        return crystal.get_amplitude(E, beamInDotNormal, beamOutDotNormal,
                                     beamInDotHNormal)
    geotag = 0.0 if not isLaue else 0.5 * math.pi
    phi = (0.0 if alphaAsym is None else alphaAsym) + geotag
    t_um = (1.0 if crystal.t is None else crystal.t) * 1e3

    crystd = crystal.d
    h = _over(PI2, crystd)                  # 1/A
    h_um = h * 1e4                          # 1/um
    waveLength = _over(CH, E)               # A
    k = _over(PI2, waveLength)              # 1/A
    thetaB = crystal.get_Bragg_angle(E)
    _, _, _, chi0, chih, chih_ = crystal.get_F_chi(E, 0.5 / crystd)

    beta = torch.abs(beamInDotHNormal) - 0.5 * h / k
    c0 = 0.5e4 * k * chi0 * (_over(-1.0, beamInDotNormal) +
                             _over(1.0, beamOutDotNormal))
    ch = 0.5e4 * k * chih / beamOutDotNormal
    cb = -0.5e4 * k * chih_ / beamInDotNormal
    g0 = -0.5e4 * k * chi0 / beamInDotNormal

    theta = torch.arcsin(torch.clamp(torch.abs(beamInDotHNormal), 0.0, 1.0))
    alpha0 = theta + phi
    alphah = theta - phi
    phi_t = phi if isinstance(phi, torch.Tensor) else \
        config.scalar(phi, E.dtype, E.device)
    sin_p, cos_p = torch.sin(phi_t), torch.cos(phi_t)
    sin_a0, cos_a0 = torch.sin(alpha0), torch.cos(alpha0)
    sin_ah, cos_ah = torch.sin(alphah), torch.cos(alphah)
    a0zero = sin_a0 == 0
    cot_a0 = torch.where(a0zero, torch.zeros_like(cos_a0),
                         cos_a0 / torch.where(a0zero,
                                              torch.ones_like(sin_a0),
                                              sin_a0))
    scap0 = sin_p * cos_ah
    scap1 = sin_p * sin_ah
    scap2 = cos_p * cos_ah
    scap3 = cos_p * sin_ah
    hgh = h_um / beamOutDotNormal
    cz1 = scap1 * c2 - scap0 * invR1 + scap3 * c1
    cz0 = hgh * (cz1 + invR1 * cot_a0 * (scap1 - scap2))
    strain_z0 = c0 + hgh * beta
    Cpol = torch.cos(2 * thetaB)

    # polarizations along axis 0: (sigma, pi)
    polf = torch.stack([torch.ones_like(Cpol), Cpol])
    cbt = cb[None, :] * polf * t_um
    cht = ch[None, :] * polf * t_um
    strain0t = (strain_z0 * t_um)[None, :] + torch.zeros_like(cbt)
    cz0t = (cz0 * t_um * t_um)[None, :]     # the coefficient of z / t
    g0t = (g0 * t_um)[None, :] + torch.zeros_like(cbt)

    dz = 1.0 / nsteps
    czh = cz0t * (0.125 * dz * dz)
    czf = cz0t * (0.5 * dz * dz)
    if isLaue:
        # z from 0 down to -t: zfrac from 0 to -1
        xi = torch.zeros_like(cbt)
        d0 = torch.ones_like(cbt)
        for i in range(nsteps):
            xi, d0 = _laue_lawson_step(xi, d0, -i * dz, dz, strain0t, cz0t,
                                       cbt, cht, g0t, czh, czf)
        amp = d0 if transmitted else xi * d0
    else:
        # z from -t up to 0: zfrac from -1 to 0
        xi = torch.zeros_like(cbt)
        for i in range(nsteps):
            xi = _bragg_lawson_step(xi, -1.0 + i * dz, dz, strain0t, cz0t,
                                    cbt, cht, czh, czf)
        amp = xi

    if not transmitted:
        amp = amp * sqrt_rn(torch.abs(beamOutDotNormal) /
                            torch.abs(beamInDotNormal))[None, :]
    amp = torch.where(torch.isnan(torch.abs(amp)), torch.zeros_like(amp),
                      amp)

    if autoLimits:
        # the reference's estimate_bent_width, vectorized over the rays
        chcb = sqrt_rn(torch.abs(chih * chih_))
        gamma_term = torch.sin(theta - phi) / torch.sin(theta + phi)
        k_bragg = 0.5 * h / torch.abs(beamInDotHNormal)
        b_const = -0.5 * k_bragg * (1 + gamma_term) * chi0.real * 1e4
        zs = torch.as_tensor(np.linspace(-t_um, 0.0, 101), dtype=E.dtype,
                             device=E.device)
        xR1 = -zs[None, :] * invR1 * cot_a0[:, None]
        duh = zs[None, :] * cz1[:, None] + xR1 * (scap2 - scap1)[:, None]
        deform = h_um * duh
        def_min = torch.amin(deform, dim=1)
        def_max = torch.amax(deform, dim=1)
        sin2tb = torch.sin(2 * thetaB)
        costb = torch.cos(thetaB)
        dwt = torch.where(sin2tb > sqrt_rn(2 * chcb),
                          2 * chcb * h_um * costb / sin2tb,
                          sqrt_rn(2 * chcb) * h_um * costb)
        beta_min = b_const - def_max - 2 * dwt
        beta_max = b_const - def_min + 2 * dwt
        sintb = torch.sin(thetaB)
        sinthmin = sintb + beta_min / h_um
        sinthmax = torch.clamp(sintb + beta_max / h_um, max=1.0)
        thmin = torch.arcsin(torch.clamp(sinthmin, -1.0, 1.0)) - thetaB
        thmax = torch.arcsin(sinthmax) - thetaB
        ext = limExtendFactor
        if ext is None:
            unbent = all(float(v) == 0 for v in (invR1, c1, c2))
            ext = 3.0 if unbent else 1.5
        tmid = 0.5 * (thmax + thmin)
        thw = 0.5 * (thmax - thmin)
        dtheta = theta - thetaB
        inside = (dtheta > tmid - ext * thw) & (dtheta < tmid + ext * thw)
        amp = torch.where(inside[None, :], amp, torch.zeros_like(amp))
    return amp[0], amp[1]
