"""The cases of the toroid crystals' interaction kernel
(``csrc/crystal_interact.cu``, ``oes/crystal_interact.py``), shared by its
CPU test (``tests/test_torch_interact_kernel.py``) and its card tests
(``tests/test_torch_cuda.py``): the analyzer of
``beambench/configs/analyzer.json`` as each toroid crystal class, its
Si(444) crystal, beams at its surface, and the float64 path that the kernel
is held to.

The rays lie on the crystal and 2 mm beyond it, a fifth of them on facet
edges and in the gaps, and come from the analyzer's source point; their
energies are those of the speed test's three sources (a flat band, one
line, seven lines) and, for a third of them, energies on the Darwin curve
of the ray's own incidence (its flanks and its top).  A tenth start dead;
``rays_good`` then classifies them as ``_reflect_local`` does.

Float32 rays are held to the float64 path on the same numbers: the rays
widened, the float32 crystal's stored numbers (d, V, the f0 coefficients,
the f1 / f2 table), and the float32 facet decomposition
(``float32_facets``).  These are the crystal and the facets that the
float32 call computes with; another crystal or other facets move the
reflectivity on the Darwin edges of Si(444): d rounded to float32 (2.2e-8
relative) by up to 0.18 of the peak on 2e5 of these rays, the f0
coefficients rounded to float32 (3.8e-8) by 4.5e-7 of it there (half the
limit, and the largest grows with the rays sampled on the edges), and a
facet centre's float32 rounding, which tilts its normal by ~1e-8 rad, by
~1e-3.
"""
import contextlib
import copy
import json
import math
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from xrt_tpu_torch.beam import Beam
from xrt_tpu_torch.materials import CrystalDiamond
from xrt_tpu_torch.oes import (DicedJohannToroid, DicedJohanssonToroid,
                               GeneralBraggToroid, JohannToroid,
                               JohanssonToroid)
from xrt_tpu_torch.oes import crystal_interact
from xrt_tpu_torch.oes.base import OE
from xrt_tpu_torch.physconsts import CH
from xrt_tpu_torch.transforms import rotate_xyz

#: the plain ``OE._interact`` (a test may patch the class's)
PLAIN_INTERACT = OE._interact

ROOT = Path(__file__).resolve().parent.parent
ANALYZER = json.loads((ROOT / 'beambench' / 'configs' /
                       'analyzer.json').read_text())
CLASSES = {'johann': JohannToroid, 'johansson': JohanssonToroid,
           'general': GeneralBraggToroid,
           'diced_johann': DicedJohannToroid,
           'diced_johansson': DicedJohanssonToroid}
DTYPES = {'f32': torch.float32, 'f64': torch.float64}
THETA = math.radians(ANALYZER['theta_deg'])


def crystal(dtype, device='cpu', like=None):
    """The analyzer's Si(444) (``CrystalDiamond``) in *dtype*; with *like*
    (a crystal), its stored numbers: d, V, the f0 coefficients and the
    f1 / f2 table."""
    cr = ANALYZER['crystal']
    out = CrystalDiamond.create(hkl=tuple(cr['hkl']),
                                d=cr['d111'] / cr['hkl'][0],
                                elements=cr['element'], rho=cr['rho'],
                                name=cr['element'], dtype=dtype,
                                device=device)
    if like is None:
        return out
    el = copy.copy(out.elements[0])
    for k in ('f0coeffs', 'Etable', 'f1table', 'f2table'):
        setattr(el, k, getattr(like.elements[0], k).to(dtype))
    return out.replace(elements=(el,), **{
        k: torch.tensor(float(getattr(like, k)), dtype=dtype, device=device)
        for k in ('d', 'V')})


def element(cls, material=None):
    """The analyzer of speed test 1 as class *cls*: R, theta, facets,
    size (GeneralBraggToroid: Bragg planes of 2 R and 1.5 Rs)."""
    R = ANALYZER['R']
    fc, (dxc, dyc) = ANALYZER['facet'], ANALYZER['crystal_size']
    kw = dict(Rm=R, Rs=2.0 * R * math.sin(THETA) ** 2, pitch=THETA,
              center=(0, 2.0 * R * math.sin(THETA), 0), material=material,
              limPhysX=(-dxc / 2, dxc / 2), limPhysY=(-dyc / 2, dyc / 2))
    if cls.__name__.startswith('Diced'):
        kw.update(dxFacet=fc['dx'], dyFacet=fc['dy'], dxGap=fc['dx_gap'],
                  dyGap=fc['dy_gap'])
    if cls is GeneralBraggToroid:
        kw.update(RmBragg=2 * R, RsBragg=1.5 * kw['Rs'])
    return cls.create(**kw)


def _energies(cr64):
    """(E0, eMin, eMax, the line step) of the analyzer (configs/analyzer.py
    ``build``)."""
    d = float(cr64.d)
    dTheta = float(cr64.get_dtheta_symmetric_Bragg(
        CH / (2 * d * math.sin(THETA))))
    E0 = CH / (2 * d * math.sin(THETA + dTheta))
    flat = ANALYZER['e_axis_flat']
    return E0, E0 * (1 - flat), E0 * (1 + flat), \
        E0 * flat * ANALYZER['line_step']


def beam(oe, dtype, n=10000, seed=22, device='cpu'):
    """(local-frame beam at *oe*'s surface in *dtype*, goodN) as
    ``_reflect_local`` hands it to ``_interact``."""
    rng = np.random.RandomState(seed)
    oe64 = element(type(oe))
    cr64 = crystal(torch.float64)
    half = np.array(ANALYZER['crystal_size']) / 2 + 2.0
    x = rng.uniform(-half[0], half[0], n)
    y = rng.uniform(-half[1], half[1], n)
    fc = ANALYZER['facet']
    steps = (fc['dx'] + fc['dx_gap'], fc['dy'] + fc['dy_gap'])
    k = n // 5      # on facet edges, in the gaps and midway between facets
    for v, step, size in ((x, steps[0], fc['dx']), (y, steps[1], fc['dy'])):
        m = rng.randint(-20, 21, k) * step
        off = rng.choice([0.5, -0.5], k) * size + \
            rng.choice([0.0, 1e-6, -1e-6, 0.02], k)
        v[:k] = m + off
        v[:k // 10] = (rng.randint(-20, 20, k // 10) + 0.5) * step
    z = oe64.local_z(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    p = 2.0 * ANALYZER['R'] * math.sin(THETA)
    src = np.stack([rng.uniform(-0.05, 0.05, n),
                    -p * math.cos(THETA) + rng.uniform(-0.02, 0.02, n),
                    p * math.sin(THETA) + rng.uniform(-0.02, 0.02, n)])
    dr = np.stack([x, y, z]) - src
    dr /= np.sqrt((dr ** 2).sum(0))
    E0, eMin, eMax, dE = _energies(cr64)
    E = np.where(rng.rand(n) < 0.5, rng.uniform(eMin, eMax, n),
                 E0 + dE * rng.randint(-3, 4, n))
    # a third on the Darwin curve of the ray's own incidence
    nb = oe64.local_n(torch.from_numpy(x), torch.from_numpy(y))[:3]
    sinB = np.abs(sum(dr[q] * nb[q].numpy() for q in range(3)))
    EB = CH / (2 * float(cr64.d) * sinB)
    third = rng.rand(n) < 1 / 3
    E[third] = (EB * (1 + rng.uniform(-1e-5, 4e-5, n)))[third]
    Jss = rng.uniform(0.1, 1, n)
    Jpp = rng.uniform(0.1, 1, n)
    Jsp = np.sqrt(Jss * Jpp) * rng.uniform(0, 1, n) * \
        np.exp(1j * rng.uniform(0, 2 * np.pi, n))
    state = np.where(rng.rand(n) < 0.1, 0, 1).astype(np.int32)

    def T(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dtype).to(device)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    X, Y = T(x), T(y)
    st = oe.rays_good(X, Y, torch.from_numpy(state).to(device))
    lb = Beam(x=X, y=Y, z=T(z), a=T(dr[0]), b=T(dr[1]), c=T(dr[2]), E=T(E),
              state=st, path=T(np.zeros(n)), Jss=T(Jss), Jpp=T(Jpp),
              Jsp=torch.from_numpy(Jsp).to(cdt).to(device),
              theta=T(rng.uniform(-1, 1, n)))
    return lb, st == 1


def global_beam(oe, dtype, n=4000, device='cpu'):
    """The rays of :func:`beam` 100 mm before *oe*'s surface, in the global
    frame, all alive."""
    lb, _ = beam(oe, torch.float64, n=n, device=device)
    pitch = oe._placement()[0]
    seq = '-' + oe.rotationSequence
    x, y, z = rotate_xyz(lb.x - 100 * lb.a, lb.y - 100 * lb.b,
                         lb.z - 100 * lb.c, rotationSequence=seq,
                         pitch=pitch)
    a, b, c = rotate_xyz(lb.a, lb.b, lb.c, rotationSequence=seq,
                         pitch=pitch)
    cx, cy, cz = oe.center
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    return Beam(x=(x + cx).to(dtype), y=(y + cy).to(dtype),
                z=(z + cz).to(dtype), a=a.to(dtype), b=b.to(dtype),
                c=c.to(dtype), E=lb.E.to(dtype),
                state=torch.ones(n, dtype=torch.int32, device=device),
                path=torch.zeros(n, dtype=dtype, device=device),
                Jss=lb.Jss.to(dtype), Jpp=lb.Jpp.to(dtype),
                Jsp=lb.Jsp.to(cdt))


@contextlib.contextmanager
def plain_path():
    """``OE._interact`` without the kernel, on any device."""
    with mock.patch.object(crystal_interact, 'engages',
                           lambda *args: False):
        yield


def float32_facets(oe32):
    """``_facets`` of a float64 element that gives *oe32*'s float32
    facet decomposition of float32 numbers held in float64."""
    def facets(x, y):
        out = oe32._facets(x.to(torch.float32), y.to(torch.float32))
        return tuple(v.to(x.dtype) for v in out)
    return facets


def reference(oe, lb, goodN, material):
    """The float64 path of ``OE._interact`` for the beam *lb* on *oe* with
    *material*: on the same numbers for float32 rays (the element's float32
    facets, the crystal's stored numbers).  Returns (beam, rollAngle) in
    float64."""
    cr64 = material if material.d.dtype == torch.float64 else \
        crystal(torch.float64, lb.x.device, like=material)
    oe64 = oe.replace(material=cr64)
    if lb.x.dtype == torch.float32 and hasattr(oe, '_facets'):
        oe64 = oe64.replace(_facets=float32_facets(oe))
    lb64 = lb.replace(**{k: getattr(lb, k).to(torch.float64)
                         for k in ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'path',
                                   'Jss', 'Jpp', 'theta')
                         if getattr(lb, k) is not None},
                      Jsp=lb.Jsp.to(torch.complex128))
    roll = oe._placement()[1]
    with plain_path():
        return PLAIN_INTERACT(oe64, lb64, goodN, roll, True, None, cr64,
                              oe64.local_n)


def limits(dtype):
    """(a, b, c and theta in ulps of the float32 value or absolute in
    float64, J as a share of the float64 peak reflectivity)."""
    return (4, 1e-6) if dtype == torch.float32 else (1e-12, 1e-6)


DIRECTIONS = ('a', 'b', 'c', 'theta', 'rollAngle')
AMPLITUDES = ('Jss', 'Jpp', 'Jsp')


def errors(got, ref, goodN, dtype):
    """The largest errors {name: error} of the (beam, rollAngle) *got* of
    *dtype* against the float64 path's *ref*, in the units of
    :func:`limits`; a direction whose NaNs differ from *ref*'s is inf."""
    (g, groll), (r, rroll) = got, ref
    errs = {}
    for k in DIRECTIONS:
        gv, rv = ((groll, rroll) if k == 'rollAngle' else
                  (getattr(g, k), getattr(r, k)))
        gv, rv = gv.double(), rv.double()
        ok = ~torch.isnan(rv)
        err = (gv - rv).abs()
        if dtype == torch.float32:
            r32 = rv.to(torch.float32)
            err = err / torch.from_numpy(np.spacing(np.abs(
                r32.cpu().numpy()))).double().to(rv.device)
        errs[k] = float(err[ok].max()) if torch.equal(
            torch.isnan(gv), ~ok) else math.inf
    peak = float(r.Jss[goodN].max())
    for k in AMPLITUDES:
        gv, rv = getattr(g, k), getattr(r, k)
        errs[k] = float((gv.to(rv.dtype) - rv).abs().max()) / peak
    return errs


def compare(got, ref, goodN, dtype):
    """Hold the kernel's (beam, rollAngle) *got* to the float64 path's
    *ref*; returns the largest errors {name: error}."""
    lim, jlim = limits(dtype)
    errs = errors(got, ref, goodN, dtype)
    for k, err in errs.items():
        assert err <= (jlim if k in AMPLITUDES else lim), (k, err)
    return errs


def reflect_reference(oe, beam, material):
    """``oe.reflect(beam)`` with the plain ``_interact``; for float32 rays
    the float64 path's (:func:`reference`) rounded to float32."""
    dtype = beam.x.dtype
    if dtype == torch.float64:
        with plain_path():
            return oe.reflect(beam)

    def interact64(self, lb, goodN, roll, *args, **kw):
        out, roll64 = reference(self, lb, goodN, material)
        return lb.replace(**{k: getattr(out, k).to(getattr(lb, k).dtype)
                             for k in ('a', 'b', 'c', 'Jss', 'Jpp', 'Jsp')},
                          theta=out.theta.to(dtype)), roll64.to(dtype)
    with mock.patch.object(OE, '_interact', interact64):
        return oe.reflect(beam)


def compare_beams(ref, got, dtype):
    """Hold the (global, local) beams *got* of a reflect through the
    kernel to *ref*: the same states and positions, a, b, c and J to
    :func:`limits`."""
    lim, jlim = limits(dtype)
    for r, g in zip(ref, got):
        assert torch.equal(r.state, g.state)
        good = g.state == 1
        assert int(good.sum()) > g.x.numel() // 2
        for k in ('x', 'y', 'z', 'path'):
            assert torch.equal(getattr(r, k), getattr(g, k)), k
        for k in ('a', 'b', 'c'):
            rv, gv = getattr(r, k).double(), getattr(g, k).double()
            err = (gv - rv).abs()
            if dtype == torch.float32:
                err = err / torch.from_numpy(np.spacing(np.abs(
                    getattr(r, k).cpu().numpy()))).double().to(err.device)
            err = float(err.max())
            assert err <= lim, (k, err)
        peak = float(r.Jss[good].max())
        for k in ('Jss', 'Jpp', 'Jsp'):
            err = float((getattr(g, k) - getattr(r, k)).abs().max()) / peak
            assert err <= jlim, (k, err)
