"""The toroid crystals' physics at the surface in one CUDA kernel.

``OE._interact`` asks :func:`engages` whether a call can go to
``csrc/crystal_interact.cu`` and then calls :func:`interact` in place of
its own element-wise steps.  The kernel runs those steps for a thick
Bragg-reflecting crystal (``csrc/crystal_interact.cuh``): the normals of
``local_n``, the incidence, the grating vector of the Bragg planes and the
deflection through it, the roll of the coherency matrix into the surface's
s / p frame, f1 + i f2 from the element's table, the structure factors,
susceptibilities and Bragg angle, the two-beam amplitudes for s and p, and
the new coherency matrix, one ray a thread in registers, with no host read
and no temporaries.  Everything past a diced element's facet index is
computed in double and rounded once to the rays' dtype, so on a card a
float32 beam gets the float64 path's directions and amplitudes (ROADMAP
C10's flanks do not arise there).

It implements the normals that the toroid crystal classes declare in
``kernel_kind`` (``base.kernel_kind``, the surfaces of
``toroid_search``): ``JohannToroid``, ``JohanssonToroid`` and
``GeneralBraggToroid``, ``DicedJohannToroid`` and ``DicedJohanssonToroid``
(the facet centre's normal, the latter's delta normal), with no asymmetry
angle; and the
crystals ``CrystalFcc`` / ``CrystalDiamond`` (``CrystalSi``) of one element
in 'Bragg reflected' geometry with no thickness, mosaicity, Takagi-Taupin
or volumetric diffraction.  Everything else keeps the element-wise path:
mirrors, gratings, multilayers, the DCM's flat crystals, Laue, mosaic and
bent crystals, ``CrystalFromCell``, a replaced ``local_n=``, a figure
error, a beam with wave amplitudes (``Es``), a roll given as a tensor, a
call autograd would record, and rays on the CPU.

The crystal's constants (d, chiToF, factDW, Z, f0 at 0.5 / d, the diamond
factor: of a float32 crystal, derived in double from its stored numbers)
are read to the host once per material and kept, with its element's table
in double on the card, until one of the tensors they came from is
replaced.  While the profiler traces, ``OE._interact`` counts
``interact.calls`` on every call and ``interact.fused`` on every call this
kernel serves.
"""
from __future__ import annotations

import collections
import copy
import ctypes
import math
import weakref

import torch

from .. import config
from ..materials import crystal as _crystal
from ..materials.element import Element
from ..ops import _cuda
from ..physconsts import CH, PI, PI2
from . import base

#: kernel launches by dtype (``LAUNCHES.clear()`` before a run, read after)
LAUNCHES: collections.Counter = collections.Counter()

#: the Bragg-plane normals of csrc/crystal_interact.cuh (xci::Center)
JOHANN, JOHANSSON, GENERAL = 0, 1, 2

#: the numbers of a call, in csrc/crystal_interact.cuh's order (xci::Num)
NUMBERS = ('Rm', 'Rs', 'Rm2', 'RmB', 'RsB', 'RmB2', 'dx', 'dxGap', 'dy',
           'dyGap', 'roll', 'CH', 'PI2', 'd', 'chiToF', 'factDW', 'Z', 'f0',
           'F0factor', 'djRe', 'djIm')
#: the most blocks of the incidences' sum (csrc/crystal_interact.cu), and
#: its scratch (``_cuda.scratch``): the blocks' partials, the sum and the
#: ticket that tells the last block
SUM_BLOCKS = 1024
SCRATCH = SUM_BLOCKS + 2

_P = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P]

#: {crystal: ((ids of what its constants were read from, those objects),
#: (numbers, tables))}
_CONSTANTS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

#: the normals of each ``kernel_kind`` of ``oes/bragg.py``: (centre,
#: diced, delta)
NORMALS = {'johann': (JOHANN, False, False),
           'johansson': (JOHANSSON, False, False),
           'general': (GENERAL, False, False),
           'diced_johann': (JOHANN, True, False),
           'diced_johansson': (JOHANSSON, True, True)}


def _fn(obj, name):
    """The function behind *obj*'s method *name* (None for one that an
    instance replaces), for the crystal's and the deflection's own."""
    return getattr(getattr(obj, name, None), '__func__', None)


def normal_kind(oe, local_n=None):
    """(centre, diced, delta) of *oe*'s ``local_n`` as the kernel computes
    it, or None: *oe*'s ``base.kernel_kind`` (the functions it calls are
    the ones the kernel implements), no asymmetry angle, no figure error,
    its radii Python numbers, and *local_n* (the function ``_interact``
    was given) *oe*'s own."""
    name = base.kernel_kind(oe)
    kind = NORMALS.get(name)
    radii = ('Rm', 'Rs', 'RmBragg', 'RsBragg') if name == 'general' else \
        ('Rm', 'Rs')
    if kind is None or (local_n is not None and not (
            getattr(local_n, '__self__', None) is oe and
            getattr(local_n, '__func__', None) is type(oe).local_n)) or \
            getattr(oe, 'alpha', None) is not None or \
            getattr(oe, 'figure_error', None) is not None or \
            not all(isinstance(getattr(oe, r, None), float) for r in radii):
        return None
    return kind


def _crystal_ok(mat):
    """Whether *mat* is a crystal whose amplitudes the kernel computes: a
    thick 'Bragg reflected' CrystalFcc / CrystalDiamond of one element, its
    amplitude functions the classes' own."""
    if not isinstance(mat, _crystal.Crystal):
        return False
    cm = _crystal._CrystalMethods
    own = (('get_amplitude', cm.get_amplitude), ('get_F_chi', cm.get_F_chi),
           ('get_Bragg_angle', cm.get_Bragg_angle),
           ('get_sin_Bragg_angle', cm.get_sin_Bragg_angle))
    return (mat.geom.startswith('Bragg') and
            not mat.geom.endswith('transmitted') and mat.t is None and
            mat.mosaicity is None and not mat.useTT and
            not mat.volumetricDiffraction and
            not getattr(mat, 'needsSpatialAmplitude', False) and
            len(mat.elements) == 1 and
            _fn(mat, 'get_structure_factor') in (
                _crystal.CrystalFcc.get_structure_factor,
                _crystal.CrystalDiamond.get_structure_factor) and
            all(_fn(mat, name) is f for name, f in own) and
            type(mat).chiToF is cm.chiToF and
            all(_fn(mat.elements[0], name) is getattr(Element, name)
                for name in ('get_f1f2', 'get_f0')) and
            all(isinstance(getattr(mat, k), torch.Tensor)
                for k in ('d', 'V', 'factDW')))


def _crystal_tensors(mat):
    el = mat.elements[0]
    return (mat.d, mat.V, mat.factDW, el.Etable, el.f1table, el.f2table,
            el.f0coeffs)


def _ray_tensors(lb):
    return tuple(v for v in (lb.x, lb.y, lb.a, lb.b, lb.c, lb.E, lb.Jss,
                             lb.Jpp, lb.Jsp, lb.theta) if v is not None)


def engages(oe, lb, local_n, mat, kind, roll):
    """Whether ``OE._interact`` runs the beam *lb* (local frame) on *oe*
    with the material *mat* of the resolved *kind* in the kernel: rays on a
    card that :func:`handles`."""
    return lb.x.device.type == 'cuda' and \
        handles(oe, lb, local_n, mat, kind, roll)


def handles(oe, lb, local_n, mat, kind, roll):
    """Whether the kernel computes the call, wherever the rays lie: rays of
    float32 or float64 with no wave amplitudes, *oe*'s own normal of a
    kind the kernel implements (:func:`normal_kind`), a crystal of
    :func:`_crystal_ok`, a Python number *roll*, and nothing autograd would
    record."""
    x = lb.x
    if (x.dtype not in (torch.float32, torch.float64) or
            lb.Es is not None or kind != 'crystal' or
            not isinstance(roll, (int, float)) or not _crystal_ok(mat) or
            _fn(oe, '_grating_deflection') is not
            base.OE._grating_deflection or
            normal_kind(oe, local_n) is None):
        return False
    rays = _ray_tensors(lb)
    if any(v.shape != x.shape or v.device != x.device for v in rays) or \
            any(v.dtype != x.dtype for v in rays if v is not lb.Jsp) or \
            lb.Jsp.dtype != config.cdtype(x.dtype):
        return False
    return not (torch.is_grad_enabled() and any(
        v.requires_grad for v in rays + _crystal_tensors(mat)))


def _constants(mat, device):
    """(numbers of the crystal by name, [E, f1, f2] tables in double on
    *device*): its stored d, V, factDW, f0 coefficients and tables widened
    to double, chiToF and f0 at 0.5 / d derived from them by the crystal's
    own code in double.  Read once per material and device, and again only
    when a tensor they come from is replaced."""
    sources = _crystal_tensors(mat) + (mat.elements[0], mat.hkl,
                                       type(mat))
    key = (tuple(id(s) for s in sources), device)
    hit = _CONSTANTS.get(mat)
    if hit is not None and hit[0][0] == key:
        return hit[1]
    # the crystal's stored parameters in double, and what the crystal's own
    # code derives from them there
    el = copy.copy(mat.elements[0])
    el.f0coeffs = el.f0coeffs.detach().to(torch.float64)
    m64 = copy.copy(mat)
    m64.d, m64.V, m64.factDW = (getattr(mat, k).detach().to(torch.float64)
                                for k in ('d', 'V', 'factDW'))
    diamond = _fn(mat, 'get_structure_factor') is \
        _crystal.CrystalDiamond.get_structure_factor
    residue = sum(i % 2 for i in mat.hkl)
    allowed = residue in (0, 3)
    s = 0.5 * PI * sum(mat.hkl)
    nums = dict(d=float(m64.d), chiToF=float(m64.chiToF),
                factDW=float(m64.factDW), Z=float(el.Z),
                f0=float(el.get_f0(0.5 / m64.d)) if allowed else 0.0,
                F0factor=2.0 if diamond else 1.0,
                djRe=1 + math.cos(s) if diamond else 1.0,
                djIm=math.sin(s) if diamond else 0.0,
                allowed=int(allowed))
    tables = [t.detach().to(device=device, dtype=torch.float64).contiguous()
              for t in (el.Etable, el.f1table, el.f2table)]
    value = (nums, tables)
    # the sources stay referenced, so that no other object takes their ids
    _CONSTANTS[mat] = ((key, sources), value)
    return value


def _launch(args, device):
    """Launch the kernels with the C arguments *args* on *device*'s current
    stream."""
    _cuda.launch('crystal_interact', 'crystal_interact_launch', _ARGTYPES,
                 device, *args)


def interact(oe, lb, goodN, roll, mat):
    """``OE._interact(lb, goodN, roll, ..., mat)`` for a call
    :func:`engages` accepts, in two launches: (the beam with a, b, c,
    theta, Jss, Jpp and Jsp updated, rollAngle)."""
    centre, diced, delta = normal_kind(oe)
    x = lb.x
    dev, shape = x.device, x.shape
    nums, tables = _constants(mat, dev)
    RmB, RsB = (oe.RmBragg, oe.RsBragg) if centre == GENERAL else \
        (oe.Rm, oe.Rs)
    numbers = dict(nums, Rm=oe.Rm, Rs=oe.Rs, Rm2=oe.Rm ** 2, RmB=RmB,
                   RsB=RsB, RmB2=RmB ** 2,
                   dx=getattr(oe, 'dxFacet', 0.0),
                   dxGap=getattr(oe, 'dxGap', 0.0),
                   dy=getattr(oe, 'dyFacet', 0.0),
                   dyGap=getattr(oe, 'dyGap', 0.0), roll=float(roll), CH=CH,
                   PI2=PI2)
    ints = (centre, int(diced), int(delta), nums['allowed'],
            tables[0].numel())

    def flat(v):
        return v.detach().reshape(-1).contiguous()
    ins = [flat(v) for v in (lb.x, lb.y, lb.a, lb.b, lb.c, lb.E, lb.Jss,
                             lb.Jpp)]
    ins.append(torch.view_as_real(flat(lb.Jsp)))
    ins.append(None if lb.theta is None else flat(lb.theta))
    good = flat(goodN)
    n = good.numel()
    # a, b, c, theta, Jss, Jpp; Jsp (interleaved); rollAngle
    outs = [torch.empty_like(ins[0]) for _ in range(6)] + \
        [torch.empty_like(ins[8]), torch.empty_like(ins[0])]

    def ptrs(ctype, vs):
        return (ctype * len(vs))(*vs)
    if n:
        _launch((int(x.dtype == torch.float64),
                 ptrs(ctypes.c_double, [numbers[k] for k in NUMBERS]),
                 ptrs(ctypes.c_int, ints),
                 ptrs(_P, [t.data_ptr() for t in tables]), n,
                 ptrs(_P, [None if v is None else v.data_ptr()
                           for v in ins]),
                 good.data_ptr(), ptrs(_P, [v.data_ptr() for v in outs]),
                 _cuda.scratch('crystal_interact', SCRATCH, dev).data_ptr()),
                dev)
        LAUNCHES[f'crystal_interact:{x.dtype}'] += 1
    a, b, c, theta, Jss, Jpp, Jsp, rollAngle = (
        torch.view_as_complex(v) if k == 6 else v
        for k, v in enumerate(outs))
    return (lb.replace(a=a.reshape(shape), b=b.reshape(shape),
                       c=c.reshape(shape), theta=theta.reshape(shape),
                       Jss=Jss.reshape(shape), Jpp=Jpp.reshape(shape),
                       Jsp=Jsp.reshape(shape)), rollAngle.reshape(shape))
