"""Coherent mode decomposition of filament fields, saving and loading.

Port of the reference package's ``modes.py``: a stack of filament
(macro-electron) fields is computed at the first aperture of a beamline
with the source's ``shine_wave``, decomposed into coherent modes by the
eigenvectors of its Gram matrix (:func:`solve_modes`) and pickled
(:func:`make_and_save_modes`); :func:`use_saved` turns saved modes or
fields back into waves ready for the next Kirchhoff hop.  The pickle holds
numpy arrays and floats only, in the reference's layout, so either package
reads what the other wrote.
"""
from __future__ import annotations

import cmath
import os
import pickle

import numpy as np
import torch

from . import config


def solve_modes(fields, nModes, phaseEsEp=0.0):
    """Eigenmodes of a list of (Es, Ep) sample-field pairs.  Returns
    (modes [(mEs, mEp)], all eigenvalues ascending, total flux of the
    fields).  Mode i is Es @ v_i for the eigenvector v_i of the i-th
    largest eigenvalue of the trace-normalized Gram matrix of Es + Ep
    e^{i phaseEsEp}: ||mode i||^2 is that eigenvalue times the trace."""
    nElectrons = len(fields)
    nModes = min(nModes, nElectrons)
    Es = torch.stack([f[0] for f in fields]).T     # (nsamples, nElectrons)
    Ep = torch.stack([f[1] for f in fields]).T
    fluxFields = torch.sum((Es * torch.conj(Es)).real) + \
        torch.sum((Ep * torch.conj(Ep)).real)
    DE = Es + Ep * cmath.exp(1j * phaseEsEp)
    DTD = DE.T.conj() @ DE
    DTD = DTD / torch.trace(DTD).real
    wAll, vE = torch.linalg.eigh(DTD)
    modes = []
    for iMode in range(nModes):
        vv = vE[:, -1 - iMode]
        modes.append((Es @ vv, Ep @ vv))
    return modes, wAll, fluxFields


def _pickle_path(basename, outdir):
    return os.path.join(outdir, f'wave-{basename}.pickle')


def make_and_save_modes(bl, nsamples, nElectrons, nElectronsSave, nModes,
                        fixedEnergy, generator=None, phaseEsEp=0.0,
                        output='all', basename='local', outdir='.',
                        dtype=None, device=None):
    """*nElectrons* filament fields of the first source of *bl* at its
    first aperture (*nsamples* samples drawn from *generator*, seed 0 if
    None, which then draws each filament's e-beam offsets), decomposed into
    *nModes* coherent modes; the first *nElectronsSave* fields, the modes
    and the sample geometry are pickled to ``wave-<basename>.pickle`` in
    *outdir* when *output* names 'wave' or 'all'.

    Returns (modes, wAll, fluxFields, wave)."""
    from .waves import prepare_wave_on_aperture
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    source = bl.sources[0]
    slit = bl.slits[0]
    wave = prepare_wave_on_aperture(slit, source, nsamples,
                                    generator=generator, dtype=dtype,
                                    device=device)
    sqdS = torch.sqrt(wave.area / nsamples)
    norm = nElectrons ** 0.5
    fields = []
    for _ in range(nElectrons):
        w = source.shine_wave(generator, wave, fixedEnergy)
        fields.append((w.Es * sqdS / norm, w.Ep * sqdS / norm))
    modes, wAll, fluxFields = solve_modes(fields, nModes, phaseEsEp)

    if 'wave' in output or 'all' in output:
        def host(v):
            return v.detach().cpu().numpy()
        state = {
            'fields': [(host(f[0]), host(f[1]))
                       for f in fields[:nElectronsSave]],
            'modes': [(host(m[0]), host(m[1])) for m in modes],
            'wAll': host(wAll),
            'fluxFields': float(fluxFields),
            'wave_geometry': {k: host(getattr(wave, k)) for k in
                              ('x', 'y', 'z', 'a', 'b', 'c', 'xDiffr',
                               'yDiffr', 'zDiffr', 'rDiffr', 'dS')},
            'area': float(wave.area),
            'E0': fixedEnergy,
        }
        with open(_pickle_path(basename, outdir), 'wb') as f:
            pickle.dump(state, f)
    return modes, wAll, fluxFields, wave


def use_saved(what, basename, slit=None, source=None, outdir='.',
              dtype=None, device=None):
    """Saved modes (*what* ends in 'modes', e.g. 'wave-modes') or fields
    ('wave-fields') of ``wave-<basename>.pickle`` in *outdir* as waves on
    the aperture *slit* from *source* (element references are not
    pickled), in *dtype* on *device*.  Returns (waves, wAll,
    fluxFields)."""
    from .waves import Wave
    dt = config.resolve_dtype(dtype)
    dev = config.resolve_device(device)
    cdt = config.cdtype(dt)
    with open(_pickle_path(basename, outdir), 'rb') as f:
        state = pickle.load(f)
    saved = state['modes'] if what.endswith('modes') else state['fields']
    geo = state['wave_geometry']

    def T(v, d=dt):
        return torch.as_tensor(np.asarray(v), dtype=d, device=dev)
    res = []
    for Es, Ep in saved:
        n = len(Es)
        res.append(Wave(
            x=T(geo['x']), y=T(geo['y']), z=T(geo['z']), a=T(geo['a']),
            b=T(geo['b']), c=T(geo['c']),
            E=torch.full((n,), float(state['E0']), dtype=dt, device=dev),
            state=torch.ones((n,), dtype=torch.int32, device=dev),
            path=torch.zeros((n,), dtype=dt, device=dev),
            Jss=T((Es * np.conj(Es)).real), Jpp=T((Ep * np.conj(Ep)).real),
            Jsp=T(Es * np.conj(Ep), cdt), Es=T(Es, cdt), Ep=T(Ep, cdt),
            xDiffr=T(geo['xDiffr']), yDiffr=T(geo['yDiffr']),
            zDiffr=T(geo['zDiffr']), rDiffr=T(geo['rDiffr']),
            dS=T(geo['dS']), area=T(state['area']),
            fromOE=source, toOE=slit))
    return res, state['wAll'], state['fluxFields']
