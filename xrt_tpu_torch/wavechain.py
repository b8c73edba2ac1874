"""One-object coherent wave chain: assemble, prepare, run.

Port of the reference package's ``wavechain.py``:

- the receiving geometry of every element is prepared once (host
  float64; f64 residuals carried for the double-float kernels),
- each stage's Kirchhoff mode is chosen against the recentred-scheme
  envelopes (:func:`xrt_tpu_torch.waves.choose_kirchhoff_mode`),
- float32 chains log-rescale the field between stages
  (:func:`~xrt_tpu_torch.waves.rescale_field`).

    chain = (WaveChain(source, nrays=200000, fixedEnergy=E0)
             .through_aperture(slit)
             .through_oe(m1)
             .to_screen(screen, xs, zs))
    run = chain.build(torch.Generator().manual_seed(1))
    wave, logs = run()
    I = WaveChain.absolute_intensity(wave, logs)   # float64, host

``run()`` executes eagerly (PyTorch has no counterpart of the reference's
single ``jit``).  Under ``jit`` the reference resolves the kernel's
``narrowband='auto'`` to False, so the chain passes ``narrowband=False``
explicitly to keep the same numerics.  Blockwise tiling (``tiled=True``)
and multi-device runs (``mesh=``) are not ported yet.
"""
from __future__ import annotations

import math
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from . import config
from . import waves as _w
from .physconsts import CHBAR

_TILED_TODO = ('WaveChain.build(tiled=True) needs diffract(tile_modes=...), '
               'which is not ported yet: ROADMAP A3, with the SoftiMAX '
               'slice')


class WaveChain:
    """Sequential coherent wave chain source -> ... -> last element."""

    def __init__(self, source, nrays=100000, fixedEnergy=None):
        self.source = source
        self.nrays = int(nrays)
        self.fixedEnergy = fixedEnergy
        self._hops: List[Tuple[str, Any, Any]] = []

    # -- assembly --------------------------------------------------------
    def through_aperture(self, aperture):
        self._hops.append(('aperture', aperture, None))
        return self

    def through_oe(self, oe, areaFraction='auto'):
        if areaFraction == 'auto':
            areaFraction = float(oe.get_grating_area_fraction()) \
                if hasattr(oe, 'get_grating_area_fraction') else None
        self._hops.append(('oe', oe, areaFraction))
        return self

    def to_screen(self, screen, dim1, dim2):
        self._hops.append(('screen', screen, (np.asarray(dim1, float),
                                              np.asarray(dim2, float))))
        return self

    # -- build -----------------------------------------------------------
    def build(self, generator=None, tiled=False, verbose=False, mesh=None,
              error_budget='auto', dtype=None, device=None):
        """Prepare the fixed receiving geometry, choose per-stage kernel
        modes, and return ``run(generator=None, timings=None) ->
        (final_wave, log_scale)``.

        *generator*: the ``torch.Generator`` of the receiver samples (seed
        0 if None); ``run``'s own generator feeds the source's draws.
        *error_budget*: per-stage relative field error for
        :func:`~xrt_tpu_torch.waves.choose_kirchhoff_mode` — 'auto' is the
        chain's Monte-Carlo noise floor 3/sqrt(nrays); None disables it.
        *dtype*/*device*: ``torch.float32`` (default: double-float CUDA
        kernels) or ``torch.float64`` (plain float64 path); ``'cuda'`` by
        default.

        ``run(timings=[])`` appends one dict per Kirchhoff stage:
        ``hop``, ``mode`` and CUDA ``start``/``end`` events (or host
        seconds as ``seconds`` on the CPU), read after a synchronize."""
        if mesh is not None:
            raise NotImplementedError(_w._MESH_TODO)
        if tiled:
            raise NotImplementedError(_TILED_TODO)
        if not self._hops:
            raise ValueError('empty chain')
        dt = config.resolve_dtype(dtype)
        dev = config.resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if error_budget == 'auto':
            error_budget = 3.0 / math.sqrt(self.nrays)
        waves = []
        modes: List[Optional[Tuple[str, str]]] = []
        prev_el = self.source
        prev_geom = None
        # the recentred delta-series error scales with k: the mode choice
        # sees the actual photon energy
        if self.fixedEnergy is not None:
            kv = float(self.fixedEnergy) / CHBAR * 1e7
        else:
            kv = float(getattr(self.source, 'eMax', 280.0)) / CHBAR * 1e7
        for i, (kind, el, extra) in enumerate(self._hops):
            if kind == 'aperture':
                wv = _w.prepare_wave_on_aperture(
                    el, prev_el, self.nrays, generator=generator, dtype=dt,
                    device=dev)
            elif kind == 'oe':
                wv = _w.prepare_wave_on_oe(el, prev_el, self.nrays,
                                           generator=generator, dtype=dt,
                                           device=dev)
            else:
                wv = _w.prepare_wave_on_screen(el, prev_el, *extra,
                                               dtype=dt, device=dev)
            if i == 0:
                modes.append(None)        # filled by shine, not diffract
            else:
                dst = (wv.xDiffr, wv.yDiffr, wv.zDiffr)
                mode = _w.choose_kirchhoff_mode(dst, prev_geom, k=kv,
                                                error_budget=error_budget)
                if verbose:
                    nm = getattr(el, 'name', '') or type(el).__name__
                    print(f'# hop {i} -> {nm}: {mode}')
                modes.append(mode)
            prev_geom = (wv.x, wv.y, wv.z)
            waves.append(wv)
            prev_el = el

        hops = list(self._hops)
        fixedE = self.fixedEnergy
        mono = fixedE is not None
        waves0 = tuple(waves)

        def run(generator=None, timings=None):
            f32 = waves0[0].xDiffr.dtype == torch.float32
            logs = torch.zeros((), dtype=waves0[0].x.dtype,
                               device=waves0[0].x.device)

            def scaled(b):
                nonlocal logs
                if not f32:
                    return b
                b, ls = _w.rescale_field(b)
                logs = logs + ls
                return b

            cur = _w._shine_or_diffract(None, waves0[0], generator)
            if hops[0][0] == 'oe':
                _, cur = _w.reflect_wave(hops[0][1], cur, generator)
            cur = scaled(cur)
            for i in range(1, len(hops)):
                kind, el, extra = hops[i]
                pm, acc = modes[i]
                mark = _Mark(timings, i, (pm, acc), cur.x.device)
                b = _w.diffract(cur, waves0[i], phase_mode=pm,
                                monochromatic=mono, accumulate=acc,
                                narrowband=False)
                mark.stop()
                if kind == 'oe':
                    _, cur = _w.reflect_wave(el, b, generator)
                    if extra is not None:   # grating areaFraction
                        cur = cur.replace(area=cur.area * extra)
                else:
                    cur = b
                if i < len(hops) - 1:
                    cur = scaled(cur)
            return cur, logs

        run.waves = waves0
        run.modes = modes
        run.tilemaps = [None] * len(hops)
        return run

    # -- output helpers --------------------------------------------------
    @staticmethod
    def absolute_intensity(wave, log_scale) -> np.ndarray:
        """(Jss + Jpp) restored to absolute units, float64 on the host."""
        J = wave.Jss.detach().to('cpu', torch.float64).numpy() + \
            wave.Jpp.detach().to('cpu', torch.float64).numpy()
        return J * math.exp(-2.0 * float(log_scale))


class _Mark:
    """Brackets one Kirchhoff stage for ``run(timings=...)``."""

    def __init__(self, timings, hop, mode, device):
        self.timings = timings
        if timings is None:
            return
        self.rec = dict(hop=hop, mode=mode)
        if device.type == 'cuda':
            self.rec['start'] = torch.cuda.Event(enable_timing=True)
            self.rec['end'] = torch.cuda.Event(enable_timing=True)
            self.rec['start'].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.timings is None:
            return
        if 'end' in self.rec:
            self.rec['end'].record()
        else:
            self.rec['seconds'] = time.perf_counter() - self.t0
        self.timings.append(self.rec)
