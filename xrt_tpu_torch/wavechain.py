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

``run()`` is differentiable: nothing in it detaches, so a chain built
once gives gradients with respect to whatever tensors its run reads — the
source's parameters (``run(waves=...)`` with a first wave whose ``fromOE``
is ``source.replace(w0=tensor)``), per-run shifts of the receiving
coordinates and tensor placement angles of the elements (waves whose
``*Diffr`` were shifted and whose ``toOE`` / ``fromOE`` carry the tensor).
On CUDA tensors the backward pass runs the hand-written adjoint kernels.

``run()`` executes eagerly (PyTorch has no counterpart of the reference's
single ``jit``).  Under ``jit`` the reference resolves the kernel's
``narrowband='auto'`` to False, so the chain passes ``narrowband=False``
explicitly to keep the same numerics; the modes were chosen at build time,
so it also skips the kernel's host envelope check (``check_envelope``).
``build(tiled=True)`` samples the OE receivers sorted along y and gives
every stage outside the recentred 'mxu*' envelopes a tile map
(:func:`~xrt_tpu_torch.waves.choose_tile_modes`, ``tile_shape`` tiles).
Multi-device runs (``mesh=``) are not ported yet.
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
    def build(self, generator=None, tiled=False, tile_shape=(5, 10),
              verbose=False, mesh=None, error_budget='auto', dtype=None,
              device=None):
        """Prepare the fixed receiving geometry, choose per-stage kernel
        modes (and with *tiled* the tile maps), and return
        ``run(generator=None, timings=None) -> (final_wave, log_scale)``.

        *generator*: the ``torch.Generator`` of the receiver samples (seed
        0 if None); ``run``'s own generator feeds the source's draws.
        *error_budget*: per-stage relative field error for
        :func:`~xrt_tpu_torch.waves.choose_kirchhoff_mode` — 'auto' is the
        chain's Monte-Carlo noise floor 3/sqrt(nrays); None disables it.
        *dtype*/*device*: ``torch.float32`` (default: double-float CUDA
        kernels) or ``torch.float64`` (plain float64 path); ``'cuda'`` by
        default.

        ``run(timings=[])`` appends one dict per Kirchhoff stage:
        ``hop``, ``mode``, for a tiled stage ``tiles`` (its tile pairs per
        mode) and CUDA ``start``/``end`` events (or host seconds as
        ``seconds`` on the CPU), read after a synchronize.
        ``run(waves=...)`` takes this run's receiving waves in place of the
        prepared ``run.waves`` (the same samples: shifted coordinates,
        elements with tensor parameters as ``fromOE`` / ``toOE``); the
        modes chosen at build time stay."""
        if mesh is not None:
            raise NotImplementedError(_w._MESH_TODO)
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
        tilemaps: List[Optional[list]] = []
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
                                           generator=generator,
                                           sort='y' if tiled else None,
                                           dtype=dt, device=dev)
            else:
                wv = _w.prepare_wave_on_screen(el, prev_el, *extra,
                                               dtype=dt, device=dev)
            if i == 0:
                modes.append(None)        # filled by shine, not diffract
                tilemaps.append(None)
            else:
                dst = (wv.xDiffr, wv.yDiffr, wv.zDiffr)
                mode = _w.choose_kirchhoff_mode(dst, prev_geom, k=kv,
                                                error_budget=error_budget)
                tm = None
                if tiled and not (mode[0] == 'recentred' and
                                  mode[1].startswith('mxu')):
                    tm = _w.choose_tile_modes(dst, prev_geom, *tile_shape,
                                              k=kv,
                                              error_budget=error_budget)
                if verbose:
                    nm = getattr(el, 'name', '') or type(el).__name__
                    print(f'# hop {i} -> {nm}: {mode}'
                          + (f' tiled {tile_shape}' if tm else ''))
                modes.append(mode)
                tilemaps.append(tm)
            prev_geom = (wv.x, wv.y, wv.z)
            waves.append(wv)
            prev_el = el

        hops = list(self._hops)
        fixedE = self.fixedEnergy
        mono = fixedE is not None
        waves0 = tuple(waves)

        def run(generator=None, timings=None, waves=None):
            wvs = waves0 if waves is None else tuple(waves)
            if len(wvs) != len(waves0):
                raise ValueError(f'run(waves=...) takes {len(waves0)} '
                                 f'waves, not {len(wvs)}')
            f32 = wvs[0].xDiffr.dtype == torch.float32
            logs = torch.zeros((), dtype=wvs[0].x.dtype,
                               device=wvs[0].x.device)

            def scaled(b):
                nonlocal logs
                if not f32:
                    return b
                b, ls = _w.rescale_field(b)
                logs = logs + ls
                return b

            cur = _w._shine_or_diffract(None, wvs[0], generator,
                                        fixedEnergy=fixedE)
            if hops[0][0] == 'oe':
                _, cur = _w.reflect_wave(wvs[0].toOE, cur, generator)
            cur = scaled(cur)
            for i in range(1, len(hops)):
                kind, _, extra = hops[i]
                el = wvs[i].toOE
                pm, acc = modes[i]
                rec = dict(hop=i, mode=(pm, acc))
                if tilemaps[i] is not None:
                    rec['tiles'] = _w.tile_pairs_by_mode(tilemaps[i])
                mark = StageTimer(timings, rec, cur.x.device)
                b = _w.diffract(cur, wvs[i], phase_mode=pm,
                                monochromatic=mono, accumulate=acc,
                                tile_modes=tilemaps[i], narrowband=False,
                                check_envelope=False)
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
        run.tilemaps = tilemaps
        return run

    # -- output helpers --------------------------------------------------
    @staticmethod
    def absolute_intensity(wave, log_scale) -> np.ndarray:
        """(Jss + Jpp) restored to absolute units, float64 on the host."""
        J = wave.Jss.detach().to('cpu', torch.float64).numpy() + \
            wave.Jpp.detach().to('cpu', torch.float64).numpy()
        return J * math.exp(-2.0 * float(log_scale))


class StageTimer:
    """Brackets one step of a run: ``stop()`` appends the record *rec* to
    *timings* with CUDA ``start``/``end`` events (read them after a
    synchronize), or host ``seconds`` on the CPU; nothing when *timings* is
    None."""

    def __init__(self, timings, rec, device):
        self.timings = timings
        if timings is None:
            return
        self.rec = rec
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
