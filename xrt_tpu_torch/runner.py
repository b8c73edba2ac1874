"""The job runner: repeated traced passes accumulated into plots.

Port of the reference package's ``runner.py``.  One pass traces a full
batch of rays on the device and fills the histograms of every plot there
(:mod:`xrt_tpu_torch.histogram`: on the card one launch of the
hand-written plot kernel a plot); the host loop accumulates them, since
histograms are linear.  The user contract:
``run_process(beamLine, generator) -> {beamName: Beam}`` with an explicit
``torch.Generator`` for reproducibility.

What differs from the reference package: PyTorch runs eagerly, so there is
no compiled-step cache; each plot's histograms and counters of a pass come
to the host in one transfer; auto limits are reduced to their minima and
maxima on the device.  With ``mesh=`` (:mod:`xrt_tpu_torch.parallel`)
every rank traces its own rays each pass and accumulates the histograms
summed over ranks.  Plots with a ``saveName`` are rendered
(:mod:`xrt_tpu_torch.plotting`) at the end and every ``updateEvery``
passes.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import Dict, Sequence

import numpy as np
import torch

from .beam import Beam
from .histogram import hist1d, hist2d, hist_plot_kernel, hist_plot_plain
from .ops.dd import sqrt_rn
from .physconsts import SIE0
from .plotspec import HUE_DEAD, HUE_GOOD, HUE_OUT, HUE_OVER, XYCPlot
from .profiler import count, is_tracing, next_pass, report, stage, tracing

# ---------------------------------------------------------------------------
# beam getters
# ---------------------------------------------------------------------------


def _safe_b(beam):
    return torch.where(beam.b == 0, torch.full_like(beam.b, 1e-300), beam.b)


def _or_zeros(v, beam):
    return torch.zeros_like(beam.x) if v is None else v


def _circular_rate(b):
    return 2 * b.Jsp.imag / torch.clamp(b.Jss + b.Jpp, min=1e-300)


BEAM_GETTERS = {
    'x': lambda b: b.x,
    'y': lambda b: b.y,
    'z': lambda b: b.z,
    'xprime': lambda b: b.a / _safe_b(b),
    'zprime': lambda b: b.c / _safe_b(b),
    'path': lambda b: b.path,
    'energy': lambda b: b.E,
    'r': lambda b: sqrt_rn(b.x ** 2 + b.z ** 2),
    'phi': lambda b: torch.atan2(b.x, b.z),
    'theta': lambda b: torch.atan2(sqrt_rn(b.a ** 2 + b.c ** 2), b.b),
    'degree_of_polarization': lambda b: b.degree_of_polarization,
    'circular_polarization_rate': _circular_rate,
    'polarization_psi': lambda b: 0.5 * torch.atan2(
        2. * b.Jsp.real, b.Jss - b.Jpp),
    's': lambda b: b.x if b.s is None else b.s,
    'incidence_angle': lambda b: _or_zeros(b.theta, b),
    'a': lambda b: b.a,
    'b': lambda b: b.b,
    'xzprime': lambda b: sqrt_rn(b.a ** 2 + b.c ** 2) / _safe_b(b),
    'order': lambda b: _or_zeros(b.order, b),
    'reflection_number': lambda b: _or_zeros(b.nRefl, b),
    'Es_amp': lambda b: torch.abs(b.Es),
    'Ep_amp': lambda b: torch.abs(b.Ep),
    'Es_phase': lambda b: torch.angle(b.Es),
    'Ep_phase': lambda b: torch.angle(b.Ep),
    'ratio_ellipse_axes': lambda b: torch.tan(0.5 * torch.arcsin(
        torch.clamp(_circular_rate(b), -1., 1.))),
    'phase_shift': lambda b: torch.angle(b.Jsp) / torch.pi,  # units of pi
}


def get_beam_data(beam: Beam, data):
    if callable(data):
        return data(beam)
    return BEAM_GETTERS[data](beam)


def _intensity_flux(beam: Beam, fluxKind: str):
    """(intensity, flux) per fluxKind."""
    fk = fluxKind
    if fk.startswith('power'):
        acc = beam.accepted if beam.accepted is not None else 1.0
        seed = beam.seeded if beam.seeded is not None else 1.0
        intensity = (beam.Jss + beam.Jpp) * beam.E * acc / seed * SIE0
        return intensity, intensity
    if fk.startswith('s'):
        i = beam.Jss
    elif fk.startswith('p'):
        i = beam.Jpp
    elif fk.startswith('+-45'):
        i = 2 * beam.Jsp.real
    elif fk.startswith('left-right'):
        i = 2 * beam.Jsp.imag
    elif fk.startswith('E'):
        if fk.startswith('Es'):
            return beam.Es, beam.Jss
        if fk.startswith('Ep'):
            return beam.Ep, beam.Jpp
        return beam.Es + beam.Ep, beam.Jss + beam.Jpp
    else:
        i = beam.Jss + beam.Jpp
    return i, i


def _plot_arrays(plot: XYCPlot, beams: Dict[str, Beam]):
    """(x, y, cData, intensity, flux, mask, counters) of one plot on the
    beams of one pass, all on the beams' device."""
    beam = beams[plot.beam]
    state = beam.state if plot.beamState is None \
        else beams[plot.beamState].state
    mask = torch.zeros_like(state, dtype=torch.bool)
    for rayFlag in plot.rayFlag:
        if rayFlag < 0:
            mask = mask | (state < 0)
        else:
            mask = mask | (state == rayFlag)
    x = (get_beam_data(beam, plot.xaxis.data) - plot.xaxis.offset) * \
        plot.xaxis.factor
    y = (get_beam_data(beam, plot.yaxis.data) - plot.yaxis.offset) * \
        plot.yaxis.factor
    if plot.caxis.useCategory:
        hue = torch.full_like(x, HUE_DEAD)
        for code, h in ((3, HUE_OVER), (2, HUE_OUT), (1, HUE_GOOD)):
            hue = torch.where(state == code, torch.full_like(x, h), hue)
        cData = hue
        intensity = torch.ones_like(x)
        flux = intensity
    else:
        beamC = beam if plot.beamC is None else beams[plot.beamC]
        cData = get_beam_data(beamC, plot.caxis.data) * plot.caxis.factor
        intensity, flux = _intensity_flux(beam, plot.fluxKind)

    def scalar(v):
        return 0.0 if v is None else v
    counters = dict(
        nRaysAll=state.shape[0],
        nRaysAlive=torch.sum(state > 0),
        nRaysGood=torch.sum(state == 1),
        nRaysOut=torch.sum(state == 2),
        nRaysOver=torch.sum(state == 3),
        nRaysDead=torch.sum(state < 0),
        nRaysAccepted=scalar(beam.accepted),
        nRaysAcceptedE=scalar(beam.acceptedE),
        nRaysSeeded=scalar(beam.seeded),
        nRaysSeededI=scalar(beam.seededI),
    )
    return x, y, cData, intensity, flux, mask, counters


def histogram_plot(plot: XYCPlot, beams: Dict[str, Beam]):
    """All histograms of one plot for one traced pass, as tensors on the
    beams' device: on the card one launch of the plot kernel for the
    eight histograms, colorize and the total; on the CPU their plain
    version.  Limits must already be fixed in the plot axes."""
    x, y, cData, intensity, flux, mask, counters = _plot_arrays(plot, beams)
    xlim = tuple(plot.xaxis.limits)
    ylim = tuple(plot.yaxis.limits)
    clim = tuple(plot.caxis.limits)
    xb, yb, cb = plot.xaxis.bins, plot.yaxis.bins, plot.caxis.bins
    # for the field kinds ('E*') the 2D intensity histogram is the field's
    # real part, as the accumulated total2D keeps
    w2d = intensity.real if intensity.is_complex() else intensity
    fn = hist_plot_plain if x.device.type == 'cpu' else hist_plot_kernel
    out = fn(x, y, cData, flux, w2d, mask, (xb, yb, cb), (xlim, ylim, clim),
             plot.colorFactor, plot.colorSaturation)
    out['counters'] = counters
    fk = plot.fluxKind
    # mutual-intensity accumulators for coherence analysis: outer products
    # of the histogrammed complex field
    if fk.startswith('E'):
        fklow = fk.lower()
        field = intensity * mask.to(x.dtype)  # the per-ray field, masked
        if fklow.endswith(('xx', 'zz', 'yy')):
            axv, bins, lim = (x, xb, xlim) if fklow.endswith('xx') \
                else (y, yb, ylim)
            fs = torch.complex(hist1d(axv, field.real, bins, lim),
                               hist1d(axv, field.imag, bins, lim))
            out['J2D'] = torch.outer(fs, torch.conj(fs))
        elif fklow.endswith(('4d', 'pca')):
            fvec = torch.complex(
                hist2d(x, y, field.real, xb, yb, xlim, ylim),
                hist2d(x, y, field.imag, xb, yb, xlim, ylim)).ravel()
            if fklow.endswith('4d'):
                out['J4D'] = torch.outer(fvec, torch.conj(fvec))
            else:
                out['fieldPCA'] = fvec
    return out


# ---------------------------------------------------------------------------
# limits calibration (iteration 0 semantics)
# ---------------------------------------------------------------------------

def _update_limits(axis, n, anyFinite, vmin, vmax):
    """Fix the limits of *axis* from the count, the finiteness and the
    NaN-ignoring minimum and maximum of its selected data."""
    if (axis._limitsInit is None) or isinstance(axis._limitsInit, str):
        if n > 1 and anyFinite:
            xmin, xmax = float(vmin), float(vmax)
            dx = axis.extraMargin * (xmax - xmin) / axis.bins
            xmin -= dx
            xmax += dx
            if xmin == xmax:
                xmin -= 1.0
                xmax += 1.0
        else:
            xmin, xmax = 1.0, 10.0
        if isinstance(axis._limitsInit, str):  # 'symmetric'
            xmm = max(abs(xmin), abs(xmax))
            xmin, xmax = -xmm, xmm
        axis.limits = [xmin, xmax]
    else:
        axis.limits = list(axis._limitsInit)


def _extent(v, mask):
    """[count, any finite, min, max] of v[mask] ignoring NaN, as a float64
    tensor of 4 on v's device."""
    sel = mask & ~torch.isnan(v)
    inf = torch.full_like(v, torch.inf)
    return torch.stack([
        mask.sum().double(), (mask & torch.isfinite(v)).any().double(),
        torch.where(sel, v, inf).min().double(),
        torch.where(sel, v, -inf).max().double()])


def calibrate_limits(plots: Sequence[XYCPlot], beams: Dict[str, Beam]):
    """Fix auto axis limits from a calibration pass: the extents are
    reduced on the device and come to the host in one transfer per
    plot."""
    for plot in plots:
        x, y, cData, _, _, mask, _ = _plot_arrays(plot, beams)
        ext = torch.stack([_extent(v, mask) for v in (x, y, cData)]).cpu()
        for axis, (n, fin, vmin, vmax) in zip(
                (plot.xaxis, plot.yaxis, plot.caxis), ext.tolist()):
            _update_limits(axis, n, fin, vmin, vmax)
        # aspect='equal' equalization
        if plot.aspect == 'equal' or isinstance(plot.aspect, (int, float)):
            aspect = 1.0 if plot.aspect == 'equal' else float(plot.aspect)
            xlim, ylim = plot.xaxis.limits, plot.yaxis.limits
            dx = xlim[1] - xlim[0]
            dy = ylim[1] - ylim[0]
            xDefined = plot.xaxis._limitsInit is not None and \
                not isinstance(plot.xaxis._limitsInit, str)
            yDefined = plot.yaxis._limitsInit is not None and \
                not isinstance(plot.yaxis._limitsInit, str)
            if xDefined and not yDefined:
                leading = 'x'
            elif yDefined and not xDefined:
                leading = 'y'
            else:
                leading = 'x' if dx > dy * aspect else 'y'
            if leading == 'x':
                yMid = (ylim[1] + ylim[0]) / 2
                dy2 = dx / aspect / 2
                plot.yaxis.limits = [yMid - dy2, yMid + dy2]
            else:
                xMid = (xlim[1] + xlim[0]) / 2
                dx2 = dy * aspect / 2
                plot.xaxis.limits = [xMid - dx2, xMid + dx2]


_HISTS = (('xh', 'total1D_x'), ('xhRGB', 'total1D_x_RGB'),
          ('yh', 'total1D_y'), ('yhRGB', 'total1D_y_RGB'),
          ('eh', 'total1D_c'), ('ehRGB', 'total1D_c_RGB'),
          ('xyh', 'total2D'), ('xyhRGB', 'total2D_RGB'))
_INT_COUNTERS = ('nRaysAll', 'nRaysAlive', 'nRaysGood', 'nRaysOut',
                 'nRaysOver', 'nRaysDead')
_FLOAT_COUNTERS = ('nRaysAccepted', 'nRaysAcceptedE', 'nRaysSeeded',
                   'nRaysSeededI')


def _accumulate(plot: XYCPlot, h):
    """Add one pass's histograms and counters to the plot.  The eight
    histograms, the intensity and the tensor-valued counters are packed
    into one float64 tensor on the device and fetched in one transfer."""
    c = h['counters']
    onDevice = [k for k in _INT_COUNTERS + _FLOAT_COUNTERS
                if isinstance(c[k], torch.Tensor)]
    parts = [h[k].reshape(-1) for k, _ in _HISTS] + \
        [h['intensity'].reshape(1)] + [c[k].reshape(1) for k in onDevice]
    flat = torch.cat([p.double() for p in parts]).cpu().numpy()
    pos = 0
    for k, total in _HISTS:
        acc = getattr(plot, total)
        acc += flat[pos:pos + acc.size].reshape(acc.shape)
        pos += acc.size
    plot.intensity += float(flat[pos])
    fetched = dict(zip(onDevice, flat[pos + 1:]))
    for k in _INT_COUNTERS:
        setattr(plot, k, getattr(plot, k) + int(fetched.get(k, c[k])))
    for k in _FLOAT_COUNTERS:
        setattr(plot, k, getattr(plot, k) + float(fetched.get(k, c[k])))
    if 'J2D' in h:
        J = h['J2D'].cpu().numpy()
        prev = getattr(plot, 'totalJ2D', None)
        plot.totalJ2D = J if prev is None else prev + J
    if 'J4D' in h:
        J = h['J4D'].cpu().numpy()
        prev = getattr(plot, 'totalJ4D', None)
        plot.totalJ4D = J if prev is None else prev + J
    if 'fieldPCA' in h:
        if getattr(plot, 'fieldsPCA', None) is None:
            plot.fieldsPCA = []
        plot.fieldsPCA.append(h['fieldPCA'].cpu().numpy())
    plot.repeats += 1


def _alloc_stats(device):
    """The caching allocator's ``cudaMalloc`` calls on *device* so far,
    while tracing on a card; else None."""
    if device.type != 'cuda' or not is_tracing():
        return None
    return torch.cuda.memory_stats(device).get('segment.all.allocated', 0)


def _count_allocs(before, device):
    """Count the allocator's ``cudaMalloc`` calls since *before*."""
    after = None if before is None else _alloc_stats(device)
    if after is not None:
        count('alloc.segments', after - before)


RUN_HISTORY_FILE = 'lastRuns.pickle'


def store_run_history(t_start, t_stop, tag='', fileName=None, keep=10):
    """Append (start, stop, duration, tag) to the run-history pickle."""
    fileName = fileName or RUN_HISTORY_FILE
    runs = load_run_history(fileName)
    runs.append((time.localtime(t_start), time.localtime(t_stop),
                 t_stop - t_start, tag))
    with open(fileName, 'wb') as f:
        pickle.dump(runs[-keep:], f)
    return runs[-keep:]


def load_run_history(fileName=None):
    """The run history this module stored, or [] when the file is absent
    or unreadable."""
    fileName = fileName or RUN_HISTORY_FILE
    if not os.path.exists(fileName):
        return []
    try:
        with open(fileName, 'rb') as f:
            return list(pickle.load(f))
    except (OSError, EOFError, pickle.UnpicklingError, TypeError):
        return []


def normalize_sibling_plots(plots, saveSuffix='_norm'):
    """Put a family of plots on a common brightness scale and save them
    again: the global maxima of the 1D profiles and the 2D histograms are
    shared across all *plots* through their ``globalMax*`` attributes; a
    plot with a ``saveName`` is rendered to that name with *saveSuffix*
    before its extension."""
    max2D = max(float(np.max(p.total2D)) for p in plots) or 1.0
    max2D_RGB = max(float(np.max(p.total2D_RGB)) for p in plots) or 1.0
    max1Dx = max(float(np.max(p.total1D_x)) for p in plots) or 1.0
    max1Dy = max(float(np.max(p.total1D_y)) for p in plots) or 1.0
    for plot in plots:
        plot.globalMax2D = max2D
        plot.globalMax2D_RGB = max2D_RGB
        plot.globalMax1D_x = max1Dx
        plot.globalMax1D_y = max1Dy
        if plot.saveName:
            from .plotting import save_plot
            root, ext = plot.saveName.rsplit('.', 1)
            save_plot(plot, f'{root}{saveSuffix}.{ext}')
    return max2D, max2D_RGB


def run_ray_tracing(plots, repeats=1, beamLine=None, run_process=None,
                    rng=None, updateEvery=None, pickleEvery=None,
                    generator=None, generatorArgs=(), afterScript=None,
                    afterScriptArgs=(), mesh=None, verbose=False,
                    historyFile=None, historyTag='', device=None):
    """Trace ``repeats`` batches and accumulate histograms into *plots*.

    *run_process(beamLine, rng) -> {name: Beam}* is the user trace
    function.  *rng* is the ``torch.Generator`` handed to it on every pass
    (its state advances from pass to pass), or an int seed or None (seed
    0), from which a generator is made on *device* (the card by default).
    *generator* supports parametric scans: a Python generator function
    which mutates the beamline or the plots between scan points; each
    scan point accumulates ``repeats`` more passes.

    *mesh* (a :class:`~xrt_tpu_torch.parallel.Mesh`): every pass runs on
    every rank with its own generator
    (:func:`~xrt_tpu_torch.parallel.sharded_step`), and every rank
    accumulates the same totals.  *updateEvery* re-renders the plots with a
    ``saveName`` every so many passes; all of them are rendered at the end.
    *verbose* prints each pass's time and the profiler's report of its
    stages, and records their spans and counters (``profiler.tracing()``),
    as it does while a ``torch.profiler`` session records.

    Each pass is ``runner.step``, which blocks on the card, then
    ``runner.accumulate``.  ``runner.step`` holds ``runner.process`` (the
    pass's ``run_process``, or ``sharded_step`` with *mesh*) and one
    ``runner.histogram`` a plot; the elements' own spans (``oes.reflect``
    and inside it ``oes.search`` and ``oes.interact``) nest in
    ``runner.process``.  While tracing, every pass (and a calibration
    pass) takes a new pass id (``profiler.next_pass()``), and on a card
    ``runner.step`` counts the caching allocator's ``cudaMalloc`` calls of
    the pass (``alloc.segments``); ``profiler.spans()`` and
    ``profiler.counters()`` return them until ``profiler.reset()``."""
    from . import config
    from .parallel import sharded_step
    if isinstance(plots, XYCPlot):
        plots = [plots]
    if isinstance(generator, torch.Generator):
        raise TypeError('generator= is the scan generator function; pass '
                        'the torch.Generator as rng=')
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator(config.resolve_device(
            mesh.device if mesh is not None and device is None
            else device)).manual_seed(0 if rng is None else int(rng))

    def one_scan_point():
        for plot in plots:
            if plot.persistentName and os.path.exists(plot.persistentName):
                plot.restore_plots()
        # calibration pass for auto limits
        if any(ax.limits is None or isinstance(ax.limits, str)
               for p in plots for ax in (p.xaxis, p.yaxis, p.caxis)):
            next_pass()
            calibrate_limits(plots, run_process(beamLine, rng))
        t0 = time.time()
        dev = rng.device
        for it in range(repeats):
            next_pass()
            with stage('runner.step', block=dev, device=dev):
                alloc0 = _alloc_stats(dev)
                with stage('runner.process', device=dev):
                    if mesh is not None:
                        hists = sharded_step(run_process, beamLine, plots,
                                             mesh, rng)
                    else:
                        beams = run_process(beamLine, rng)
                if mesh is None:
                    hists = []
                    for plot in plots:
                        with stage('runner.histogram', device=dev):
                            hists.append(histogram_plot(plot, beams))
                _count_allocs(alloc0, dev)
            with stage('runner.accumulate', device=dev):
                for plot, h in zip(plots, hists):
                    _accumulate(plot, h)
            if updateEvery and (it + 1) % updateEvery == 0 and \
                    (it + 1) < repeats:
                from .plotting import save_plot
                for plot in plots:
                    if plot.saveName:
                        save_plot(plot, plot.saveName)
            if pickleEvery and (it + 1) % pickleEvery == 0:
                for plot in plots:
                    if plot.persistentName:
                        plot.store_plots()
            if verbose:
                print(f'iteration {it + 1}/{repeats} done in '
                      f'{time.time() - t0:.3f}s')
        for plot in plots:
            if plot.persistentName:
                plot.store_plots()
            if plot.saveName:
                from .plotting import save_plot
                save_plot(plot, plot.saveName)

    t_run0 = time.time()
    with tracing() if verbose else contextlib.nullcontext():
        if generator is None:
            one_scan_point()
        else:
            for _ in generator(*generatorArgs):
                one_scan_point()
    if historyFile:
        store_run_history(t_run0, time.time(), tag=historyTag,
                          fileName=historyFile)
    if verbose:
        print(report())
    if afterScript:
        afterScript(*afterScriptArgs)
    return plots
