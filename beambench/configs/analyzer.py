"""The diced Johansson analyzer (xrt speed test 1) as the benchmark runs it.

``build`` is a frozen copy of ``tools/torch_bench_analyzer.py`` at commit
f123111, with the parameters read from ``analyzer.json`` beside this file,
so that the yardstick stays fixed when the tool changes.  A diced Johansson
2D-bent Si(444) analyzer (R = 500 mm, theta = 60 deg, facets 2.1 x 1.4 mm
with 0.05 mm gaps) is traced from three geometric sources (a flat energy
band, one line, seven lines), each pass filling xrt's three plots: the
crystal's footprint at 400 x 400 and 128 x 128 and the detector image at
128 x 128.

The window runs ``runner.run_ray_tracing`` for each source in turn, as the
speed test does, with every axis limit fixed (the energy axis at (eMin,
eMax)), so the runner makes no calibration pass.  The tools loop that
histograms with ``histogram.hist2d`` directly is not used: it bypasses the
runner and ``hist_plot``.

The driver functions at the end (``setup``, ``window``, ``free_program``,
``check``) are what ``beambench/run.py`` calls.
"""
import math
from types import SimpleNamespace


def build(cfg, nrays, dtype=None, device=None):
    """(sources, analyzer, detector, (eMin, eMax)) of speed test 1."""
    import torch
    from xrt_tpu_torch.materials import CrystalDiamond
    from xrt_tpu_torch.oes import DicedJohanssonToroid
    from xrt_tpu_torch.physconsts import CH
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    dtype = torch.float32 if dtype is None else dtype
    cr, fc = cfg['crystal'], cfg['facet']
    crystal = CrystalDiamond.create(hkl=tuple(cr['hkl']),
                                    d=cr['d111'] / cr['hkl'][0],
                                    elements=cr['element'], rho=cr['rho'],
                                    name=cr['element'], dtype=dtype,
                                    device=device)
    R = cfg['R']
    dxc, dyc = cfg['crystal_size']
    theta = math.radians(cfg['theta_deg'])
    sinTheta = math.sin(theta)
    d = float(crystal.d)
    dTheta = float(crystal.get_dtheta_symmetric_Bragg(
        CH / (2 * d * sinTheta)))
    E0 = CH / (2 * d * math.sin(theta + dTheta))
    p = q = 2.0 * R * sinTheta
    Rs = 2.0 * R * sinTheta ** 2
    sin2T, cos2T = math.sin(2 * theta), math.cos(2 * theta)
    pdp = 2.0 * R * math.sin(theta - dyc / 6 / R)
    analyzer = DicedJohanssonToroid.create(
        dxFacet=fc['dx'], dyFacet=fc['dy'], dxGap=fc['dx_gap'],
        dyGap=fc['dy_gap'], Rm=R, Rs=Rs, material=crystal,
        center=(0, p, 0), pitch=theta,
        limPhysX=(-dxc / 2, dxc / 2), limPhysY=(-dyc / 2, dyc / 2))
    detector = Screen.create(center=(0, p + q * cos2T, q * sin2T),
                             x=(1, 0, 0), z=(0, -sin2T, cos2T))

    def source(distE, energies):
        return GeometricSource.create(
            nrays=nrays, dx=cfg['beam_h'], dz=cfg['beam_v'],
            distxprime='flat', dxprime=dxc / pdp,
            distzprime='flat', dzprime=dyc * sinTheta / pdp,
            distE=distE, energies=energies, polarization=None,
            dtype=dtype, device=device)

    eMin, eMax = E0 * (1 - cfg['e_axis_flat']), E0 * (1 + cfg['e_axis_flat'])
    dE = E0 * cfg['e_axis_flat'] * cfg['line_step']
    sources = []
    for s in cfg['sources']:
        if s['distE'] == 'flat':
            sources.append(source('flat', (eMin, eMax)))
        else:
            sources.append(source('lines', tuple(E0 + i * dE
                                                 for i in s['lines'])))
    return sources, analyzer, detector, (eMin, eMax)


def make_plots(cfg, eLimits):
    """xrt's three plots of the speed test, every axis limit fixed."""
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    plots = []
    for p in cfg['plots']:
        plots.append(XYCPlot(
            beam=p['beam'],
            xaxis=XYCAxis(p['x'], 'mm', data=p['x'], bins=p['bins'],
                          ppb=1, limits=list(p['xlim'])),
            yaxis=XYCAxis(p['y'], 'mm', data=p['y'], bins=p['bins'],
                          ppb=1, limits=list(p['ylim'])),
            caxis=XYCAxis('energy', 'eV', data='energy',
                          bins=cfg['c_bins'], limits=list(eLimits))))
    return plots


# ---------------------------------------------------------------------------
# the driver: set-up, the measured window and the check
# ---------------------------------------------------------------------------

class WindowClosed(Exception):
    """Raised at the start of the first pass after the window's end."""


class _Recorder:
    """Its ``step`` is the speed test's ``run_process`` (shine, reflect,
    expose).  It times each pass from the start of its ``run_process`` to
    the start of the next one, closes the window at the first pass that
    would start after it, and keeps the beams and plot totals of the
    checked passes ({source index: pass index in its first block})."""

    def __init__(self, nrays, checked, clock, deadline, trace):
        self.nrays, self.checked = nrays, checked
        self.clock, self.deadline, self.trace = clock, deadline, trace
        self.units, self.process_ms, self.events = [], [], []
        self.t0 = None
        self.pending = None       # (checked key, plots) awaiting its totals
        self.block = None         # (source index, pass index in the block)
        self.kept = {}

    def close_previous(self, now):
        if self.t0 is not None:
            self.units.append(dict(t0=self.t0, t1=now, work=self.nrays,
                                   kind='rays'))
            self.t0 = None
        if self.pending is not None:
            key, plots = self.pending
            self.kept[key]['after'] = _totals(plots)
            self.pending = None

    def step(self, beamLine, rng):
        import torch
        from torch.profiler import record_function
        now = self.clock()
        self.close_previous(now)
        if now >= self.deadline:
            raise WindowClosed
        self.t0 = now
        si, j = self.block
        self.block = (si, j + 1)
        key = (si, j)
        checked = self.checked.get(si) == j and key not in self.kept
        if checked:
            self.kept[key] = dict(before=_totals(beamLine['plots']),
                                  limits=[(tuple(p.xaxis.limits),
                                           tuple(p.yaxis.limits),
                                           tuple(p.caxis.limits))
                                          for p in beamLine['plots']])
            self.pending = (key, beamLine['plots'])
        src = beamLine['sources'][si]
        with record_function('source.shine'):
            beam = src.shine(rng)
        cuda = self.trace and beam.x.device.type == 'cuda'
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t_reflect = self.clock()
        with record_function('oe.reflect'):
            glo, loc = beamLine['analyzer'].reflect(beam, rng)
        if cuda:
            ev[1].record()
            self.events.append(ev)
        elif self.trace:
            self.events.append(1e3 * (self.clock() - t_reflect))
        with record_function('screen.expose'):
            det = beamLine['detector'].expose(glo)
        if checked:
            self.kept[key].update(source=beam, glo=glo, loc=loc, det=det)
        self.process_ms.append(1e3 * (self.clock() - now))
        return {'local': loc, 'detector': det}


def _totals(plots):
    return [dict(total2D=p.total2D.copy(), x=p.total1D_x.copy(),
                 y=p.total1D_y.copy(), c=p.total1D_c.copy())
            for p in plots]


def _beamline(st):
    """The ``beamLine`` of one ``run_ray_tracing`` call: the elements and
    fresh plots."""
    return dict(sources=st.sources, analyzer=st.analyzer,
                detector=st.detector, plots=make_plots(st.cfg, st.eLimits))


def setup(cfg, traffic, cell, seed, device):
    """Build the beamline, and trace one pass of each source through the
    runner: that loads the histogram kernel and warms every shape the
    window uses."""
    import time
    import torch
    from xrt_tpu_torch.runner import run_ray_tracing
    t0 = time.perf_counter()
    st = SimpleNamespace()
    st.cfg, st.traffic, st.cell = cfg, traffic, cell
    st.device, st.seed = device, seed
    # the rays of a pass: the speed test's, or the traffic's own
    st.nrays = int(traffic.get('nrays', cfg['nrays']))
    st.sources, st.analyzer, st.detector, st.eLimits = build(
        cfg, st.nrays, device=device)
    st.times = dict(build=time.perf_counter() - t0)
    names = [s['name'] for s in cfg['sources']]
    st.order = [names.index(n) for n in traffic['order']]
    st.gen = torch.Generator(device).manual_seed(seed)
    # the checked pass of each source: one of the first passes of its
    # first block, drawn from the seed (never the block's last, whose
    # totals the next pass of the same call closes)
    npass = min(int(cell['check']['passes']), int(traffic['repeats']) - 1)
    g = torch.Generator().manual_seed(seed + 1)
    st.checked = {si: int(torch.randint(npass, (1,), generator=g))
                  for si in st.order}
    rec = _Recorder(st.nrays, {}, time.perf_counter, float('inf'), False)
    for si in st.order:
        rec.block = (si, 0)
        bl = _beamline(st)
        run_ray_tracing(bl['plots'], repeats=1, beamLine=bl,
                        run_process=rec.step, rng=st.gen)
        if device != 'cpu':
            torch.cuda.synchronize()
        st.times[f'warm_up_{si}'] = time.perf_counter() - t0 - \
            sum(st.times.values())
    return st


def window(st, seconds, clock, trace):
    """The sources in turn, each through ``run_ray_tracing`` with the
    traffic's repeats, until *seconds* have passed: the pass that would
    start after that is not started."""
    import torch
    from xrt_tpu_torch.runner import run_ray_tracing
    start = clock()
    rec = _Recorder(st.nrays, st.checked, clock, start + seconds, trace)
    shapes = [(st.nrays, p['bins'], p['bins'], st.cfg['c_bins'])
              for p in st.cfg['plots']]
    try:
        while True:
            for si in st.order:
                rec.block = (si, 0)
                bl = _beamline(st)
                run_ray_tracing(bl['plots'],
                                repeats=int(st.traffic['repeats']),
                                beamLine=bl, run_process=rec.step,
                                rng=st.gen)
                rec.close_previous(clock())
    except WindowClosed:
        pass
    spans = dict(run_process=rec.process_ms[:len(rec.units)])
    if trace:
        if st.device != 'cpu':
            torch.cuda.synchronize()
        spans['reflect'] = [e if isinstance(e, float) else
                            e[0].elapsed_time(e[1]) for e in rec.events]
    hist_launches = shapes * len(rec.units)
    st.kept = rec.kept
    return dict(units=rec.units, spans=spans, hist_launches=hist_launches,
                kernel_names=('plot_',))


def free_program(st):
    """Keep the checked passes' beams and plot totals; drop the rest."""
    del st.sources, st.analyzer, st.detector


def check(st, seed, lowered=False):
    """The numbers compared with the plain reference (see
    ``beambench/references/analyzer.py``): {name: value}."""
    import harness
    ref = harness.load_module('references', 'analyzer')
    return ref.compare(st.cfg, st.kept, lowered=lowered)
