"""BASELINE configuration 3 in the near field as the benchmark runs it.

The beamline of ``tests/test_baseline_configs.py``'s configuration 3 with
the parameters read from ``config3.json`` beside this file: a 2 m
in-vacuum undulator (3 GeV, 0.5 A, 111 periods of 18 mm, K tuned to 9000
eV on the 7th harmonic) observed at R0 = 30 m, so that its radiation
integral runs over every period (xrt's near field, in float64 as xrt
forces it), shines 1e5 rays a pass between 8960 and 9040 eV; a flat
Si(111) double-crystal monochromator at 30 m (fixed exit 20 mm) takes
them, a screen 1 m after it exposes them, and one XYCPlot histograms the
total flux over +-1 mm at 128 x 128 bins with 128 energy bins over
8990-9010 eV.

The window runs ``runner.run_ray_tracing`` with the beamline's
``run_process`` (``src.shine``, ``dcm.double_reflect``,
``screen.expose``), every axis limit fixed, so the runner makes no
calibration pass.  Each pass draws the shine's random numbers from the
run's generator exactly as the source would (``Undulator._draws``: on the
card, in the beam's dtype) and hands them to ``shine(draws=)``, so the
checked pass's draws can go to the plain reference.

The functions at the end (``setup``, ``window``, ``free_program``,
``check``) are what ``beambench/run.py`` calls.
"""
from types import SimpleNamespace


def build(cfg, device=None):
    """(source, DCM, screen) of configuration 3."""
    import torch
    from xrt_tpu_torch.materials import CrystalSi
    from xrt_tpu_torch.oes import DCM
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import Undulator
    u, m, s = cfg['undulator'], cfg['dcm'], cfg['screen']
    dk = dict(dtype=getattr(torch, cfg['dtype']), device=device)
    src = Undulator.create(
        nrays=int(cfg['nrays']), eE=u['eE'], eI=u['eI'],
        period=u['period'], n=u['n'], targetE=tuple(u['targetE']),
        eEpsilonX=u['eEpsilonX'], eEpsilonZ=u['eEpsilonZ'],
        betaX=u['betaX'], betaZ=u['betaZ'], eEspread=u['eEspread'],
        eMin=u['eMin'], eMax=u['eMax'], xPrimeMax=u['xPrimeMax'],
        zPrimeMax=u['zPrimeMax'], R0=u['R0'], distE=u['distE'],
        oversample=u['oversample'], gNodes=u['gNodes'],
        gIntervals=u['gIntervals'], **dk)
    dcm = DCM.create(center=(0, m['center_y'], 0),
                     material=CrystalSi.create(hkl=tuple(m['hkl']), **dk),
                     alignE=m['alignE'], fixedOffset=m['fixedOffset'],
                     limPhysX=tuple(m['limPhysX']),
                     limPhysY=tuple(m['limPhysY']))
    return src, dcm, Screen.create(center=(0, s['y'], s['z']))


def make_plot(cfg):
    """The cell's plot, every axis limit fixed."""
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    p = cfg['plot']
    lim = [-p['half'], p['half']]
    return XYCPlot(
        beam=p['beam'], fluxKind=p['fluxKind'],
        xaxis=XYCAxis('x', 'mm', data='x', bins=p['bins'], limits=lim),
        yaxis=XYCAxis('z', 'mm', data='z', bins=p['bins'], limits=lim),
        caxis=XYCAxis('energy', 'eV', data='energy', bins=p['c_bins'],
                      limits=list(p['c_limits'])))


# ---------------------------------------------------------------------------
# set-up, the measured window and the check
# ---------------------------------------------------------------------------

class WindowClosed(Exception):
    """Raised at the start of the first pass after the window's end."""


class _Recorder:
    """Its ``step`` is the beamline's ``run_process`` (shine, the DCM,
    expose).  It times each pass from the start of its ``run_process`` to
    the start of the next one, closes the window at the first pass that
    would start after it, keeps the host ms of each ``run_process``
    (``process_ms``), and keeps the draws, beams and plot totals of the
    checked pass (the *checked*-th of the first ``run_ray_tracing`` call;
    None checks none)."""

    def __init__(self, st, checked, clock, deadline):
        self.st, self.checked = st, checked
        self.clock, self.deadline = clock, deadline
        self.units, self.process_ms, self.npass = [], [], 0
        self.t0 = None
        self.kept = {}
        self.pending = None       # the plot awaiting its totals

    def close_previous(self, now):
        if self.t0 is not None:
            self.units.append(dict(t0=self.t0, t1=now,
                                   work=self.st.src.nrays, kind='rays'))
            self.t0 = None
        if self.pending is not None:
            self.kept['after'] = _totals(self.pending)
            self.pending = None

    def step(self, beamLine, rng):
        from xrt_tpu_torch import config
        now = self.clock()
        self.close_previous(now)
        if now >= self.deadline:
            raise WindowClosed
        self.t0 = now
        checked = self.npass == self.checked
        self.npass += 1
        src = self.st.src
        if checked:
            plot = beamLine['plot']
            self.kept.update(before=_totals(plot), limits=(
                tuple(plot.xaxis.limits), tuple(plot.yaxis.limits),
                tuple(plot.caxis.limits)))
            self.pending = plot
        draws = src._draws(rng, None, config.resolve_dtype(src.dtype),
                           config.resolve_device(src.device),
                           src.nrays * src.oversample, src.nrays)
        beam = src.shine(rng, draws=draws)
        mono = self.st.dcm.double_reflect(beam, rng)[0]
        scr = self.st.screen.expose(mono)
        if checked:
            self.kept.update(
                draws=draws,
                source={k: getattr(beam, k) for k in (
                    'E', 'a', 'b', 'c', 'Jss', 'Jpp', 'Jsp', 'accepted')},
                dcm={k: getattr(mono, k) for k in (
                    'Jss', 'Jpp', 'Jsp', 'state')},
                screen={k: getattr(scr, k) for k in (
                    'x', 'z', 'E', 'Jss', 'Jpp', 'state')})
        self.process_ms.append(1e3 * (self.clock() - now))
        return {self.st.cfg['plot']['beam']: scr}


def _totals(plot):
    return dict(total2D=plot.total2D.copy(), c=plot.total1D_c.copy())


def _run(st, rec, repeats):
    """One ``run_ray_tracing`` call of *repeats* passes into a fresh plot."""
    from xrt_tpu_torch.runner import run_ray_tracing
    plot = make_plot(st.cfg)
    run_ray_tracing([plot], repeats=repeats, beamLine=dict(plot=plot),
                    run_process=rec.step, rng=st.gen)
    rec.close_previous(rec.clock())


def setup(cfg, traffic, cell, seed, device):
    """Build the beamline and trace one pass through the runner: that
    warms every shape the window uses (the integral's ray blocks, the
    DCM and the plot's kernel)."""
    import time
    import torch
    t0 = time.perf_counter()
    st = SimpleNamespace(cfg=cfg, traffic=traffic, cell=cell, seed=seed,
                         device=device)
    st.src, st.dcm, st.screen = build(cfg, device)
    st.times = dict(build=time.perf_counter() - t0)
    st.gen = torch.Generator(device).manual_seed(seed)
    # the checked pass: one of the first passes of the window's first call,
    # drawn from the seed (never its last, whose totals the next pass of
    # the same call closes)
    npass = min(int(cell['check']['passes']), int(traffic['repeats']) - 1)
    g = torch.Generator().manual_seed(seed + 1)
    st.checked = int(torch.randint(npass, (1,), generator=g))
    _run(st, _Recorder(st, None, time.perf_counter, float('inf')), 1)
    if device != 'cpu':
        torch.cuda.synchronize()
    st.times['warm_up'] = time.perf_counter() - t0 - st.times['build']
    return st


def window(st, seconds, clock, trace):
    """``run_ray_tracing`` calls of the traffic's repeats, each into a fresh
    plot, until *seconds* have passed: the pass that would start after
    that is not started.  Every pass fills the one plot with one
    ``hist_plot`` launch of the screen's rays."""
    rec = _Recorder(st, st.checked, clock, clock() + seconds)
    try:
        while True:
            _run(st, rec, int(st.traffic['repeats']))
    except WindowClosed:
        pass
    st.kept = rec.kept
    p = st.cfg['plot']
    shape = (st.src.nrays, p['bins'], p['bins'], p['c_bins'])
    return dict(units=rec.units,
                spans=dict(run_process=rec.process_ms[:len(rec.units)]),
                hist_launches=[shape] * len(rec.units),
                kernel_names=('plot_',))


def free_program(st):
    """Keep the checked pass's draws, beams and plot totals; drop the
    rest."""
    del st.src, st.dcm, st.screen


def check(st, seed, lowered=False):
    """The numbers compared with the plain reference (see
    ``beambench/references/config3.py``): {name: value}."""
    import harness
    ref = harness.load_module('references', 'config3')
    return ref.compare(st.cfg, st.kept, lowered=lowered)
