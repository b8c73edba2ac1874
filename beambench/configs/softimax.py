"""The SoftiMAX wave chain (xrt speed test 3) as the benchmark runs it.

``align_grating``, ``_pilot_dir``, ``_aim_yaw``, ``beamline``,
``build_chain`` and its ``run_chain`` are frozen copies of
``tools/torch_bench_softimax.py`` at commit f123111, with the optical
parameters read from ``softimax.json`` beside this file, and two additions
to ``run_chain``: *outputs* (a dict) receives the source field and each
Kirchhoff step's input beam and raw sums, for the check after the window,
and every step runs inside a ``torch.profiler.record_function`` span named
after it.  The yardstick stays fixed when the tool changes.

The coherent field of one undulator filament is propagated by consecutive
Kirchhoff integrals source -> FE slit -> M1 (toroid) -> M2 (plane) -> PG
(blazed grating, the cff = 1.6 collimated-mono pair with fixed exit) -> M3
(toroid) -> exit slit -> M4 -> M5 (elliptical cylinders, the KB pair) ->
three focal images around the sample focus.  The layout is laid down with
pilot rays in float64 on the host; each stage's Kirchhoff mode, and the
5 x 10 tile map of M1 -> M2 and M2 -> PG, are chosen at build time.

The driver functions at the end (``setup``, ``window``, ``check``) are what
``beambench/run.py`` calls.
"""
import math
from types import SimpleNamespace

import numpy as np

#: the Kirchhoff stages in chain order: (name, receiving element)
STAGES = (('m1', 'm1'), ('m2', 'm2'), ('pg', 'pg'), ('m3', 'm3'),
          ('es', 'exitSlit'), ('m4', 'm4'), ('m5', 'm5'))
#: every Kirchhoff step of a run with its sender: the seven stages and the
#: three focal images
STEPS = tuple(nm for nm, _ in STAGES) + ('scr0', 'scr1', 'scr2')
SENDERS = ('slit',) + tuple(nm for nm, _ in STAGES) + ('m5', 'm5')


def pairs_per_run(cfg):
    """Source x destination pairs of one chain run, from the
    configuration's shapes: seven wave-to-wave integrals of N x N and three
    focal integrals of N x n_scr^2."""
    n, m = int(cfg['nrays']), int(cfg['n_scr'])
    return 7 * n * n + 3 * n * m * m


def align_grating(E, m, cff, rho):
    """(alpha, beta) of the cff-constrained grating alignment (xrt speed
    test 3, align_grating)."""
    from xrt_tpu_torch.physconsts import CH
    order = abs(m) if cff > 1 else -abs(m)
    f1 = cff ** 2 + 1
    f2 = cff ** 2 - 1
    ml_d = order * rho * CH / E * 1e-7
    cosAlpha = math.sqrt(-ml_d ** 2 * f1 + 2 * abs(ml_d) *
                         math.sqrt(f2 ** 2 + cff ** 2 * ml_d ** 2)) / abs(f2)
    cosBeta = cff * cosAlpha
    return math.acos(cosAlpha), -math.acos(cosBeta)


def _pilot_dir(oe, origin, d, E0):
    """Outgoing direction of the central ray reflected by *oe*: four rays
    through the port's ``OE.reflect`` with the intersection search, float64
    on the CPU (the material is left out: it changes no direction)."""
    import torch
    from xrt_tpu_torch.beam import new_beam
    dt = torch.float64
    nray = 4
    b = new_beam(nray, energy=E0, withAmplitudes=True, dtype=dt,
                 device='cpu')

    def full(v):
        return torch.full((nray,), float(v), dtype=dt)
    b = b.replace(x=full(origin[0]), y=full(origin[1]), z=full(origin[2]),
                  a=full(d[0]), b=full(d[1]), c=full(d[2]))
    glo, loc = oe.replace(material=None).reflect(b)
    good = (loc.state == 1).numpy()
    if not good.any():
        raise RuntimeError(f'pilot ray missed {type(oe).__name__}')
    v = np.array([glo.a.numpy()[good].mean(), glo.b.numpy()[good].mean(),
                  glo.c.numpy()[good].mean()], float)
    return v / np.linalg.norm(v)


def _aim_yaw(d):
    """Yaw that turns an element's +y axis onto the horizontal projection
    of direction *d* (local +y maps to (-sin yaw, cos yaw, 0))."""
    return math.atan2(-d[0], d[1])


def beamline(cfg, dtype, device):
    """The SoftiMAX elements (dict), placed by pilot rays on the host."""
    from xrt_tpu_torch.apertures import RectangularAperture
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import (BlazedGrating, EllipticalMirrorParam,
                                   FlatMirror, ToroidMirror)
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import Undulator
    E0, u = cfg['E0'], cfg['undulator']
    pitch = math.radians(cfg['pitch_deg'])
    ah, av, p_fe = cfg['accept_h'], cfg['accept_v'], cfg['p_fe']
    mAu = Material.create(cfg['coating']['element'],
                          rho=cfg['coating']['rho'], kind='mirror',
                          dtype=dtype, device=device)
    src = Undulator.create(
        eE=u['eE'], eI=u['eI'], eEspread=0.0, eEpsilonX=0.0, eEpsilonZ=0.0,
        betaX=u['betaX'], betaZ=u['betaZ'], period=u['period'], n=u['n'],
        targetE=(E0, u['harmonic']), eMin=E0 - cfg['dE'],
        eMax=E0 + cfg['dE'], xPrimeMax=ah / 2 * 1e3, zPrimeMax=av / 2 * 1e3,
        xPrimeMaxAutoReduce=False, zPrimeMaxAutoReduce=False,
        gNodes=u['gNodes'], gIntervals=u['gIntervals'])
    slitFE = RectangularAperture.create(
        center=(0, p_fe, 0),
        opening=[-ah * p_fe / 2, ah * p_fe / 2, -av * p_fe / 2,
                 av * p_fe / 2])
    p_m1 = cfg['p_m1']
    rM1 = 2.0 * p_m1 * math.sin(pitch)
    m1 = ToroidMirror.create(
        center=(0, p_m1, 0), pitch=pitch, positionRoll=math.pi / 2,
        R=1e22, r=rM1, material=mAu, limPhysX=(-5, 5),
        limPhysY=(-150, 150))
    d1 = _pilot_dir(m1, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), E0)
    yaw1 = _aim_yaw(d1)
    c1 = np.array(m1.center, float)

    # the collimated-PGM pair (fixed exit +fixed_exit in z)
    alpha, beta = align_grating(E0, 1, cfg['cff'], cfg['rho_g'])
    incAng = alpha - beta
    fx, p_pg = cfg['fixed_exit'], cfg['p_pg']
    t = -fx / math.tan(incAng)
    m2 = FlatMirror.create(
        center=tuple(c1 + d1 * (p_pg - t)),
        pitch=(math.pi - incAng) / 2, yaw=yaw1, material=mAu,
        limPhysX=(-5, 5), limPhysY=(-225, 225))
    pg = BlazedGrating.create(
        center=tuple(c1 + d1 * p_pg + np.array([0, 0, fx])),
        pitch=-(beta + math.pi / 2), yaw=yaw1, positionRoll=math.pi,
        blaze=math.radians(cfg['blaze_deg']), rho=cfg['rho_g'],
        material=mAu, limPhysX=(-2, 2), limPhysY=(-40, 40))

    q_sag = cfg['q_m3_sag']
    rM3 = 2.0 * math.sin(pitch) * q_sag
    # xrt writes m3.pitch=-pitch with positionRoll=-pi/2; in the
    # Rz(yaw)Ry(roll)Rx(pitch) composition the same surface (normal facing
    # -x, leaning upstream) needs pitch=+pitch
    m3 = ToroidMirror.create(
        center=tuple(c1 + d1 * (p_pg + cfg['p_m3']) +
                     np.array([0, 0, fx])),
        pitch=pitch, yaw=yaw1, positionRoll=-math.pi / 2,
        R=1e22, r=rM3, material=mAu, limPhysX=(-10, 10),
        limPhysY=(-100, 100))
    c3 = np.array(m3.center, float)
    d3 = _pilot_dir(m3, tuple(c3 - d1 * 100.0), d1, E0)
    yaw3 = _aim_yaw(d3)

    exitSlit = RectangularAperture.create(
        center=tuple(c3 + d3 * q_sag),
        opening=[-cfg['es_dx'] / 2, cfg['es_dx'] / 2, -cfg['es_dz'] / 2,
                 cfg['es_dz'] / 2],
        x=(math.cos(yaw3), math.sin(yaw3), 0.0))

    d_m4_es, d_m45, p_exp = cfg['d_m4_es'], cfg['d_m45'], cfg['p_exp']
    m4 = EllipticalMirrorParam.create(
        center=tuple(c3 + d3 * (q_sag + d_m4_es)),
        p=cfg['m4_p'], q=d_m45 + p_exp, pitch=pitch, yaw=yaw3,
        positionRoll=math.pi / 2, isCylindrical=True, material=mAu,
        limPhysX=(-0.5, 0.5), limPhysY=(-70, 70))
    c4 = np.array(m4.center, float)
    d4 = _pilot_dir(m4, tuple(c4 - d3 * 100.0), d3, E0)
    yaw4 = _aim_yaw(d4)

    m5 = EllipticalMirrorParam.create(
        center=tuple(c4 + d4 * d_m45),
        p=d_m4_es + d_m45, q=p_exp, pitch=pitch, yaw=yaw4,
        isCylindrical=True, material=mAu,
        limPhysX=(-0.5, 0.5), limPhysY=(-40, 40))
    c5 = np.array(m5.center, float)
    d5 = _pilot_dir(m5, tuple(c5 - d4 * 100.0), d4, E0)

    screens = [Screen.create(center=tuple(c5 + d5 * (p_exp + dq)))
               for dq in cfg['d_focus']]
    return dict(src=src, slitFE=slitFE, m1=m1, m2=m2, pg=pg, m3=m3,
                exitSlit=exitSlit, m4=m4, m5=m5, screens=screens)


def build_chain(cfg, error_budget='auto', dtype=None, device=None,
                generator=None):
    """Build the beamline and its fixed wave geometry; return run_chain.

    The receiver samples are drawn from *generator* (a ``torch.Generator``
    on the CPU); each stage's mode and, with ``cfg['tiled']``, the 5 x 10
    tile map of every stage outside the recentred 'mxu*' envelopes, are
    chosen here on the host.  *error_budget*: per-stage relative field
    error for the mode choice ('auto' = the chain's Monte-Carlo noise floor
    3/sqrt(nrays)).

    ``run_chain(generator, timings=None, outputs=None)`` runs one full
    source -> focus propagation and returns the three focal images,
    (3, n_scr, n_scr) float64 numpy in xrt's absolute flux units.  The
    field is rescaled to unit RMS between stages; the accumulated scale is
    undone on the host.  Its *generator* feeds the source's e-beam draws;
    *timings* (a list) receives one ``wavechain.StageTimer`` record per
    step; *outputs* (a dict) receives 'shine', the source field on the slit
    samples before its rescale, and for each step of :data:`STEPS` its
    input beam and the wave it returns."""
    import torch
    from torch.profiler import record_function
    from xrt_tpu_torch import config
    from xrt_tpu_torch.wavechain import StageTimer
    from xrt_tpu_torch.waves import (choose_kirchhoff_mode,
                                     choose_tile_modes, diffract,
                                     prepare_wave_on_aperture,
                                     prepare_wave_on_oe,
                                     prepare_wave_on_screen, reflect_wave,
                                     rescale_field, tile_pairs_by_mode)
    nrays, n_scr, E0 = int(cfg['nrays']), int(cfg['n_scr']), cfg['E0']
    dt = config.resolve_dtype(dtype)
    dev = config.resolve_device(device)
    if error_budget == 'auto':
        error_budget = 3.0 / math.sqrt(nrays)
    el = beamline(cfg, dt, dev)
    src = el['src']
    areaFraction = el['pg'].get_grating_area_fraction()
    half = cfg['image_half']
    px = np.linspace(-half, half, n_scr)

    kw = dict(generator=generator, dtype=dt, device=dev)
    waves = {'slit': prepare_wave_on_aperture(el['slitFE'], src, nrays,
                                              **kw)}
    prev_el = el['slitFE']
    for name, rec in STAGES:
        if rec == 'exitSlit':
            w = prepare_wave_on_aperture(el[rec], prev_el, nrays, **kw)
        else:
            w = prepare_wave_on_oe(el[rec], prev_el, nrays, sort='y', **kw)
        waves[name], prev_el = w, el[rec]
    for i, scr in enumerate(el['screens']):
        waves[f'scr{i}'] = prepare_wave_on_screen(scr, el['m5'], px, px,
                                                  dtype=dt, device=dev)

    modes, tilemaps = {}, {}
    for name, sender in zip(STEPS, SENDERS):
        w, s = waves[name], waves[sender]
        dst = (w.xDiffr, w.yDiffr, w.zDiffr)
        srcxyz = (s.x, s.y, s.z)
        modes[name] = choose_kirchhoff_mode(dst, srcxyz,
                                            error_budget=error_budget)
        if cfg['tiled'] and not (modes[name][0] == 'recentred' and
                                 modes[name][1].startswith('mxu')):
            tilemaps[name] = choose_tile_modes(dst, srcxyz, 5, 10,
                                               error_budget=error_budget)

    def run_chain(generator, timings=None, outputs=None):
        scale = []

        def resc(b):
            b, ls = rescale_field(b)
            scale.append(ls)
            return b

        def dif(name, cur):
            pm, acc = modes[name]
            tm = tilemaps.get(name)
            rec = dict(stage=name, mode=(pm, acc))
            if tm is not None:
                rec['tiles'] = tile_pairs_by_mode(tm)
            with record_function(f'stage:{name}'):
                mark = StageTimer(timings, rec, cur.x.device)
                out = diffract(cur, waves[name], phase_mode=pm,
                               monochromatic=True, accumulate=acc,
                               tile_modes=tm, narrowband=False,
                               check_envelope=False)
                mark.stop()
            if outputs is not None:
                outputs[name] = (cur, out)
            return out

        with record_function('stage:shine'):
            mark = StageTimer(timings, dict(stage='shine', mode=None), dev)
            cur = src.shine_wave(generator, waves['slit'], E0)
            mark.stop()
        if outputs is not None:
            outputs['shine'] = cur
        cur = resc(cur)
        for name, rec in STAGES:
            b = dif(name, cur)
            if rec == 'exitSlit':
                cur = resc(b)
                continue
            with record_function(f'reflect:{name}'):
                # reflect_wave keeps the receiver's exact local coordinates
                _, loc = reflect_wave(el[rec], b, generator)
                if name == 'pg':
                    # the illuminated fraction of the sawtooth period
                    # scales the radiating area
                    loc = loc.replace(area=loc.area * areaFraction)
                cur = resc(loc)
        imgs = [dif(f'scr{i}', cur) for i in range(3)]
        logs = float(torch.stack(scale).sum())
        out = np.stack([(o.Jss + o.Jpp).reshape(n_scr, n_scr).double()
                        .cpu().numpy() for o in imgs])
        return out * math.exp(-2.0 * logs)

    run_chain.elements = el
    run_chain.waves = waves
    run_chain.modes = modes
    run_chain.tilemaps = tilemaps
    return run_chain


def launches(run_chain):
    """[(kernel name as ``ops.kirchhoff.LAUNCHES`` counts it, destinations,
    sources)] of the forward Kirchhoff launches of one chain run, from the
    stage modes and tile maps chosen at build time: one launch a stage, or
    one a tile pair (the clouds cut into uniform tiles by ceiling
    division)."""
    out = []
    for name, sender in zip(STEPS, SENDERS):
        nd = int(run_chain.waves[name].xDiffr.shape[0])
        ns = int(run_chain.waves[sender].x.shape[0])
        tm = run_chain.tilemaps.get(name)
        if tm is None:
            out.append((_kernel(run_chain.modes[name]), nd, ns))
            continue
        td, ts = -(-nd // len(tm)), -(-ns // len(tm[0]))
        for row in tm:
            out += [(_kernel(m), td, ts) for m in row]
    return out


def _kernel(mode):
    pm = mode[0]
    return 'kirchhoff_recentred:mono' if pm == 'recentred' else \
        f'kirchhoff_ddphase:{pm}'


# ---------------------------------------------------------------------------
# the driver: set-up, the measured window and the check
# ---------------------------------------------------------------------------

def setup(cfg, traffic, cell, seed, device):
    """Build the chain on receiver samples drawn from *seed*, and run it
    once: that loads the kernels and warms every shape the window uses."""
    import time
    import torch
    t0 = time.perf_counter()
    st = SimpleNamespace()
    st.cfg, st.traffic, st.cell = cfg, traffic, cell
    st.device, st.seed = device, seed
    st.run_chain = build_chain(cfg, device=device,
                               generator=torch.Generator().manual_seed(seed))
    # the e-beam draws of the runs (a CPU generator, as the chain takes it)
    st.generator = torch.Generator().manual_seed(seed + 1)
    st.pairs = pairs_per_run(cfg)
    st.launches = launches(st.run_chain)
    st.times = dict(build=time.perf_counter() - t0)
    st.run_chain(st.generator)
    st.times['warm_up'] = time.perf_counter() - t0 - st.times['build']
    return st


def window(st, seconds, clock, trace):
    """Chain runs back to back until *seconds* have passed; each run ends
    with its images on the host.  The run whose raw sums the check reads is
    drawn from the seed among the first ``cell['check']['runs']``."""
    import torch
    check_runs = int(st.cell['check']['runs'])
    st.checked_run = int(torch.randint(
        check_runs, (1,), generator=torch.Generator().manual_seed(
            st.seed + 2)))
    units, timings = [], []
    t_start = clock()
    k = 0
    while True:
        outs = {} if k == st.checked_run else None
        tim = [] if trace else None
        t0 = clock()
        imgs = st.run_chain(st.generator, timings=tim, outputs=outs)
        t1 = clock()
        units.append(dict(t0=t0, t1=t1, work=st.pairs, kind='pairs'))
        if tim is not None:
            timings.append(tim)
        if outs is not None:
            st.outputs, st.images = outs, imgs
        k += 1
        if t1 - t_start >= seconds and k > st.checked_run:
            break
    spans = {}
    if trace:
        if st.device != 'cpu':
            torch.cuda.synchronize()
        for tim in timings:
            for rec in tim:
                ms = rec['start'].elapsed_time(rec['end']) \
                    if 'start' in rec else 1e3 * rec['seconds']
                spans.setdefault(f"step:{rec['stage']}", []).append(ms)
    return dict(units=units, spans=spans,
                launches=st.launches * len(units),
                kernel_names=('forward_kernel', 'reduce_kernel'))


def free_program(st):
    """Keep what the check reads (the checked run's source field, each
    step's input beam and raw sums, the receiving geometry) and drop the
    rest of the program's state."""
    rc = st.run_chain
    keep = {}
    for name in STEPS:
        w = rc.waves[name]
        keep[name] = dict(
            dst=(w.xDiffr, w.xDiffr_lo, w.yDiffr, w.yDiffr_lo, w.zDiffr,
                 w.zDiffr_lo),
            src_beam=st.outputs[name][0],
            EsAcc=st.outputs[name][1].EsAcc,
            EpAcc=st.outputs[name][1].EpAcc)
    w = rc.waves['slit']
    keep['shine'] = dict(
        dst=(w.xDiffr, w.xDiffr_lo, w.yDiffr, w.yDiffr_lo, w.zDiffr,
             w.zDiffr_lo), Es=st.outputs['shine'].Es,
        Ep=st.outputs['shine'].Ep)
    st.keep = keep
    del st.run_chain, st.outputs


def check(st, seed, lowered=False):
    """The numbers compared with the plain reference (see
    ``beambench/references/softimax.py``): {name: value}."""
    import harness
    ref = harness.load_module('references', 'softimax')
    return ref.compare(st.cfg, st.keep, st.images, seed,
                       n_dst=int(st.cell['check']['destinations']),
                       lowered=lowered)
