"""The SoftiMAX wave chain on the PyTorch port: speed test 3 of xrt.

Beamline (xrt tests/speed/3_Softi_CXIw2D_speed.py and
examples/withRaycing/14_SoftiMAX/Softi_CXIw2D.py): the coherent field of
one undulator filament is propagated by consecutive Kirchhoff integrals
source -> FE slit -> M1 (toroid) -> M2 (plane) -> PG (blazed grating, the
cff = 1.6 collimated-mono pair with fixed exit) -> M3 (toroid) -> exit slit
-> M4 -> M5 (elliptical cylinders, the KB pair) -> three 64 x 64 focal
images at -50 / 0 / +50 mm around the sample focus.  With 2e5 samples per
wave the seven wave-to-wave integrals are 4e10 pairs each, plus three
focal integrals of 2e5 x 4096 pairs.

The optical parameters are xrt's own; the layout is laid down with pilot
rays (each next element is centred on the traced central ray), in float64
on the host whatever the chain's dtype, so float32 and float64 chains
integrate the same geometry.  Each stage's Kirchhoff mode is chosen on the
host at build time (``waves.choose_kirchhoff_mode``); with ``tiled=True``
the stages outside the recentred 'mxu*' envelopes (M1 -> M2, M2 -> PG) run
by 5 x 10 tile pairs, each with its own mode (``waves.choose_tile_modes``):
the contact tiles of M2 -> PG go to the per-pair double-float kernel (B2),
the rest to the recentred kernel (B1).  The chain runs eagerly, stage by
stage, so no separate path is needed for large sample counts.

    python tools/torch_bench_softimax.py [--smoke] [--nrays=N] [--nscr=N]
        [--untiled] [--f64]

runs on the CUDA card: build time, each stage's mode and time, the chain
time (best of 3 after a warm-up) and pairs/s, and the focal images' totals
and peaks.  ``--smoke`` is 4000 samples on 32 x 32 images; ``--f64`` runs
the chain once more in float64 on the same receiver samples and compares
the images.
"""
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

E0 = 280.0
DE = 0.5
ACCEPT_H = 2.2e-4       # FE acceptance, full angle, rad
ACCEPT_V = 4.2e-4
P_FE = 19250.0
P_M1 = 24000.0
P_PG = 2000.0           # M1 -> PG
P_M3 = 2800.0           # PG -> M3
Q_M3_SAG = 12000.0
D_M4_ES = 2200.0
D_M45 = 3200.0
P_EXP = 1800.0
PITCH = math.radians(1.0)
CFF = 1.6
FIXED_EXIT = 20.0       # mm
RHO_G = 300.0           # lines/mm
BLAZE = math.radians(0.6)
ES_DX = 2.0             # exit slit, mm
ES_DZ = 0.1
D_FOCUS = (-50.0, 0.0, 50.0)
IMAGE_HALF = 0.05       # +-50 um focal image extent
#: the Kirchhoff stages in chain order: (name, receiving element)
STAGES = (('m1', 'm1'), ('m2', 'm2'), ('pg', 'pg'), ('m3', 'm3'),
          ('es', 'exitSlit'), ('m4', 'm4'), ('m5', 'm5'))


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


def _pilot_dir(oe, origin, d):
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


def beamline(dtype, device):
    """The SoftiMAX elements (dict), placed by pilot rays on the host."""
    from xrt_tpu_torch.apertures import RectangularAperture
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import (BlazedGrating, EllipticalMirrorParam,
                                   FlatMirror, ToroidMirror)
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import Undulator
    mAu = Material.create('Au', rho=19.32, kind='mirror', dtype=dtype,
                          device=device)
    src = Undulator.create(
        eE=3.0, eI=0.5, eEspread=0.0, eEpsilonX=0.0, eEpsilonZ=0.0,
        betaX=9.0, betaZ=2.0, period=48.0, n=77, targetE=(E0, 1),
        eMin=E0 - DE, eMax=E0 + DE,
        xPrimeMax=ACCEPT_H / 2 * 1e3, zPrimeMax=ACCEPT_V / 2 * 1e3,
        xPrimeMaxAutoReduce=False, zPrimeMaxAutoReduce=False,
        gNodes=402, gIntervals=2)
    slitFE = RectangularAperture.create(
        center=(0, P_FE, 0),
        opening=[-ACCEPT_H * P_FE / 2, ACCEPT_H * P_FE / 2,
                 -ACCEPT_V * P_FE / 2, ACCEPT_V * P_FE / 2])
    rM1 = 2.0 * P_M1 * math.sin(PITCH)
    m1 = ToroidMirror.create(
        center=(0, P_M1, 0), pitch=PITCH, positionRoll=math.pi / 2,
        R=1e22, r=rM1, material=mAu, limPhysX=(-5, 5),
        limPhysY=(-150, 150))
    d1 = _pilot_dir(m1, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    yaw1 = _aim_yaw(d1)
    c1 = np.array(m1.center, float)

    # the collimated-PGM pair (fixed exit +FIXED_EXIT in z)
    alpha, beta = align_grating(E0, 1, CFF, RHO_G)
    incAng = alpha - beta
    t = -FIXED_EXIT / math.tan(incAng)
    m2 = FlatMirror.create(
        center=tuple(c1 + d1 * (P_PG - t)),
        pitch=(math.pi - incAng) / 2, yaw=yaw1, material=mAu,
        limPhysX=(-5, 5), limPhysY=(-225, 225))
    pg = BlazedGrating.create(
        center=tuple(c1 + d1 * P_PG + np.array([0, 0, FIXED_EXIT])),
        pitch=-(beta + math.pi / 2), yaw=yaw1, positionRoll=math.pi,
        blaze=BLAZE, rho=RHO_G, material=mAu,
        limPhysX=(-2, 2), limPhysY=(-40, 40))

    rM3 = 2.0 * math.sin(PITCH) * Q_M3_SAG
    # xrt writes m3.pitch=-pitch with positionRoll=-pi/2; in the
    # Rz(yaw)Ry(roll)Rx(pitch) composition the same surface (normal facing
    # -x, leaning upstream) needs pitch=+PITCH
    m3 = ToroidMirror.create(
        center=tuple(c1 + d1 * (P_PG + P_M3) + np.array([0, 0,
                                                         FIXED_EXIT])),
        pitch=PITCH, yaw=yaw1, positionRoll=-math.pi / 2,
        R=1e22, r=rM3, material=mAu, limPhysX=(-10, 10),
        limPhysY=(-100, 100))
    c3 = np.array(m3.center, float)
    d3 = _pilot_dir(m3, tuple(c3 - d1 * 100.0), d1)
    yaw3 = _aim_yaw(d3)

    exitSlit = RectangularAperture.create(
        center=tuple(c3 + d3 * Q_M3_SAG),
        opening=[-ES_DX / 2, ES_DX / 2, -ES_DZ / 2, ES_DZ / 2],
        x=(math.cos(yaw3), math.sin(yaw3), 0.0))

    m4 = EllipticalMirrorParam.create(
        center=tuple(c3 + d3 * (Q_M3_SAG + D_M4_ES)),
        p=43000.0, q=D_M45 + P_EXP, pitch=PITCH, yaw=yaw3,
        positionRoll=math.pi / 2, isCylindrical=True, material=mAu,
        limPhysX=(-0.5, 0.5), limPhysY=(-70, 70))
    c4 = np.array(m4.center, float)
    d4 = _pilot_dir(m4, tuple(c4 - d3 * 100.0), d3)
    yaw4 = _aim_yaw(d4)

    m5 = EllipticalMirrorParam.create(
        center=tuple(c4 + d4 * D_M45),
        p=D_M4_ES + D_M45, q=P_EXP, pitch=PITCH, yaw=yaw4,
        isCylindrical=True, material=mAu,
        limPhysX=(-0.5, 0.5), limPhysY=(-40, 40))
    c5 = np.array(m5.center, float)
    d5 = _pilot_dir(m5, tuple(c5 - d4 * 100.0), d4)

    screens = [Screen.create(center=tuple(c5 + d5 * (P_EXP + dq)))
               for dq in D_FOCUS]
    return dict(src=src, slitFE=slitFE, m1=m1, m2=m2, pg=pg, m3=m3,
                exitSlit=exitSlit, m4=m4, m5=m5, screens=screens)


def receiver_samples(run_chain):
    """{receiving element: its samples} of a built chain, float64 numpy:
    (x, z) on the slits, (x, y, z) on the mirrors; ``build_chain(samples=
    ...)`` builds another chain (another dtype) on the same samples."""
    out = {}
    for name, rec in (('slit', 'slitFE'),) + STAGES:
        w = run_chain.waves[name]
        xyz = (w.x, w.z) if rec in ('slitFE', 'exitSlit') else \
            (w.x, w.y, w.z)
        out[rec] = tuple(v.detach().to('cpu', dtype=v.dtype).double()
                         .numpy() for v in xyz)
    return out


def build_chain(nrays=200000, n_scr=64, verbose=False, tiled=False,
                error_budget='auto', dtype=None, device=None,
                generator=None, samples=None):
    """Build the beamline and its fixed wave geometry; return run_chain.

    The receiver samples are drawn from *generator* (a ``torch.Generator``,
    seed 7 if None), or given: *samples* as :func:`receiver_samples` returns
    them (the OE samples sorted along y); each stage's mode, and with
    *tiled* the 5 x 10 tile
    map of every stage outside the recentred 'mxu*' envelopes, is chosen
    here on the host.  *error_budget*: per-stage relative field error for
    the mode choice ('auto' = the chain's Monte-Carlo noise floor
    3/sqrt(nrays)).

    ``run_chain(generator=None, timings=None, inputs=None)`` runs one full
    source -> focus propagation and returns the three focal images,
    (3, n_scr, n_scr) float64 numpy in xrt's absolute flux units.  The
    field is rescaled to unit RMS between stages (xrt's units reach
    J ~ 1e39, beyond float32); the accumulated scale is undone on the host.
    Its *generator* feeds the source's e-beam draws; *timings* (a list)
    receives one record per step ('shine', each stage and focal integral)
    with its ``mode``, for a tiled stage its ``tiles`` per mode, and CUDA
    ``start``/``end`` events (``wavechain.StageTimer``); *inputs* (a dict)
    receives each stage's source beam under the stage's name.
    ``run_chain`` carries ``elements``, ``waves`` (the receiving waves by
    stage name, 'slit' and 'scr0'..'scr2' included), ``modes``,
    ``tilemaps`` and ``nrays``."""
    import torch
    from xrt_tpu_torch import config
    from xrt_tpu_torch.wavechain import StageTimer
    from xrt_tpu_torch.waves import (choose_kirchhoff_mode,
                                     choose_tile_modes, diffract,
                                     prepare_wave_on_aperture,
                                     prepare_wave_on_oe,
                                     prepare_wave_on_screen, reflect_wave,
                                     rescale_field, tile_pairs_by_mode)
    dt = config.resolve_dtype(dtype)
    dev = config.resolve_device(device)
    if error_budget == 'auto':
        error_budget = 3.0 / math.sqrt(nrays)
    if generator is None:
        generator = torch.Generator().manual_seed(7)
    el = beamline(dt, dev)
    src = el['src']
    areaFraction = el['pg'].get_grating_area_fraction()
    px = np.linspace(-IMAGE_HALF, IMAGE_HALF, n_scr)

    kw = dict(generator=generator, dtype=dt, device=dev)

    def given(rec):
        return None if samples is None else samples[rec]
    waves = {'slit': prepare_wave_on_aperture(el['slitFE'], src, nrays,
                                              samples=given('slitFE'),
                                              **kw)}
    prev_el = el['slitFE']
    for name, rec in STAGES:
        if rec == 'exitSlit':
            w = prepare_wave_on_aperture(el[rec], prev_el, nrays,
                                         samples=given(rec), **kw)
        else:
            w = prepare_wave_on_oe(el[rec], prev_el, nrays, sort='y',
                                   samples=given(rec), **kw)
        waves[name], prev_el = w, el[rec]
    for i, scr in enumerate(el['screens']):
        waves[f'scr{i}'] = prepare_wave_on_screen(scr, el['m5'], px, px,
                                                  dtype=dt, device=dev)

    modes, tilemaps = {}, {}
    order = [nm for nm, _ in STAGES] + ['scr0', 'scr1', 'scr2']
    senders = ['slit'] + [nm for nm, _ in STAGES] + ['m5', 'm5']
    for name, sender in zip(order, senders):
        w, s = waves[name], waves[sender]
        dst = (w.xDiffr, w.yDiffr, w.zDiffr)
        srcxyz = (s.x, s.y, s.z)
        modes[name] = choose_kirchhoff_mode(dst, srcxyz,
                                            error_budget=error_budget)
        if tiled and not (modes[name][0] == 'recentred' and
                          modes[name][1].startswith('mxu')):
            tilemaps[name] = choose_tile_modes(dst, srcxyz, 5, 10,
                                               error_budget=error_budget)
        if verbose:
            msg = f'# stage {name}: phase={modes[name][0]} ' \
                f'acc={modes[name][1]}'
            if name in tilemaps:
                flat = [m for row in tilemaps[name] for m in row]
                msg += (f'; tiled 5x10 -> '
                        f"{sum(1 for m in flat if m[0] == 'fast')}/"
                        f'{len(flat)} tile pairs fast')
            print(msg)

    state = {'generator': torch.Generator().manual_seed(11)}

    def run_chain(generator=None, timings=None, inputs=None):
        gen = state['generator'] if generator is None else generator
        logs = 0.0
        scale = []

        def resc(b):
            b, ls = rescale_field(b)
            scale.append(ls)
            return b

        def dif(name, cur):
            if inputs is not None:
                inputs[name] = cur
            pm, acc = modes[name]
            tm = tilemaps.get(name)
            rec = dict(stage=name, mode=(pm, acc))
            if tm is not None:
                rec['tiles'] = tile_pairs_by_mode(tm)
            mark = StageTimer(timings, rec, cur.x.device)
            out = diffract(cur, waves[name], phase_mode=pm,
                           monochromatic=True, accumulate=acc,
                           tile_modes=tm, narrowband=False,
                           check_envelope=False)
            mark.stop()
            return out

        mark = StageTimer(timings, dict(stage='shine', mode=None), dev)
        cur = src.shine_wave(gen, waves['slit'], E0)
        mark.stop()
        cur = resc(cur)
        for name, rec in STAGES:
            b = dif(name, cur)
            if rec == 'exitSlit':
                cur = resc(b)
                continue
            # reflect_wave keeps the receiver's exact local coordinates
            _, loc = reflect_wave(el[rec], b, gen)
            if name == 'pg':
                # the illuminated fraction of the sawtooth period scales
                # the radiating area
                loc = loc.replace(area=loc.area * areaFraction)
            cur = resc(loc)
        imgs = [dif(f'scr{i}', cur) for i in range(3)]
        logs = float(torch.stack(scale).sum()) if scale else logs
        out = np.stack([(o.Jss + o.Jpp).reshape(n_scr, n_scr).double()
                        .cpu().numpy() for o in imgs])
        return out * math.exp(-2.0 * logs)

    run_chain.elements = el
    run_chain.waves = waves
    run_chain.modes = modes
    run_chain.tilemaps = tilemaps
    run_chain.nrays = nrays
    return run_chain


def deterministic_chain(ref, dtype=None, device=None, f32_samples=False,
                        elements=None):
    """The chain fed at every hop with xrt's own receiver samples: *ref* is
    the mapping of arrays of ``tests/golden/ref_softimax.npz`` (xrt's
    SoftiMAX run at 2000 samples).  Each stage runs the Kirchhoff mode
    chosen for its geometry, and the field is rescaled between stages.

    *f32_samples*: round the samples to float32 values (and pin the surface
    z), so that a float32 and a float64 run integrate the same clouds.
    Returns {name: Es in absolute units, complex128 numpy} for 'slit', each
    receiving wave 'w<oe>', each reflected field '<oe>', 'es' and 'focus',
    and 'focus_J', the focal intensity."""
    import torch
    from xrt_tpu_torch import config
    from xrt_tpu_torch.physconsts import CHBAR
    from xrt_tpu_torch.waves import (choose_kirchhoff_mode, diffract,
                                     prepare_wave_on_aperture,
                                     prepare_wave_on_oe,
                                     prepare_wave_on_screen, reflect_wave,
                                     rescale_field)
    dt = config.resolve_dtype(dtype)
    dev = config.resolve_device(device)
    el = beamline(dt, dev) if elements is None else elements
    kw = dict(dtype=dt, device=dev)
    kv = E0 / CHBAR * 1e7

    def smp(v):
        v = np.asarray(v, np.float64)
        return np.asarray(v.astype(np.float32), np.float64) \
            if f32_samples else v
    out = {}
    logs = [0.0]

    def resc(b):
        b, ls = rescale_field(b)
        logs[0] += float(ls)
        return b

    def save(name, b):
        out[name] = b.Es.detach().to('cpu', torch.complex128).numpy() * \
            math.exp(-logs[0])

    def dif(cur, w):
        pm, acc = choose_kirchhoff_mode((w.xDiffr, w.yDiffr, w.zDiffr),
                                        (cur.x, cur.y, cur.z), k=kv)
        return diffract(cur, w, phase_mode=pm, accumulate=acc,
                        monochromatic=True, narrowband=False)

    def on_oe(oe_nm, wnm, prev):
        s = (smp(ref[wnm + '_x']), smp(ref[wnm + '_y']))
        if f32_samples:
            s += (smp(ref[wnm + '_z']),)
        return prepare_wave_on_oe(el[oe_nm], el[prev], 0, samples=s, **kw)

    wSlit = prepare_wave_on_aperture(
        el['slitFE'], el['src'], 0,
        samples=(smp(ref['slit_x']), smp(ref['slit_z'])), **kw)
    cur = resc(el['src'].shine_wave(None, wSlit, E0))
    save('slit', cur)
    for oe_nm, prev in (('m1', 'slitFE'), ('m2', 'm1'), ('pg', 'm2'),
                        ('m3', 'pg'), ('es', 'm3'), ('m4', 'exitSlit'),
                        ('m5', 'm4')):
        if oe_nm == 'es':
            w = prepare_wave_on_aperture(
                el['exitSlit'], el[prev], 0,
                samples=(smp(ref['es_x']), smp(ref['es_z'])), **kw)
            cur = resc(dif(cur, w))
            save('es', cur)
            continue
        b = dif(cur, on_oe(oe_nm, 'w' + oe_nm, prev))
        save('w' + oe_nm, b)
        _, loc = reflect_wave(el[oe_nm], b)
        if oe_nm == 'pg':
            # the golden's own footprint area times the illuminated fraction
            x, y = ref['pg_x'], ref['pg_y']
            area = (x.max() - x.min()) * (y.max() - y.min()) * \
                float(ref['areaFraction'])
            loc = loc.replace(area=torch.tensor(area, dtype=dt, device=dev))
        cur = resc(loc)
        save(oe_nm, cur)
    nscr = int(ref['NSCR'])
    edges = np.linspace(-50, 50, nscr + 1)
    cent = (edges[:-1] + edges[1:]) * 0.5 / 1e3
    wF = prepare_wave_on_screen(el['screens'][1], el['m5'], cent, cent, **kw)
    o = dif(cur, wF)
    save('focus', o)
    out['focus_J'] = (o.Jss + o.Jpp).detach().to('cpu', torch.float64) \
        .numpy() * math.exp(-2 * logs[0])
    return out


def main():
    import torch
    smoke = '--smoke' in sys.argv
    tiled = '--untiled' not in sys.argv
    nrays = 4000 if smoke else 200000
    n_scr = 32 if smoke else 64
    for a in sys.argv:
        if a.startswith('--nrays='):
            nrays = int(float(a.split('=')[1]))
        if a.startswith('--nscr='):
            n_scr = int(a.split('=')[1])
    if not torch.cuda.is_available():
        print('torch_bench_softimax: no CUDA device', file=sys.stderr)
        return 1
    t0 = time.time()
    run_chain = build_chain(nrays=nrays, n_scr=n_scr, verbose=True,
                            tiled=tiled)
    torch.cuda.synchronize()
    t1 = time.time()
    imgs = run_chain()
    torch.cuda.synchronize()
    t2 = time.time()
    times = []
    for _ in range(2 if smoke else 3):
        timings = []
        ta = time.time()
        imgs = run_chain(timings=timings)
        torch.cuda.synchronize()
        times.append(time.time() - ta)
    for rec in timings:
        ms = rec['start'].elapsed_time(rec['end'])
        print(f"  {rec['stage']}: {rec['mode']} "
              f"{rec.get('tiles', '')} {ms:.2f} ms")
    best = min(times)
    npairs = 7 * nrays ** 2 + 3 * nrays * n_scr ** 2
    print(f'{torch.cuda.get_device_name(0)}: build {t1 - t0:.1f} s, first '
          f'run {t2 - t1:.2f} s, chain best-of-{len(times)} {best:.3f} s '
          f'({npairs / best:.3e} pairs/s)')
    for i, dq in enumerate(D_FOCUS):
        print(f'  focus {dq:+.0f} mm: total {imgs[i].sum():.3e}, peak '
              f'{imgs[i].max():.3e}')
    if '--f64' in sys.argv:
        # the same chain in float64 (plain path) on the same samples
        t3 = time.time()
        rc64 = build_chain(nrays=nrays, n_scr=n_scr, dtype=torch.float64,
                           samples=receiver_samples(run_chain))
        i64 = rc64()
        torch.cuda.synchronize()
        err = float(np.abs(imgs - i64).max() / i64.max())
        print(f'float64 on the same samples: {time.time() - t3:.1f} s; '
              f'max|dI|/max I {err:.3e}; totals '
              + ', '.join(f'{a.sum():.4e} / {b.sum():.4e}'
                          for a, b in zip(imgs, i64)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
