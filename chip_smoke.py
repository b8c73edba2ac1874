#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``xrt_tpu_torch/csrc`` with ``nvcc`` (one
process per source, in parallel), then runs seven phases and exits non-zero
if any fails:

1. card and build: the card's name and power limit, torch and CUDA
   versions, the build time;
2. kernels against their plain PyTorch versions on the card: kernel B1
   (recentred; mono, narrowband, poly, every ``accumulate`` value) and B2
   (per-pair double-float; 'fast', 'exact') at 8192 x 16384 pairs to
   max|d| / max|ref| < 2e-5 (f32 sums of ~1e4 terms taken in another
   order), and the double-float device helpers bit for bit; the
   histogram kernel B4 for k = 1 and 3 against its plain version with the
   sums taken in float64: 1e7 uniform rays into 128 x 128 (block-private
   shared-memory copies) and into 1024 x 1024 (global atomics), the 1D
   case, a focused beam (95% of the rays in four bins), rays on edges /
   NaN / +-inf / outside (identical non-empty bins) and a ray count that
   is no multiple of the block, to max|h - h64| / max|h64| < 1e-5 (f32
   partial sums merged by atomics in an order that changes from run to
   run; 1e-4 for the focused beam, where one bin takes a quarter of a
   block's rays, ~1e4, in one running f32 sum);
3. the main path: the Gaussian -> slit -> toroid -> 256 x 256 screen
   WaveChain at 2e5 samples per wave in float32 (4.0e10 + 1.3e10 pairs),
   with the per-hop stage times, the chain time (median of 3 after a
   warm-up), pairs/s and the kernel launches of that run;
4. cross-checks: the chain at 2e4 samples on a 64 x 64 screen in float32
   (kernels) against float64 (plain path) to max|dI| / max I < 5e-3, and
   the full-size toroid -> screen hop with the B2 kernel ('fast',
   'exact') against the recentred result to < 5e-3;
5. the ``kernels`` line: every kernel with its launches, time, plain
   version's time, bound and (B4) the ``index_add_`` time at the
   main-path shapes;
6. the trace main path: GeometricSource -> Si toroid -> screen at 1e7
   rays per pass in float32 through ``run_ray_tracing`` (one plot of
   128-bin axes, auto limits, 4 repeats, a CUDA generator), with the
   calibration time, the time per pass (median of 3 runs after a
   warm-up), rays/s, the split of one pass by CUDA events and the
   histogram launches (exactly 8 per pass); then the same with a
   1024 x 1024 plot at 1 repeat, which takes the global-atomics variant;
7. the trace cross-check: one pass at 2e5 rays in float32 against float64
   from the same float64 samples: transmitted fraction to 1e-4, weighted
   centroids to 1e-3 of the image size and sizes to 1e-3.

The line before the last is the ``kernels`` JSON; the card line precedes
it; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
import json
import math
import statistics
import subprocess
import sys
import time

#: published peaks of one H100 SXM (dense, non-tensor float32), used for
#: the least time the card could take for a kernel's work
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

#: f32 operations per (destination, source) pair, read off the kernel
#: sources term by term (a reciprocal, a square root, a rintf, cosf or
#: sinf each count as one operation):
#: B1 mono   — offsets 3, wp2 6, A 1, 1/A 1, x 2, delta series 6, delta 2,
#:             phase 9, reduction 2, sincos polynomials 22, lw 1, num 8,
#:             pre 4, U 3, ax/ay/az 9, f 1, g 8, ten sums 28      = 116
#: B2 fast   — dd differences 33, three two_prods 51, two_sums 12, lo 11,
#:             sqrt + 1/r 2, q 17, corr 5, k r two_prod 17, ml 4,
#:             frac 7, sincos 22, nsk 7, pre 2, U 3, f 1, g 8, sums 28
#:                                                                = 230
#: B2 exact  — dd differences 33, three dd squares 69, two dd adds 22,
#:             dd sqrt 35, kappa 24, kappa r 24, frac_two_pi 8, 1/r 1,
#:             cos + sin 2, nsk 7, pre 2, U 3, f 1, g 8, sums 28  = 267
OPS_PER_PAIR = {'kirchhoff_recentred:mono': 116,
                'kirchhoff_ddphase:fast': 230,
                'kirchhoff_ddphase:exact': 267}
#: f32 keys read per destination and per source, and outputs per
#: destination, of every kernel of the line (mono B1 and both B2 variants)
KEYS = (6, 20, 10)
SOURCES = {'kirchhoff_recentred': 'xrt_tpu_torch/csrc/kirchhoff_recentred.cu',
           'kirchhoff_ddphase': 'xrt_tpu_torch/csrc/kirchhoff_ddphase.cu',
           'hist2d': 'xrt_tpu_torch/csrc/hist2d.cu'}
REPLACES = {'kirchhoff_recentred': 'xrt_tpu/ops/kirchhoff.py:565',
            'kirchhoff_ddphase': 'xrt_tpu/ops/kirchhoff.py:903',
            'hist2d': 'xrt_tpu/histogram.py:89'}

#: the trace main path: the beamline of the reference package's trace
#: benchmark at its ray count
TRACE_NRAYS = 10_000_000
TRACE_REPEATS = 4
TRACE_P, TRACE_Q, TRACE_PITCH = 10000.0, 2000.0, 4e-3

E0 = 500.0
P, Q, PITCH = 5000.0, 1000.0, 6e-3


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def rel_err(got, ref):
    """max over the five outputs of max|got - ref| / max|ref|, and the
    max absolute difference."""
    rel, ab = 0.0, 0.0
    for g, r in zip(got, ref):
        d = float((g - r).abs().max())
        scale = float(r.abs().max())
        if scale > 0:
            rel = max(rel, d / scale)
        elif d > 0:     # an output that is identically zero, e.g. Ep
            rel = math.inf
        ab = max(ab, d)
    return rel, ab


def cuda_ms(fn, n=1):
    """Mean device time of *n* calls of *fn*, by CUDA events."""
    import torch
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        out = fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n, out


def bound_ms(name, nd, ns):
    kd, ks, ko = KEYS
    t_ops = OPS_PER_PAIR[name] * nd * ns / PEAK_F32_OPS
    t_bytes = 4.0 * (kd * nd + ks * ns + ko * nd) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def beamline(dtype, device):
    from xrt_tpu_torch.apertures import RectangularAperture
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import ToroidMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GaussianBeam
    mat = Material.create('Au', rho=19.3, kind='mirror', dtype=dtype,
                          device=device)
    R = 2 * P * Q / (P + Q) / math.sin(PITCH)
    r = 2 * P * Q / (P + Q) * math.sin(PITCH)
    src = GaussianBeam.create(w0=0.05, distE='lines', energies=(E0,),
                              polarization='horizontal')
    slit = RectangularAperture.create(center=(0, 0, 0),
                                      opening=(-0.3, 0.3, -0.15, 0.15))
    tor = ToroidMirror.create(center=(0, P, 0), pitch=PITCH, R=R, r=r,
                              material=mat, limPhysX=(-3, 3),
                              limPhysY=(-40, 40))
    scr = Screen.create(
        center=(0, P + Q * math.cos(2 * PITCH), Q * math.sin(2 * PITCH)),
        z=(0, -math.sin(2 * PITCH), math.cos(2 * PITCH)))
    return src, slit, tor, scr


def build_chain(nrays, npix, dtype, seed=1):
    import numpy as np
    import torch
    from xrt_tpu_torch.wavechain import WaveChain
    src, slit, tor, scr = beamline(dtype, 'cuda')
    grid = np.linspace(-0.02, 0.02, npix)
    chain = (WaveChain(src, nrays=nrays, fixedEnergy=E0)
             .through_aperture(slit).through_oe(tor)
             .to_screen(scr, grid, grid))
    run = chain.build(torch.Generator().manual_seed(seed), dtype=dtype,
                      device='cuda')
    return run, (src, slit, tor, scr)


def phase_card():
    import torch
    from xrt_tpu_torch.ops import _cuda
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f'phase 1 card: {card}; python {sys.version.split()[0]}, torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}', flush=True)
    t0 = time.perf_counter()
    _cuda.build()
    t = time.perf_counter() - t0
    print(f'phase 1 build: {len(_cuda.SOURCES)} sources with nvcc in '
          f'{t:.2f} s', flush=True)
    return card


def kernel_case_args(mode, Nd=8192, Ns=16384, seed=3):
    """The beamline-like geometry of the reference package's MXU parity
    test: a 1 x 0.1 x 1 mm source cloud and a 2 x 2 mm destination patch
    10 m away, 9 keV."""
    import numpy as np
    import torch
    from xrt_tpu_torch.ops import dd
    from xrt_tpu_torch.physconsts import CHBAR
    rng = np.random.RandomState(seed)
    xs = rng.uniform(-0.5, 0.5, Ns)
    ys = rng.uniform(-0.05, 0.05, Ns)
    zs = rng.uniform(-0.5, 0.5, Ns)
    xd = rng.uniform(-1, 1, Nd)
    yd = np.full(Nd, 10000.0)
    zd = rng.uniform(-1, 1, Nd)
    Es = np.exp(1j * rng.uniform(0, 2 * np.pi, Ns))
    kk = np.full(Ns, 9000.0 / CHBAR * 1e7)
    if mode != 'mono':
        kk = kk * (1 + rng.uniform(-1e-4, 1e-4, Ns))

    def T(v, dt=None):
        return torch.as_tensor(v, dtype=dt).cuda()

    def D(v):
        return tuple(T(a) for a in dd.from_f64(v))
    f32 = torch.float32
    return (D(xd), D(yd), D(zd), D(xs), D(ys), D(zs),
            T(Es, torch.complex64), T(0.3 * Es, torch.complex64), D(kk),
            [T(np.full(Ns, v), f32) for v in (0.01, 0.99, 0.02)],
            T(np.full(Ns, 0.9), f32), T(np.ones(Ns), f32))


def phase_kernels():
    import torch
    from xrt_tpu_torch.ops import dd, kirchhoff as tk
    for mode in ('mono', 'narrowband', 'poly'):
        args = kernel_case_args(mode)
        kw = dict(monochromatic=mode == 'mono',
                  narrowband=mode == 'narrowband')
        ref = tk.kirchhoff_integral_recentred(*args, **kw)
        worst = 0.0
        for acc in ('vpu', 'mxu', 'mxu2', 'mxu-fast', 'mxu32'):
            got = tk.kirchhoff_integral_kernel(*args, accumulate=acc, **kw)
            rel, _ = rel_err(got, ref)
            worst = max(worst, rel)
            check(rel < 2e-5, f'B1 {mode}/{acc}: {rel:.3e} >= 2e-5')
        print(f'phase 2 B1 {mode}: kernel vs plain, all accumulate '
              f'values, max rel {worst:.2e}', flush=True)
    for pm in ('fast', 'exact'):
        args = kernel_case_args('poly')
        ref = tk.kirchhoff_integral_dd(*args, phase_mode=pm)
        got = tk.kirchhoff_integral_kernel(*args, phase_mode=pm)
        rel, _ = rel_err(got, ref)
        check(rel < 2e-5, f'B2 {pm}: {rel:.3e} >= 2e-5')
        print(f'phase 2 B2 {pm}: kernel vs plain max rel {rel:.2e}',
              flush=True)
    g = torch.Generator().manual_seed(0)
    n = 1_000_000
    a = (torch.rand(n, generator=g, dtype=torch.float64) * 2e4 - 1e4)
    b = (torch.rand(n, generator=g, dtype=torch.float64) * 2 - 1)
    c = (torch.rand(n, generator=g, dtype=torch.float64) - 0.5)
    a, b, c = (v.float().cuda() for v in (a, b, c))
    got = dd.selftest(a, b, c)
    plain = torch.stack([*dd.two_sum(a, b), *dd.two_prod(a, b),
                         dd.frac_cycles(a, b), *dd.sincos_cycles(c)])
    cpu = dd.selftest(a.cpu(), b.cpu(), c.cpu()).cuda()
    bad = int((got != plain).sum()) + int((got != cpu).sum())
    check(bad == 0, f'dd helpers differ from plain torch in {bad} values')
    print(f'phase 2 dd helpers: two_sum, two_prod, frac_cycles, '
          f'sincos_cycles bit-identical to plain torch (card and CPU) on '
          f'{n} inputs', flush=True)


def phase_main(timing):
    import numpy as np
    import torch
    from xrt_tpu_torch.ops import kirchhoff as tk
    from xrt_tpu_torch.wavechain import WaveChain
    nrays, npix = 200_000, 256
    t0 = time.perf_counter()
    run, els = build_chain(nrays, npix, torch.float32)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    pairs = [nrays * nrays, nrays * npix * npix]
    tk.LAUNCHES.clear()
    hops = []
    w, logs = run(torch.Generator().manual_seed(2))  # warm-up
    torch.cuda.synchronize()
    times = []
    for rep in range(3):
        t0 = time.perf_counter()
        w, logs = run(torch.Generator().manual_seed(2),
                      timings=hops if rep == 2 else None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(tk.LAUNCHES)
    I = WaveChain.absolute_intensity(w, logs)
    check(np.all(np.isfinite(I)) and I.max() > 0,
          'main path: intensity not finite or all zero')
    med = statistics.median(times)
    for hrec in hops:
        ms = hrec['start'].elapsed_time(hrec['end'])
        i = hrec['hop']
        print(f'phase 3 hop {i}: mode {hrec["mode"]}, '
              f'{pairs[i - 1]:.3e} pairs, stage {ms:.2f} ms (CUDA events, '
              f'last timed run)', flush=True)
    print(f'phase 3 chain: {nrays} samples/wave, {npix}x{npix} screen, '
          f'float32; build {t_build:.2f} s; run median of 3 '
          f'{med * 1e3:.1f} ms ({", ".join(f"{t * 1e3:.1f}" for t in times)}'
          f'); {sum(pairs) / med:.3e} pairs/s; I max {I.max():.6e}; '
          f'launches {launches}', flush=True)
    check(launches.get('kirchhoff_recentred:mono', 0) >= 2 * 4,
          f'main path did not launch B1 on both hops: {launches}')
    check(set(launches) == {'kirchhoff_recentred:mono'},
          f'unexpected launches on the main path: {launches}')
    timing['main'] = dict(run=run, els=els, launches=launches,
                          pairs=pairs)


def hop_inputs(run, els):
    """The float32 chain driven hop by hop to the toroid -> screen stage:
    (source beam, receiving wave) of each stage."""
    import torch
    from xrt_tpu_torch import waves as W
    src, slit, tor, scr = els
    wv = run.waves
    cur = W._shine_or_diffract(None, wv[0], torch.Generator().manual_seed(2))
    cur, l0 = W.rescale_field(cur)
    b = W.diffract(cur, wv[1], phase_mode=run.modes[1][0],
                   monochromatic=True, accumulate=run.modes[1][1],
                   narrowband=False)
    _, loc = W.reflect_wave(tor, b)
    loc, l1 = W.rescale_field(loc)
    return [(cur, wv[1]), (loc, wv[2])], l0 + l1


def time_kernel(name, variant, stage, with_plain=True):
    """(kernel ms, plain ms, max abs err, rel err, Nd, Ns) of one kernel at
    one stage's shapes: the kernel alone by CUDA events (median of 3), the
    plain version once (or skipped: None for its three numbers)."""
    import torch
    from xrt_tpu_torch import waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    oeLocal, wave = stage
    args = W.kirchhoff_kernel_args(oeLocal, wave)
    xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, w = args
    Nd, Ns = xd[0].shape[0], xs[0].shape[0]
    if name == 'kirchhoff_recentred':
        dst, src, params = tk.recentre_kirchhoff_inputs(
            *args, monochromatic=True, narrowband=False)
        launch = lambda: tk._launch_recentred(dst, src, params, 0, Nd, Ns)
        plain = lambda: tk.kirchhoff_integral_recentred(
            *args, monochromatic=True)
    else:
        dst, src = tk.ddphase_inputs(*args, phase_mode=variant)
        v = tk._DD_VARIANTS[variant]
        launch = lambda: tk._launch_ddphase(dst, src, v, Nd, Ns)
        plain = lambda: tk.kirchhoff_integral_dd(*args, phase_mode=variant)
    launch()
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(launch)[0] for _ in range(3))
    if not with_plain:
        return ms, None, None, None, Nd, Ns
    out = tk._complex5(launch())
    plain_ms, ref = cuda_ms(plain)
    rel, ab = rel_err(out, ref)
    return ms, plain_ms, ab, rel, Nd, Ns


def phase_cross(timing):
    import numpy as np
    import torch
    from xrt_tpu_torch import waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    from xrt_tpu_torch.wavechain import WaveChain
    res = {}
    for dt in (torch.float32, torch.float64):
        run, _ = build_chain(20_000, 64, dt, seed=4)
        w, logs = run(torch.Generator().manual_seed(5))
        res[dt] = WaveChain.absolute_intensity(w, logs)
    I32, I64 = res[torch.float32], res[torch.float64]
    err = float(np.max(np.abs(I32 - I64)) / np.max(I64))
    print(f'phase 4 float32 kernels vs float64 plain path, 2e4 samples, '
          f'64x64 screen: max|dI|/max I {err:.3e}', flush=True)
    check(err < 5e-3, f'f32 vs f64 chain: {err:.3e} >= 5e-3')

    main = timing['main']
    stages, logs = hop_inputs(main['run'], main['els'])
    oeLocal, wave = stages[1]
    out = {}
    tk.LAUNCHES.clear()
    for pm in ('recentred', 'fast', 'exact'):
        o = W.diffract(oeLocal, wave, phase_mode=pm, monochromatic=True,
                       accumulate='mxu-fast', narrowband=False)
        out[pm] = (o.Jss + o.Jpp).double().cpu().numpy()
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    ref = out['recentred']
    for pm in ('fast', 'exact'):
        e = float(np.max(np.abs(out[pm] - ref)) / np.max(ref))
        print(f'phase 4 toroid -> screen hop at full size, B2 {pm} vs '
              f'recentred: max|dI|/max I {e:.3e}', flush=True)
        check(e < 5e-3, f'B2 {pm} vs recentred: {e:.3e} >= 5e-3')
        check(launches.get(f'kirchhoff_ddphase:{pm}', 0) >= 1,
              f'B2 {pm} was not launched: {launches}')
    print(f'phase 4 launches of the B2 run: {launches}', flush=True)
    timing['b2_launches'] = launches
    timing['stages'] = stages


def phase_kernel_line(timing):
    rows = []
    stages = timing['stages']
    for hop, stage in enumerate(stages, 1):
        ms, _, _, _, Nd, Ns = time_kernel('kirchhoff_recentred', 'mono',
                                          stage, with_plain=False)
        print(f'phase 5 hop {hop} kernel B1 alone: {Nd} x {Ns} pairs, '
              f'{ms:.2f} ms, {Nd * Ns / (ms * 1e-3):.3e} pairs/s',
              flush=True)
    specs = [('kirchhoff_recentred', 'mono', stages[0],
              timing['main']['launches']),
             ('kirchhoff_ddphase', 'fast', stages[1],
              timing['b2_launches']),
             ('kirchhoff_ddphase', 'exact', stages[1],
              timing['b2_launches'])]
    for name, variant, stage, launches in specs:
        key = f'{name}:{variant}'
        ms, plain_ms, ab, rel, Nd, Ns = time_kernel(name, variant, stage)
        check(rel < 2e-5, f'{key} at main-path shapes: {rel:.3e}')
        bms, by = bound_ms(key, Nd, Ns)
        print(f'phase 5 {key}: {Nd} x {Ns} pairs, kernel {ms:.2f} ms, '
              f'plain {plain_ms:.1f} ms, bound {bms:.2f} ms ({by}), '
              f'{Nd * Ns / (ms * 1e-3):.3e} pairs/s, max rel {rel:.2e}',
              flush=True)
        rows.append(dict(name=key, route='cuda', source=SOURCES[name],
                         replaces=REPLACES[name],
                         launches=int(launches.get(key, 0)),
                         max_abs_err=ab, max_rel_err=rel, ms=ms,
                         plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=None))
    return rows


# ---------------------------------------------------------------------------
# the histogram kernel (B4) and the trace path
# ---------------------------------------------------------------------------

def hist_case(case, k, n=TRACE_NRAYS, seed=0):
    """(x, y, W, xbins, ybins, xlimits, ylimits) of one check of the
    histogram kernel, float32 on the card."""
    import numpy as np
    import torch
    g = torch.Generator('cuda').manual_seed(seed)
    xlim, ylim = (-1.0, 1.3), (-0.5, 1.7)   # spans with inexact reciprocals
    xbins = ybins = 128
    if case == 'ragged':
        n = 1_234_567

    def rand(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, device='cuda')
    x, y = rand(-1.1, 1.4), rand(-0.6, 1.8)
    if case == 'global':
        xbins = ybins = 1024
    elif case == '1d':
        ybins, y, ylim = 1, None, None
    elif case == 'focused':     # 95% of the rays in four bins
        sel = rand(0, 1) < 0.95
        x = torch.where(sel, rand(0.0, 2 * 2.3 / 128), x)
        y = torch.where(sel, rand(0.5, 0.5 + 2 * 2.2 / 128), y)
    elif case == 'special':
        ex = np.linspace(*xlim, xbins + 1)
        ey = np.linspace(*ylim, ybins + 1)
        extra = np.array([np.nan, np.inf, -np.inf, -7.0, 9.0])
        xs = np.concatenate([ex, extra, ex, np.nextafter(ex, 9)])
        ys = np.concatenate([ey, ey[:5], extra, ey[::-1], ey * 0.999])
        m = xs.size
        x = torch.cat([torch.as_tensor(xs, dtype=torch.float32).cuda(),
                       x[:100_000]])
        y = torch.cat([torch.as_tensor(ys[:m], dtype=torch.float32).cuda(),
                       y[:100_000]])
        n = x.shape[0]
    W = 0.5 + torch.rand((n, k), generator=g, device='cuda')
    return x, y, W, xbins, ybins, xlim, ylim


def hist_errors(got, ref):
    """(max|h - h64| / max|h64|, max abs difference, whether the sets of
    non-empty bins are identical)."""
    import torch
    d = float((got.double() - ref).abs().max())
    return d / float(ref.abs().max()), d, bool(torch.equal(got != 0,
                                                           ref != 0))


def phase_hist_kernel():
    import torch
    from xrt_tpu_torch import histogram as th
    for case in ('shared', 'global', '1d', 'focused', 'special', 'ragged'):
        for k in (1, 3):
            args = hist_case(case, k)
            got = th.hist2d_kernel(*args)
            torch.cuda.synchronize()
            ref = th.hist2d_plain(*args, sum_dtype=torch.float64)
            rel, _, same = hist_errors(got, ref)
            lim = 1e-4 if case == 'focused' else 1e-5
            print(f'phase 2 B4 {case} k={k}: {args[0].shape[0]} rays into '
                  f'{args[4]} x {args[3]}, kernel vs plain (float64 sums) '
                  f'max rel {rel:.2e} (limit {lim:.0e}), non-empty bins '
                  f'{"identical" if same else "DIFFER"}', flush=True)
            check(rel < lim, f'B4 {case} k={k}: {rel:.3e} >= {lim:.0e}')
            check(same, f'B4 {case} k={k}: the sets of non-empty bins '
                  'differ')
    x, y, W, xbins, ybins, xlim, ylim = hist_case('shared', 3, n=1_000_000)
    a = th.hist2d_kernel(x, y, W, xbins, ybins, xlim, ylim, use_shared=True)
    b = th.hist2d_kernel(x, y, W, xbins, ybins, xlim, ylim,
                         use_shared=False)
    rel = float((a - b).abs().max() / a.abs().max())
    check(rel < 1e-5, f'B4 shared vs global variant: {rel:.3e}')
    d = th.hist2d_kernel(x.double(), y.double(), W.double(), xbins, ybins,
                         xlim, ylim)
    ref = th.hist2d_plain(x.double(), y.double(), W.double(), xbins, ybins,
                          xlim, ylim)
    rel64 = float((d - ref).abs().max() / ref.abs().max())
    check(rel64 < 1e-12, f'B4 float64 kernel vs plain: {rel64:.3e}')
    print(f'phase 2 B4: shared vs global variant on one input max rel '
          f'{rel:.2e}; float64 kernel vs plain {rel64:.2e}', flush=True)


def trace_beamline(nrays, dtype):
    """The beamline of the reference package's trace benchmark:
    GeometricSource -> Si toroid (p = 10 m, q = 2 m, 4 mrad) -> screen."""
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import ToroidMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    p, q, pitch = TRACE_P, TRACE_Q, TRACE_PITCH
    mat = Material.create('Si', rho=2.33, kind='mirror', dtype=dtype,
                          device='cuda')
    src = GeometricSource.create(
        nrays=nrays, center=(0, 0, 0), dx=0.1, dz=0.05, dxprime=3e-5,
        dzprime=3e-5, distE='flat', energies=(8900.0, 9100.0),
        polarization='horizontal', dtype=dtype, device='cuda')
    tor = ToroidMirror.create(center=(0, p, 0), pitch=pitch, R=(p, q),
                              r=(p, q), material=mat, limPhysX=(-20, 20),
                              limPhysY=(-300, 300))
    scr = Screen.create(center=(0, p + q, 2 * pitch * q))
    return src, tor, scr


def trace_plot(bins):
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    return XYCPlot(beam='screen', xaxis=XYCAxis('x', 'mm', bins=bins),
                   yaxis=XYCAxis('z', 'mm', bins=bins),
                   caxis=XYCAxis('energy', 'eV', bins=bins))


def events(n):
    import torch
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def phase_trace(timing):
    import torch
    from xrt_tpu_torch import histogram as th, runner
    from xrt_tpu_torch.oes import base as oebase
    from xrt_tpu_torch.ops import kirchhoff as tk
    from xrt_tpu_torch.transforms import global_to_virgin_local, rotate_beam
    n, reps = TRACE_NRAYS, TRACE_REPEATS
    src, tor, scr = trace_beamline(n, torch.float32)
    entries = []

    def run_process(beamLine, rng):
        torch.cuda.synchronize()
        entries.append(time.perf_counter())
        glo, _ = tor.reflect(src.shine(rng))
        return {'screen': scr.expose(glo)}

    torch.cuda.reset_peak_memory_stats()
    rng = torch.Generator('cuda').manual_seed(11)
    th.LAUNCHES.clear()
    tk.LAUNCHES.clear()
    pass_ms, cal_ms, run_ms = [], [], []
    for rep in range(4):        # a warm-up and 3 timed runs
        plot = trace_plot(128)
        entries.clear()
        runner.run_ray_tracing(plot, repeats=reps, run_process=run_process,
                               rng=rng)
        torch.cuda.synchronize()
        t = entries + [time.perf_counter()]
        if rep:
            cal_ms.append(1e3 * (t[1] - t[0]))
            pass_ms.append(statistics.median(
                1e3 * (b - a) for a, b in zip(t[1:-1], t[2:])))
            run_ms.append(1e3 * (t[-1] - t[0]))
    launches = dict(th.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(pass_ms)
    print(f'phase 6 trace: {n} rays/pass, float32, {reps} repeats + '
          f'calibration; calibration pass {statistics.median(cal_ms):.1f} '
          f'ms; pass median of 3 runs {med:.1f} ms '
          f'({", ".join(f"{v:.1f}" for v in pass_ms)}); '
          f'{n / (med * 1e-3):.3e} rays/s; whole run '
          f'{statistics.median(run_ms):.1f} ms; peak device memory '
          f'{peak / 2 ** 30:.2f} GiB', flush=True)
    good = plot.nRaysGood / plot.nRaysAll
    print(f'phase 6 plot: nRaysAll {plot.nRaysAll}, nRaysGood '
          f'{plot.nRaysGood} ({good:.6f}), intensity {plot.intensity:.6e}, '
          f'dx {plot.dx:.6f} mm, dy {plot.dy:.6f} mm, dE {plot.dE:.3f} eV; '
          f'launches of the 4 runs {launches}', flush=True)
    check(plot.nRaysAll == reps * n and plot.repeats == reps,
          f'trace: nRaysAll {plot.nRaysAll}, repeats {plot.repeats}')
    check(good > 0.9, f'trace: good fraction {good}')
    s2, s1 = float(plot.total2D.sum()), float(plot.total1D_x.sum())
    check(abs(s2 / s1 - 1) < 1e-5, f'trace: total2D {s2} vs total1D_x {s1}')
    check(math.isfinite(plot.intensity) and plot.intensity > 0,
          'trace: intensity not finite or zero')
    check(launches == {'hist2d:k1:shared': 4 * 4 * reps,
                       'hist2d:k3:shared': 4 * 4 * reps},
          f'trace: not exactly 8 histogram launches per pass: {launches}')
    check(not tk.LAUNCHES, f'trace launched {dict(tk.LAUNCHES)}')

    # one pass by hand, split by CUDA events; the limits are the plot's
    ev = events(8)
    ev[0].record()
    beam = src.shine(rng)
    ev[1].record()
    glo, _ = tor.reflect(beam)
    ev[2].record()
    img = scr.expose(glo)
    ev[3].record()
    hists = runner.histogram_plot(plot, {'screen': img})
    ev[4].record()
    runner._accumulate(trace_plot(128), hists)
    ev[5].record()
    lb = rotate_beam(global_to_virgin_local(beam, tor.center),
                     rotationSequence=tor.rotationSequence,
                     pitch=-tor.pitch, roll=-tor.roll, yaw=-tor.yaw)
    rays = (lb.x, lb.y, lb.z, lb.a, lb.b, lb.c)
    torch.cuda.synchronize()
    ev[6].record()
    evals = []      # the surface is evaluated at both bracket ends, once
                    # per Illinois iteration and in the two Newton steps

    def counted_z(xx, yy):
        evals.append(1)
        return tor.local_z(xx, yy)
    oebase.find_intersection(counted_z, *tor._bracket(*rays), *rays,
                             active=lb.state > 0)
    ev[7].record()
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
    print(f'phase 6 split of one pass (CUDA events): source {ms[0]:.1f} ms, '
          f'reflect {ms[1]:.1f} ms (bracket + search alone '
          f'{ev[6].elapsed_time(ev[7]):.1f} ms in {len(evals) - 4} Illinois '
          f'iterations), expose {ms[2]:.1f} ms, '
          f'histograms (8 launches + colorize) {ms[3]:.1f} ms, accumulate '
          f'{ms[4]:.1f} ms', flush=True)
    # the source with a CPU generator: float64 draws on the host, copied
    t0 = time.perf_counter()
    src.shine(torch.Generator().manual_seed(11))
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    print(f'phase 6 source sampling: CUDA generator {ms[0]:.1f} ms, CPU '
          f'generator (float64 draws on the host, copied) {host_ms:.1f} ms',
          flush=True)

    # a 1024 x 1024 plot: the 2D histograms take the global-atomics variant
    th.LAUNCHES.clear()
    big = trace_plot(1024)
    runner.run_ray_tracing(big, repeats=1, run_process=run_process, rng=rng)
    big_launches = dict(th.LAUNCHES)
    print(f'phase 6 1024-bin plot, 1 repeat: launches {big_launches}, '
          f'nRaysGood {big.nRaysGood}, intensity {big.intensity:.6e}',
          flush=True)
    check(big_launches == {'hist2d:k1:shared': 3, 'hist2d:k3:shared': 3,
                           'hist2d:k1:global': 1, 'hist2d:k3:global': 1},
          f'1024-bin plot: launches {big_launches}')
    check(abs(big.intensity / (plot.intensity / reps) - 1) < 1e-2,
          '1024-bin plot: intensity differs from the main run')
    x, y, cData, inten, flux, mask, _ = runner._plot_arrays(
        plot, {'screen': img})
    fm = mask.to(x.dtype)
    timing['trace'] = dict(
        launches=launches, big_launches=big_launches, x=x, y=y,
        w=(inten * fm)[:, None].contiguous(),
        rgb=th.colorize(cData, flux * fm, plot.caxis.limits,
                        plot.colorFactor, plot.colorSaturation),
        xlim=tuple(plot.xaxis.limits), ylim=tuple(plot.yaxis.limits),
        xlim_big=tuple(big.xaxis.limits), ylim_big=tuple(big.yaxis.limits))


def phase_trace_cross():
    import torch
    res = {}
    for dt in (torch.float32, torch.float64):
        src, tor, scr = trace_beamline(200_000, dt)
        glo, _ = tor.reflect(src.shine(torch.Generator().manual_seed(21)))
        img = scr.expose(glo)
        good = img.state == 1
        w = torch.where(good, img.Jss + img.Jpp, 0.0).double()
        x, z = img.x.double(), img.z.double()
        cx, cz = (w * x).sum() / w.sum(), (w * z).sum() / w.sum()
        res[dt] = [float(v) for v in (
            good.double().mean(), w.sum(), cx, cz,
            torch.sqrt((w * (x - cx) ** 2).sum() / w.sum()),
            torch.sqrt((w * (z - cz) ** 2).sum() / w.sum()))]
    (g32, f32, cx32, cz32, sx32, sz32), (g64, f64, cx64, cz64, sx64, sz64) \
        = res[torch.float32], res[torch.float64]
    print(f'phase 7 trace float32 vs float64, 2e5 rays from the same '
          f'float64 samples: good fraction {g32:.6f} / {g64:.6f}, flux '
          f'ratio {f32 / f64:.6f}, centroid shift / size x '
          f'{abs(cx32 - cx64) / sx64:.2e} z {abs(cz32 - cz64) / sz64:.2e}, '
          f'size ratio x {sx32 / sx64:.6f} z {sz32 / sz64:.6f}', flush=True)
    check(abs(g32 - g64) < 1e-4, f'trace f32 vs f64: good {g32} / {g64}')
    check(abs(cx32 - cx64) < 1e-3 * sx64 and abs(cz32 - cz64) < 1e-3 * sz64,
          'trace f32 vs f64: centroids differ by more than 1e-3 sizes')
    check(abs(sx32 / sx64 - 1) < 1e-3 and abs(sz32 / sz64 - 1) < 1e-3,
          'trace f32 vs f64: sizes differ by more than 1e-3')
    # the float32 Fresnel amplitude near the critical angle is the known
    # weak spot of this beamline (see PERF.md): held to 5e-2 only
    check(abs(f32 / f64 - 1) < 5e-2, f'trace f32 vs f64 flux {f32 / f64}')


def hist_rows(timing):
    """The rows of the histogram kernel at the trace main path's shapes,
    on the rays of one of its passes."""
    import torch
    from xrt_tpu_torch import histogram as th
    tr = timing['trace']
    rows = []
    specs = [('hist2d:k1', tr['w'], 128, 'shared', tr['launches']),
             ('hist2d:k3', tr['rgb'], 128, 'shared', tr['launches']),
             ('hist2d:k3:global', tr['rgb'], 1024, 'global',
              tr['big_launches'])]
    for name, W, bins, variant, launches in specs:
        k = W.shape[1]
        big = variant == 'global'
        args = (tr['x'], tr['y'], W, bins, bins,
                tr['xlim_big' if big else 'xlim'],
                tr['ylim_big' if big else 'ylim'])
        kernel = lambda: th.hist2d_kernel(*args)
        kernel()
        torch.cuda.synchronize()
        ms = statistics.median(cuda_ms(kernel, 5)[0] for _ in range(3))
        got = kernel()
        plain_ms, _ = cuda_ms(lambda: th.hist2d_plain(*args))
        ref = th.hist2d_plain(*args, sum_dtype=torch.float64)
        rel, ab, same = hist_errors(got, ref)
        check(same, f'{name}: non-empty bins differ from the plain version')
        check(rel < 1e-4, f'{name} at main-path shapes: {rel:.3e}')
        # the library call: index_add_ on prepared indices and weights
        fx, inx = th._bin_index(args[0], args[5], bins)
        fy, iny = th._bin_index(args[1], args[6], bins)
        inside = inx & iny
        flat = torch.where(inside, fy * bins + fx,
                           torch.zeros_like(fx)).long()
        w = torch.where(inside[:, None], W, torch.zeros_like(W))

        def library():
            return torch.zeros((bins * bins, k), dtype=W.dtype,
                               device='cuda').index_add_(0, flat, w)
        library()
        lib_ms = statistics.median(cuda_ms(library, 3)[0] for _ in range(3))
        n = W.shape[0]
        bms = 1e3 * (4.0 * n * (2 + k) + 4.0 * bins * bins * k) / PEAK_BYTES
        key = f'hist2d:k{k}:{variant}'
        print(f'phase 5 {name}: {n} rays into {bins} x {bins} x {k}, kernel '
              f'{ms:.3f} ms, plain {plain_ms:.2f} ms, index_add_ '
              f'{lib_ms:.3f} ms, bound {bms:.3f} ms (bytes), '
              f'{n / (ms * 1e-3):.3e} rays/s, max rel {rel:.2e}',
              flush=True)
        rows.append(dict(name=name, route='cuda', source=SOURCES['hist2d'],
                         replaces=REPLACES['hist2d'],
                         launches=int(launches.get(key, 0)),
                         max_abs_err=ab, max_rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by='bytes',
                         library_ms=lib_ms))
        check(rows[-1]['launches'] > 0, f'{name} was not launched on its '
              'path')
    return rows


def main():
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    try:
        import xrt_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: run from a checkout of the repository ({e})',
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    timing = {}
    try:
        card = phase_card()
        phase_kernels()
        phase_hist_kernel()
        phase_main(timing)
        phase_cross(timing)
        phase_trace(timing)
        phase_trace_cross()
        rows = phase_kernel_line(timing) + hist_rows(timing)
    except PhaseError as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        return 1
    print(f'total {time.perf_counter() - t_all:.1f} s')
    print(card)
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
