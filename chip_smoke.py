#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``xrt_tpu_torch/csrc`` with ``nvcc`` (one
process per source, in parallel), then runs twelve phases and exits
non-zero if any fails:

1. card and build: the card's name and power limit, torch and CUDA
   versions, the build time, the registers and spills of the adjoint and
   histogram kernels;
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
   version's time, bound and (B4, B4-bwd) the library call's time at the
   main-path shapes; for B3 also the share of its second kernel (the sum
   of the partials), its scratch and its registers and spills from the
   build log (``-Xptxas -v``).  The adjoint kernels are held against the plain
   blocked backward there too, on the slices it can do in seconds (it
   takes 1.6 ns a pair): the destination rows of the last 8192
   destinations against all sources, the source rows of the last 2048
   sources against all destinations, and, from a second launch at the same
   shape with the cotangents of all other destinations set to zero, every
   source row and the scalars of those 8192 destinations (the rows of the
   other destinations must then be exact zeros);
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

8. adjoint kernels against their plain versions: B3 (the backward of B1
   and B2: recentred mono, narrowband, poly; per-pair double-float 'fast',
   'exact') at 8192 x 16384 with random output cotangents against the
   plain blocked backward (autograd through the plain forward,
   checkpointed), every destination-key row, source-key row and scalar's
   cotangent to 1e-4 of its largest magnitude (f32 sums in another order;
   the kernels differentiate the sincos polynomials as (2 pi cos,
   -2 pi sin), the plain version the polynomials themselves, 1.3e-5 a
   pair, which a sum of few terms does not average down), and two
   launches on the same inputs bit-identical; B4's backward (the gather)
   against advanced indexing, exactly equal, for k = 1 and 3, 128 x 128
   and 1024 x 1024, 1D, special values, 1 to 7 rays, views at a 4-byte
   offset and float64;
9. the gradient main path: value and gradient of a Gaussian-weighted focal
   flux of the phase-3 chain (2e5 samples per wave, 256 x 256 screen,
   float32) with respect to the source waist (field cotangents), the
   toroid's pitch offset (linearized retargeting of its receiving samples
   and of the screen's samples in its frame, and ``reflect_wave`` with the
   tensor pitch: destination-position cotangents) and the amplitude of a
   height offset of its surface samples with a fixed parabolic profile
   along the mirror (source-position cotangents; a rigid offset is a
   piston phase, which no intensity sees): forward +
   backward time (median of 3), the forward alone, the launches (B1 x 2
   and B3 x 2 per step) and peak memory; the three gradients are held to
   those of one more step whose backward runs the plain blocked backward
   in place of the adjoint kernels (about 90 s of the run);
10. the gradient cross-check: the same at 2e4 samples on a 64 x 64 screen,
    float32 kernels against the float64 plain path (each parameter within
    3e-2) and float64 autograd against a central finite difference
    (within 1e-3);
11. the B2-path gradient: the full-size toroid -> screen hop with
    ``phase_mode`` 'fast' and 'exact' against the recentred gradient of
    the same loss (within 3e-2), with the launches;
12. the trace gradient: d(weighted central flux) / d(pitch) through
    GeometricSource -> toroid (with the search) -> screen -> ``hist2d``
    (B4 forward and backward) at 1e7 rays in float32, with times, peak
    memory and launches; the same through the three-column histogram of a
    colour plot (weights Jss, Jpp and their sum: twice the flux, so twice
    the gradient); and at 2e5 rays float32 against float64 and a finite
    difference (rtol 0.1).

``python3 chip_smoke.py --sweep-plain-blocks`` only times the plain
blocked backward at 8192 x 16384 for four block sizes (the measurement
behind ``ops.kirchhoff.GRAD_DST_BLOCK`` / ``GRAD_SRC_CHUNK``).

The line before the last is the ``kernels`` JSON; the card line precedes
it; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
import contextlib
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
#: The adjoints (B3), the least work for one pair: the forward pair without
#: its ten sums, one reverse sweep, and one add per cotangent row.
#: B3 mono   — forward 88; reverse: field cotangents 12, g's 10, ax/ay/az 9,
#:             f 3, h 2, ser/sei 6, U 22, k2 + 1/A seed 2, L 3, lw 5, pre +
#:             sin/cos 6, phase 4, inner/kw/num 8, n/Lns/lw 6, delta +
#:             kappa 4, series and 1/A 23, t 12                  = 137;
#:             sums: 6 destination rows, 20 source rows, 8 scalars = 34
#:                                                                = 259
#: B3 fast   — forward 202; reverse: the amplitude part 89, the phase part
#:             (kp, corr, s0, resid, 1/r, s2, the differences) 40  = 129;
#:             sums: 3 destination, 17 source rows = 20           = 351
#: B3 exact  — forward 239; reverse: the amplitude part 89, the phase part
#:             (frac_two_pi, kappa r, kp, dd sqrt, dd squares) 43 = 132;
#:             sums 20                                            = 391
#: The kernels evaluate each pair once (one pass, csrc/kirchhoff_bwd.cuh);
#: what they add to this is the sum of each pair's destination cotangents
#: over the warp (a transpose-reduce) and the partial sums across blocks.
OPS_PER_PAIR = {'kirchhoff_recentred:mono': 116,
                'kirchhoff_ddphase:fast': 230,
                'kirchhoff_ddphase:exact': 267,
                'kirchhoff_recentred_bwd:mono': 259,
                'kirchhoff_ddphase_bwd:fast': 351,
                'kirchhoff_ddphase_bwd:exact': 391}
#: f32 keys read per destination and per source, and outputs per
#: destination, of every kernel of the line (mono B1 and both B2 variants)
KEYS = (6, 20, 10)
SOURCES = {'kirchhoff_recentred': 'xrt_tpu_torch/csrc/kirchhoff_recentred.cu',
           'kirchhoff_ddphase': 'xrt_tpu_torch/csrc/kirchhoff_ddphase.cu',
           'kirchhoff_recentred_bwd':
           'xrt_tpu_torch/csrc/kirchhoff_recentred_bwd.cu',
           'kirchhoff_ddphase_bwd':
           'xrt_tpu_torch/csrc/kirchhoff_ddphase_bwd.cu',
           'hist2d': 'xrt_tpu_torch/csrc/hist2d.cu'}
REPLACES = {'kirchhoff_recentred': 'xrt_tpu/ops/kirchhoff.py:565',
            'kirchhoff_ddphase': 'xrt_tpu/ops/kirchhoff.py:903',
            'kirchhoff_recentred_bwd': 'xrt_tpu/ops/kirchhoff.py:1141',
            'kirchhoff_ddphase_bwd': 'xrt_tpu/ops/kirchhoff.py:1141',
            'hist2d': 'xrt_tpu/histogram.py:89'}
#: the adjoint kernels against the plain blocked backward: the limit on
#: max|row - ref| / max|ref| of every key row and scalar's cotangent
ADJ_LIMIT = 1e-4
#: the slices of a main-path shape on which the plain blocked backward is
#: run: the last destinations (against all sources) and the last sources
#: (against all destinations), ragged ends included
ADJ_DST_SLICE, ADJ_SRC_SLICE = 8192, 2048
#: the gradients of the main path, adjoint kernels against the plain
#: blocked backward in their place (measured: <= 1.2e-7, the rows' 1e-5
#: differences average out over 2e5 samples)
GRAD_PLAIN_LIMIT = 1e-5
#: why the adjoint rows have no library time
NO_LIBRARY = ('no single PyTorch call computes the adjoint of the Kirchhoff '
              'double sum')

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
    if '_bwd' in name:      # reads D, S and G, writes the cotangents of D, S
        t_bytes = 4.0 * (2 * kd * nd + 2 * ks * ns + ko * nd) / PEAK_BYTES
    else:
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
    for name in ('kirchhoff_recentred_bwd', 'kirchhoff_ddphase_bwd',
                 'hist2d'):
        for fn, regs, st, ld in ptxas_rows(_cuda.build_log(name)):
            print(f'phase 1 ptxas {name} {fn}: {regs} registers, spill '
                  f'stores {st} B, loads {ld} B', flush=True)
    return card


def ptxas_rows(log):
    """[(kernel, registers, spill store bytes, spill load bytes)] of a
    build log (``-Xptxas -v``); kernels by their mangled names."""
    import re
    rows, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and fn:
            rows.append((fn, int(m.group(1)), *spill))
            fn = None
    return rows


def adjoint_registers(scheme, v):
    """(registers, spill bytes) of the adjoint kernel of one variant."""
    from xrt_tpu_torch.ops import _cuda
    pair = 'RecentredPair' if scheme == 'recentred' else 'DDPair'
    for fn, regs, st, ld in ptxas_rows(_cuda.build_log(
            f'kirchhoff_{scheme}_bwd')):
        if 'adjoint_kernel' in fn and f'{pair}ILi{v}E' in fn:
            return regs, st + ld
    raise PhaseError(f'no ptxas line for the {scheme} adjoint {v}')


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
    scheme, v, D, S, P = tk._kernel_inputs(*args, variant)
    S = tk._pad_sources(S)
    if name == 'kirchhoff_recentred':
        launch = lambda: tk._launch_recentred(D, S, P, v)
        plain = lambda: tk.kirchhoff_integral_recentred(
            *args, monochromatic=True)
    else:
        launch = lambda: tk._launch_ddphase(D, S, v)
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


# ---------------------------------------------------------------------------
# the gradient slice: the adjoint kernels (B3, B4-bwd) and their paths
# ---------------------------------------------------------------------------

def launch_adjoint(scheme, v, D, S, P, G):
    from xrt_tpu_torch.ops import kirchhoff as tk
    if scheme == 'recentred':
        return tk._launch_recentred_bwd(D, S, P, G, v)
    return tk._launch_ddphase_bwd(D, S, G, v) + (None,)


def row_errors(got, ref):
    """(max over rows of max|row - ref| / max|ref|, max abs difference)."""
    rel, ab = 0.0, 0.0
    for i in range(ref.shape[0]):
        d = float((got[i] - ref[i]).abs().max())
        scale = float(ref[i].abs().max())
        rel = max(rel, d / scale if scale > 0 else (math.inf if d else 0.0))
        ab = max(ab, d)
    return rel, ab


def phase_adjoint_kernels(timing):
    import torch
    from xrt_tpu_torch import histogram as th
    from xrt_tpu_torch.ops import kirchhoff as tk
    plain_ms_of = {}
    for mode in ('mono', 'narrowband', 'poly', 'fast', 'exact'):
        args = kernel_case_args('mono' if mode == 'mono' else 'poly')
        scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
        Nd, Ns = D.shape[1], S.shape[1]
        G = torch.randn((10, Nd), device='cuda',
                        generator=torch.Generator('cuda').manual_seed(7))
        got = launch_adjoint(scheme, v, D, tk._pad_sources(S), P, G)
        again = launch_adjoint(scheme, v, D, tk._pad_sources(S), P, G)
        torch.cuda.synchronize()
        same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
        check(same, f'B3 {mode}: two launches on the same inputs differ')
        if mode == 'mono':      # warm-up
            tk.kirchhoff_bwd_blocked(scheme, v, D, S, P, G)
        plain_ms, ref = cuda_ms(lambda: tk.kirchhoff_bwd_blocked(
            scheme, v, D, S, P, G))
        check(all(bool(torch.isfinite(t).all()) for t in got
                  if t is not None), f'B3 {mode}: non-finite cotangents')
        relD = row_errors(got[0], ref[0])[0]
        relS = row_errors(got[1][:, :Ns], ref[1])[0]
        relP = 0.0 if ref[2] is None else \
            row_errors(got[2][:, None], ref[2][:, None])[0]
        ms = statistics.median(cuda_ms(lambda: launch_adjoint(
            scheme, v, D, tk._pad_sources(S), P, G))[0] for _ in range(3))
        print(f'phase 8 B3 {mode}: {Nd} x {Ns}, kernel vs plain blocked '
              f'backward, max row rel: dst keys {relD:.2e}, src keys '
              f'{relS:.2e}, scalars {relP:.2e} (limit {ADJ_LIMIT:.0e}); '
              f'two launches bit-identical; kernel {ms:.2f} ms, plain '
              f'{plain_ms:.1f} ms', flush=True)
        check(max(relD, relS, relP) < ADJ_LIMIT,
              f'B3 {mode}: {relD:.3e} / {relS:.3e} / {relP:.3e}')
        plain_ms_of[mode] = plain_ms
    timing['adjoint_plain_ms'] = plain_ms_of

    for case in ('shared', 'global', '1d', 'special', 'ragged'):
        for k in (1, 3):
            x, y, _, xbins, ybins, xlim, ylim = hist_case(case, k)
            g = torch.rand((ybins, xbins, k), device='cuda',
                           generator=torch.Generator('cuda').manual_seed(k))
            got = th.hist2d_bwd_kernel(x, y, g, xbins, ybins, xlim, ylim)
            torch.cuda.synchronize()
            same = torch.equal(got, th.hist2d_bwd_plain(x, y, g, xbins,
                                                        ybins, xlim, ylim))
            print(f'phase 8 B4-bwd {case} k={k}: {x.shape[0]} rays from '
                  f'{ybins} x {xbins}, kernel vs advanced indexing '
                  f'{"equal" if same else "DIFFER"}', flush=True)
            check(same, f'B4-bwd {case} k={k} differs from indexing')
    # the scalar path (views one ray into their storage: 4-byte, not
    # 16-byte, aligned), ray counts 1 to 7 (the scalar tail) and float64
    x, y, _, xbins, ybins, xlim, ylim = hist_case('ragged', 3)
    for k in (1, 3):
        g = torch.rand((ybins, xbins, k), device='cuda',
                       generator=torch.Generator('cuda').manual_seed(k))
        cases = [(x[1:], y[1:], g), (x.double(), y.double(), g.double())] + \
            [(x[:m], y[:m], g) for m in range(1, 8)]
        for xx, yy, gg in cases:
            got = th.hist2d_bwd_kernel(xx, yy, gg, xbins, ybins, xlim, ylim)
            check(torch.equal(got, th.hist2d_bwd_plain(
                xx, yy, gg, xbins, ybins, xlim, ylim)),
                f'B4-bwd k={k}: {xx.shape[0]} rays of {xx.dtype} at offset '
                f'{xx.storage_offset()} differ from indexing')
        print(f'phase 8 B4-bwd k={k}: views at a 4-byte offset, 1 to 7 rays '
              f'and float64 equal to advanced indexing', flush=True)


def sweep_plain_blocks():
    """Times and peak memory of the plain blocked backward (recentred mono,
    8192 x 16384) for four (destination block, source chunk) sizes."""
    import torch
    from xrt_tpu_torch.ops import kirchhoff as tk
    scheme, v, D, S, P = tk._kernel_inputs(*kernel_case_args('mono'), 'mono')
    G = torch.randn((10, D.shape[1]), device='cuda',
                    generator=torch.Generator('cuda').manual_seed(7))
    tk.kirchhoff_bwd_blocked(scheme, v, D, S, P, G)      # warm-up
    for blk, chunk in ((2048, 512), (4096, 1024), (8192, 512), (8192, 2048)):
        torch.cuda.reset_peak_memory_stats()
        ms, _ = cuda_ms(lambda: tk.kirchhoff_bwd_blocked(
            scheme, v, D, S, P, G, blk, chunk))
        print(f'plain blocked backward, recentred mono, {D.shape[1]} x '
              f'{S.shape[1]}: blocks of {blk} x {chunk} {ms:.1f} ms, peak '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB',
              flush=True)


@contextlib.contextmanager
def plain_recentred_adjoint():
    """Within the block, the backward of the recentred autograd function
    runs the plain blocked backward where it launches its adjoint kernels
    (on the same padded sources: zero weights and fields, cotangents that
    the function drops).  The reference of a gradient on the card.  Yields
    a dict that takes the plain backward's time in ms by destination
    count."""
    from xrt_tpu_torch.ops import kirchhoff as tk
    kernel = tk._launch_recentred_bwd
    times = {}

    def plain(D, S, P, G, v):
        times[D.shape[1]], out = cuda_ms(lambda: tk.kirchhoff_bwd_blocked(
            'recentred', v, D, S, P, G))
        return out
    tk._launch_recentred_bwd = plain
    try:
        yield times
    finally:
        tk._launch_recentred_bwd = kernel


def grad_context(run, els):
    """What the gradient of the chain needs beside its build: the
    linearized-retargeting Jacobians (host float64, exact transforms) of
    the toroid's receiving samples and of the screen's samples with
    respect to the toroid's pitch, the direction of a surface-height offset
    in the slit's frame with its profile (y / 40 mm)^2 along the mirror,
    and the loss weight (a Gaussian window off the screen's centre, so
    that no gradient vanishes by symmetry)."""
    import numpy as np
    import torch
    from xrt_tpu_torch import waves as W
    src, slit, tor, scr = els
    wv0, wv1, wv2 = run.waves
    dt = wv1.x.dtype

    def h64(t):
        return t.detach().double().cpu().numpy()

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device='cuda')
    J1 = dev(W._placement_jacobian(tor, slit, h64(wv1.x), h64(wv1.y),
                                   h64(wv1.z)))
    J2 = dev(W._placement_jacobian(scr, tor, h64(wv2.x), h64(wv2.y),
                                   h64(wv2.z), vary='from'))
    R1 = W.wave_frame_rotation(tor, slit)
    wgt = torch.exp(-(wv2.x ** 2 + (wv2.z - 0.004) ** 2) / 0.006 ** 2)
    return dict(J1=J1, J2=J2, R1=[float(v) for v in R1[:, 2]], wgt=wgt,
                profile=(wv1.y / 40.0) ** 2)


def chain_loss(run, els, ctx, w0, dp, dz, timings=None):
    """The Gaussian-weighted focal flux of the chain as a function of the
    source waist *w0*, the toroid's pitch offset *dp* and the amplitude
    *dz* of the height profile of its surface samples, through
    ``WaveChain.run``."""
    import torch
    src, slit, tor, scr = els
    wv0, wv1, wv2 = run.waves
    J1, J2, R1 = ctx['J1'], ctx['J2'], ctx['R1']
    tor_t = tor.replace(pitch=tor.pitch + dp)
    dz = dz * ctx['profile']
    a = wv0.replace(fromOE=src.replace(w0=w0))
    b = wv1.replace(xDiffr=wv1.xDiffr + J1[0] * dp + R1[0] * dz,
                    yDiffr=wv1.yDiffr + J1[1] * dp + R1[1] * dz,
                    zDiffr=wv1.zDiffr + J1[2] * dp + R1[2] * dz,
                    z=wv1.z + dz, toOE=tor_t)
    c = wv2.replace(xDiffr=wv2.xDiffr + J2[0] * dp,
                    yDiffr=wv2.yDiffr + J2[1] * dp,
                    zDiffr=wv2.zDiffr + J2[2] * dp, fromOE=tor_t)
    out, logs = run(torch.Generator().manual_seed(2), timings=timings,
                    waves=(a, b, c))
    flux = ((out.Jss + out.Jpp) * ctx['wgt']).double().sum()
    return flux * torch.exp(-2.0 * logs.double())


#: the working point of the gradients: (w0 mm, pitch offset rad, height
#: amplitude mm)
GRAD_POINT = (0.05, 0.0, 0.0)
GRAD_NAMES = ('w0', 'pitch offset', 'height amplitude')


def grad_leaves(dtype, point=GRAD_POINT):
    import torch
    return [torch.tensor(v, dtype=dtype, device='cuda', requires_grad=True)
            for v in point]


def phase_grad_main(timing):
    import torch
    from xrt_tpu_torch.ops import kirchhoff as tk
    main = timing['main']
    run, els = main['run'], main['els']
    t0 = time.perf_counter()
    ctx = grad_context(run, els)
    t_ctx = time.perf_counter() - t0

    def step():
        leaves = grad_leaves(torch.float32)
        loss = chain_loss(run, els, ctx, *leaves)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss, grads
    step()      # warm-up
    torch.cuda.reset_peak_memory_stats()
    tk.LAUNCHES.clear()
    t0 = time.perf_counter()
    loss, grads = step()
    times = [time.perf_counter() - t0]
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for _ in range(2):
        t0 = time.perf_counter()
        loss, grads = step()
        times.append(time.perf_counter() - t0)
    fwd = []
    for _ in range(3):
        t0 = time.perf_counter()
        with torch.no_grad():
            chain_loss(run, els, ctx, *grad_leaves(torch.float32))
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t0)
    med, medf = statistics.median(times), statistics.median(fwd)
    vals = [float(g) for g in grads]
    tk.LAUNCHES.clear()
    t0 = time.perf_counter()
    with plain_recentred_adjoint() as plain_ms:
        ref = [float(g) for g in step()[1]]
    t_ref = time.perf_counter() - t0
    ref_launches = dict(tk.LAUNCHES)
    errs = [abs(a / b - 1) for a, b in zip(vals, ref)]
    print(f'phase 9 gradient main path: 200000 samples/wave, 256x256 screen, '
          f'float32; loss {float(loss.detach()):.6e}; gradients '
          f'{dict(zip(GRAD_NAMES, vals))}; forward + backward median of 3 '
          f'{med * 1e3:.1f} ms ({", ".join(f"{t * 1e3:.1f}" for t in times)}'
          f'), forward alone {medf * 1e3:.1f} ms '
          f'({", ".join(f"{t * 1e3:.1f}" for t in fwd)}), ratio '
          f'{med / medf:.2f}; {sum(main["pairs"]) / med:.3e} pairs/s; '
          f'retargeting Jacobians (host) {t_ctx:.2f} s; peak device memory '
          f'{peak / 2 ** 30:.2f} GiB; launches of one step {launches}',
          flush=True)
    print(f'phase 9 the same step with the plain blocked backward in place '
          f'of the adjoint kernels ({t_ref:.1f} s, launches {ref_launches}; '
          f'plain backward by destinations, ms: '
          f'{ {n: round(t, 1) for n, t in plain_ms.items()} }): '
          f'gradients {dict(zip(GRAD_NAMES, ref))}; kernels vs plain '
          f'{", ".join(f"{e:.2e}" for e in errs)} (limit '
          f'{GRAD_PLAIN_LIMIT:.0e})', flush=True)
    check(all(math.isfinite(v) and v != 0.0 for v in vals) and
          math.isfinite(float(loss.detach())),
          f'gradient main path: loss {float(loss.detach())}, gradients '
          f'{vals}')
    check(ref_launches == {'kirchhoff_recentred:mono': 2},
          f'plain-backward step: launches {ref_launches}')
    check(max(errs) < GRAD_PLAIN_LIMIT,
          f'gradient main path, kernels vs plain backward: {errs}')
    check(launches == {'kirchhoff_recentred:mono': 2,
                       'kirchhoff_recentred_bwd:mono': 2},
          f'gradient main path: launches {launches}')
    timing['grad_launches'] = launches
    timing['grad_plain_ms'] = plain_ms


def phase_grad_cross():
    import torch
    res = {}
    for dt in (torch.float32, torch.float64):
        run, els = build_chain(20_000, 64, dt, seed=4)
        ctx = grad_context(run, els)
        leaves = grad_leaves(dt)
        loss = chain_loss(run, els, ctx, *leaves)
        res[dt] = (float(loss.detach()), [float(g) for g in
                                 torch.autograd.grad(loss, leaves)])
        if dt == torch.float64:
            # four-point central differences: the steps sit between the
            # float64 phase rounding (one ulp of r is ~2e-6 rad at
            # k r = 1.3e10), which a smaller step amplifies, and the
            # curvature of the loss, whose h^2 term the stencil cancels
            fds = []
            for i, h in enumerate((1e-5, 3e-8, 4e-6)):
                f = {}
                for m in (-2, -1, 1, 2):
                    pt = list(GRAD_POINT)
                    pt[i] += m * h
                    with torch.no_grad():
                        f[m] = float(chain_loss(
                            run, els, ctx, *[torch.tensor(
                                v, dtype=dt, device='cuda') for v in pt]))
                fds.append((f[-2] - 8 * f[-1] + 8 * f[1] - f[2]) / (12 * h))
    (l32, g32), (l64, g64) = res[torch.float32], res[torch.float64]
    print(f'phase 10 gradient cross-check, 2e4 samples, 64x64 screen: loss '
          f'float32 {l32:.6e} float64 {l64:.6e}', flush=True)
    for name, a, b, fd in zip(GRAD_NAMES, g32, g64, fds):
        e32, efd = abs(a / b - 1), abs(b / fd - 1)
        print(f'phase 10 d/d({name}): float32 kernels {a:.6e}, float64 '
              f'plain {b:.6e}, finite difference {fd:.6e}; float32 vs '
              f'float64 {e32:.2e} (limit 3e-2), float64 vs FD {efd:.2e} '
              f'(limit 1e-3)', flush=True)
        check(e32 < 3e-2, f'gradient {name}: float32 vs float64 {e32:.3e}')
        check(efd < 1e-3, f'gradient {name}: float64 vs FD {efd:.3e}')


def phase_grad_b2(timing):
    """The toroid -> screen hop at full size: the gradient of the weighted
    flux with respect to a shift of the screen samples along the
    retargeting direction (destination cotangents) and to the amplitude of
    the height profile of the source samples (source cotangents), B2's
    adjoint against B1's."""
    import torch
    from xrt_tpu_torch import waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    main = timing['main']
    ctx = grad_context(main['run'], main['els'])
    oeLocal, wave = timing['stages'][1]
    J2, wgt = ctx['J2'], ctx['wgt']
    res, launches = {}, {}
    for pm in ('recentred', 'fast', 'exact'):
        dp, dz = grad_leaves(torch.float32, (0.0, 0.0))
        tk.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = W.diffract(
            oeLocal.replace(z=oeLocal.z + dz * ctx['profile']),
            wave.replace(xDiffr=wave.xDiffr + J2[0] * dp,
                         yDiffr=wave.yDiffr + J2[1] * dp,
                         zDiffr=wave.zDiffr + J2[2] * dp),
            phase_mode=pm, monochromatic=True, accumulate='mxu-fast',
            narrowband=False)
        loss = ((out.Jss + out.Jpp) * wgt).double().sum()
        grads = torch.autograd.grad(loss, [dp, dz])
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        launches[pm] = dict(tk.LAUNCHES)
        res[pm] = [float(loss.detach())] + [float(g) for g in grads]
        print(f'phase 11 toroid -> screen hop, {pm}: loss {res[pm][0]:.6e}, '
              f'd/d(pitch shift) {res[pm][1]:.6e}, d/d(height) '
              f'{res[pm][2]:.6e}; forward + backward {t * 1e3:.1f} ms; '
              f'launches {launches[pm]}', flush=True)
    for pm in ('fast', 'exact'):
        errs = [abs(a / b - 1) for a, b in zip(res[pm][1:],
                                               res['recentred'][1:])]
        print(f'phase 11 B2 {pm} gradient vs recentred: '
              f'{", ".join(f"{e:.2e}" for e in errs)} (limit 3e-2)',
              flush=True)
        check(max(errs) < 3e-2, f'B2 {pm} gradient vs recentred: {errs}')
        check(launches[pm] == {f'kirchhoff_ddphase:{pm}': 1,
                               f'kirchhoff_ddphase_bwd:{pm}': 1},
              f'B2 {pm} gradient: launches {launches[pm]}')
    timing['b2_grad_launches'] = {k: v for d in launches.values()
                                  for k, v in d.items()}


def trace_flux(src, tor, scr, beam, pitch, bins=128, rgb=False):
    """The weighted central flux on the screen through toroid (with the
    search) -> screen -> hist2d, as a function of the toroid's pitch: the
    loss of the reference package's trace-gradient test (a smooth central
    weight over +-2 mm, not a hard pixel edge).  The histogram passes a
    gradient to the weights only, so a finite difference also sees rays
    that change bins; the broad symmetric weight keeps that part small.
    With *rgb* the histogram has the three weight columns of a colour plot,
    here Jss, Jpp and their sum, all summed: twice the flux."""
    import torch
    from xrt_tpu_torch.histogram import hist2d, hist2d_rgb
    glo, _ = tor.replace(pitch=pitch).reflect(beam)
    img = scr.expose(glo)
    lim = (-2.0, 2.0)
    if rgb:
        good = (img.state == 1)[:, None]
        w = torch.stack([img.Jss, img.Jpp, img.Jss + img.Jpp], dim=1)
        h = hist2d_rgb(img.x, img.z, torch.where(good, w, 0.0), bins, bins,
                       lim, lim).sum(dim=-1)
    else:
        w = torch.where(img.state == 1, img.Jss + img.Jpp, 0.0)
        h = hist2d(img.x, img.z, w, bins, bins, lim, lim)
    c = torch.linspace(-2, 2, bins, dtype=w.dtype, device=w.device)
    wz = torch.exp(-c ** 2 / 0.5)
    return torch.sum(h * wz[:, None] * wz[None, :])


def phase_trace_grad(timing):
    import torch
    from xrt_tpu_torch import histogram as th
    n = TRACE_NRAYS
    src, tor, scr = trace_beamline(n, torch.float32)
    rng = torch.Generator('cuda').manual_seed(31)

    def step(beam, rgb=False):
        pitch = torch.tensor(TRACE_PITCH, device='cuda', requires_grad=True)
        flux = trace_flux(src, tor, scr, beam, pitch, rgb=rgb)
        g, = torch.autograd.grad(flux, [pitch])
        torch.cuda.synchronize()
        return float(flux.detach()), float(g)
    beam = src.shine(rng)
    step(beam)      # warm-up
    torch.cuda.reset_peak_memory_stats()
    th.LAUNCHES.clear()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        flux, g = step(beam)
        times.append(time.perf_counter() - t0)
    launches = dict(th.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    fwd = []
    for _ in range(3):
        t0 = time.perf_counter()
        with torch.no_grad():
            trace_flux(src, tor, scr, beam, torch.tensor(TRACE_PITCH,
                                                         device='cuda'))
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t0)
    med, medf = statistics.median(times), statistics.median(fwd)
    print(f'phase 12 trace gradient: {n} rays, float32, d(weighted central '
          f'flux)/d(pitch) {g:.6e} (flux {flux:.6e}); reflect + expose + '
          f'hist2d forward + backward median of 3 {med * 1e3:.1f} ms '
          f'({", ".join(f"{t * 1e3:.1f}" for t in times)}), forward alone '
          f'{medf * 1e3:.1f} ms; peak device memory {peak / 2 ** 30:.2f} '
          f'GiB; launches of the 3 steps {launches}', flush=True)
    check(math.isfinite(g) and g != 0.0, f'trace gradient {g}')
    check(launches == {'hist2d:k1:shared': 3, 'hist2d_bwd:k1': 3},
          f'trace gradient: launches {launches}')
    th.LAUNCHES.clear()
    flux3, g3 = step(beam, rgb=True)
    launches3 = dict(th.LAUNCHES)
    print(f'phase 12 trace gradient through the three-column histogram: '
          f'flux {flux3:.6e}, gradient {g3:.6e}; against twice the '
          f'one-column flux and gradient {abs(flux3 / (2 * flux) - 1):.2e}, '
          f'{abs(g3 / (2 * g) - 1):.2e} (limit 1e-4); launches {launches3}',
          flush=True)
    check(abs(flux3 / (2 * flux) - 1) < 1e-4 and abs(g3 / (2 * g) - 1) < 1e-4,
          f'three-column trace gradient {g3} against 2 x {g}')
    check(launches3 == {'hist2d:k3:shared': 1, 'hist2d_bwd:k3': 1},
          f'three-column trace gradient: launches {launches3}')
    timing['trace_grad_launches'] = {**launches, **launches3}

    res = {}
    for dt in (torch.float32, torch.float64):
        src, tor, scr = trace_beamline(200_000, dt)
        beam = src.shine(torch.Generator().manual_seed(21))
        pitch = torch.tensor(TRACE_PITCH, dtype=dt, device='cuda',
                             requires_grad=True)
        flux = trace_flux(src, tor, scr, beam, pitch, bins=16)
        res[dt], = torch.autograd.grad(flux, [pitch])
        if dt == torch.float64:
            h = 2e-6
            with torch.no_grad():
                fd = (float(trace_flux(src, tor, scr, beam, torch.tensor(
                    TRACE_PITCH + h, dtype=dt, device='cuda'), bins=16)) -
                    float(trace_flux(src, tor, scr, beam, torch.tensor(
                        TRACE_PITCH - h, dtype=dt, device='cuda'),
                        bins=16))) / (2 * h)
    g32, g64 = float(res[torch.float32]), float(res[torch.float64])
    print(f'phase 12 trace gradient at 2e5 rays, 16 x 16 bins, the same '
          f'float64 samples: float32 {g32:.6e}, float64 {g64:.6e}, finite '
          f'difference {fd:.6e}; float32 vs float64 {abs(g32 / g64 - 1):.2e}'
          f', float64 vs FD {abs(g64 / fd - 1):.2e} (limits 0.1)',
          flush=True)
    check(abs(g32 / g64 - 1) < 0.1, f'trace gradient f32 {g32} f64 {g64}')
    check(abs(g64 / fd - 1) < 0.1, f'trace gradient f64 {g64} FD {fd}')


def sliced_adjoint_errors(scheme, v, D, S, P, G, got, Ns):
    """The adjoint kernels' result *got* at a main-path shape against the
    plain blocked backward on the slices it can do in seconds.  Returns
    the largest row error of the destination rows, of the source rows and
    of the scalars, and the largest absolute difference."""
    import torch
    from xrt_tpu_torch.ops import kirchhoff as tk
    d0, s0 = D.shape[1] - ADJ_DST_SLICE, Ns - ADJ_SRC_SLICE
    # the last destinations against all sources: their rows, and what they
    # alone give to every source row and to the scalars
    refD, refS_of_d, refP_of_d = tk.kirchhoff_bwd_blocked(
        scheme, v, D[:, d0:], S[:, :Ns], P, G[:, d0:])
    relD, ab = row_errors(got[0][:, d0:], refD)
    # the last sources against all destinations: their rows
    refS = tk.kirchhoff_bwd_blocked(scheme, v, D, S[:, s0:Ns], P, G)[1]
    relS, abS = row_errors(got[1][:, s0:Ns], refS)
    # the same shape once more, with zero cotangents but for the last
    # destinations: every source row and the scalars
    Gm = torch.zeros_like(G)
    Gm[:, d0:] = G[:, d0:]
    gm = launch_adjoint(scheme, v, D, S, P, Gm)
    check(not bool(gm[0][:, :d0].any()),
          'destinations with zero cotangents got non-zero rows')
    relSm, abSm = row_errors(gm[1][:, :Ns], refS_of_d)
    relP, abP = (0.0, 0.0) if refP_of_d is None else \
        row_errors(gm[2][:, None], refP_of_d[:, None])
    return relD, max(relS, relSm), relP, max(ab, abS, abSm, abP)


def adjoint_rows(timing):
    """The rows of the adjoint kernels at their paths' shapes."""
    import torch
    from xrt_tpu_torch import histogram as th, waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    rows = []
    stages = timing['stages']
    specs = [('kirchhoff_recentred_bwd', 'mono', stages[0],
              timing['grad_launches']),
             ('kirchhoff_recentred_bwd', 'mono', stages[1],
              timing['grad_launches']),
             ('kirchhoff_ddphase_bwd', 'fast', stages[1],
              timing['b2_grad_launches']),
             ('kirchhoff_ddphase_bwd', 'exact', stages[1],
              timing['b2_grad_launches'])]
    for name, variant, stage, launches in specs:
        args = W.kirchhoff_kernel_args(*stage)
        scheme, v, D, S, P = tk._kernel_inputs(*args, variant)
        S = tk._pad_sources(S)
        Nd, Ns = D.shape[1], stage[0].x.shape[0]
        G = torch.randn((10, Nd), device='cuda',
                        generator=torch.Generator('cuda').manual_seed(9))
        got = launch_adjoint(scheme, v, D, S, P, G)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got
                  if t is not None),
              f'{name}:{variant} at {Nd} x {Ns}: non-finite cotangents')
        ms = statistics.median(cuda_ms(lambda: launch_adjoint(
            scheme, v, D, S, P, G))[0] for _ in range(3))
        # the second kernel's share: the partials of one pass summed
        parts = tk._adjoint_pass(scheme, v, D, S, P, G)
        red_ms = statistics.median(cuda_ms(lambda: tk._adjoint_reduce(
            scheme, v, parts[0], parts[1], D, S))[0] for _ in range(3))
        scratch = sum(t.numel() * t.element_size() for t in parts
                      if t is not None)
        del parts
        regs, spill = adjoint_registers(scheme, v)
        t0 = time.perf_counter()
        relD, relS, relP, ab = sliced_adjoint_errors(scheme, v, D, S, P, G,
                                                     got, Ns)
        t_ref = time.perf_counter() - t0
        key = f'{name}:{variant}'
        bms, by = bound_ms(key, Nd, Ns)
        # the plain version's time at this shape where the gradient main
        # path's reference step ran it, else at 8192 x 16384
        if variant == 'mono':
            plain_ms, plain_shape = timing['grad_plain_ms'][Nd], f'{Nd}x{Ns}'
        else:
            plain_ms, plain_shape = timing['adjoint_plain_ms'][variant], \
                '8192x16384'
        print(f'phase 5 {key}: {Nd} x {Ns} pairs, kernel {ms:.2f} ms (one '
              f'pass, the reduction of its partials {red_ms:.3f} ms of it), '
              f'bound {bms:.2f} ms ({by}), {bms / ms:.1%} of bound, '
              f'{Nd * Ns / (ms * 1e-3):.3e} pairs/s; scratch '
              f'{scratch / 2 ** 30:.3f} GiB; {regs} registers, {spill} B '
              f'spilled; against the plain '
              f'blocked backward on the last {ADJ_DST_SLICE} destinations '
              f'and the last {ADJ_SRC_SLICE} sources ({t_ref:.1f} s), max '
              f'row rel: dst keys {relD:.2e}, src keys {relS:.2e}, scalars '
              f'{relP:.2e} (limit {ADJ_LIMIT:.0e}); plain blocked backward '
              f'at {plain_shape} {plain_ms:.1f} ms', flush=True)
        check(max(relD, relS, relP) < ADJ_LIMIT,
              f'{key} at {Nd} x {Ns}: {relD:.3e} / {relS:.3e} / {relP:.3e}')
        rows.append(dict(name=f'{key}:{Nd}x{Ns}', route='cuda',
                         source=SOURCES[name], replaces=REPLACES[name],
                         launches=int(launches.get(key, 0)),
                         max_abs_err=ab, max_rel_err=max(relD, relS, relP),
                         err_shape=f'{Nd}x{Ns}, on slices', ms=ms,
                         reduce_ms=red_ms, scratch_bytes=scratch,
                         registers=regs, spill_bytes=spill,
                         plain_ms=plain_ms, plain_shape=plain_shape,
                         bound_ms=bms, bound_by=by, library_ms=None,
                         library=None, library_reason=NO_LIBRARY))
        check(rows[-1]['launches'] > 0, f'{key} was not launched on its '
              'path')

    # B4-bwd on the rays of a main-path pass: the gather of a (128, 128, k)
    # cotangent, k = 1 as in the trace gradient and k = 3 as through a
    # colour plot; the library call is the advanced-indexing gather
    tr = timing['trace']
    x, y, bins = tr['x'], tr['y'], 128
    fx, inx = th._bin_index(x, tr['xlim'], bins)
    fy, iny = th._bin_index(y, tr['ylim'], bins)
    flat = torch.where(inx & iny, fy * bins + fx,
                       torch.zeros_like(fx)).long()
    n = x.shape[0]
    for k in (1, 3):
        g = torch.rand((bins, bins, k), device='cuda',
                       generator=torch.Generator('cuda').manual_seed(3))
        args = (x, y, g, bins, bins, tr['xlim'], tr['ylim'])
        th.hist2d_bwd_kernel(*args)
        torch.cuda.synchronize()
        ms = statistics.median(cuda_ms(
            lambda: th.hist2d_bwd_kernel(*args), 5)[0] for _ in range(3))
        got = th.hist2d_bwd_kernel(*args)
        plain_ms, ref = cuda_ms(lambda: th.hist2d_bwd_plain(*args))
        key = f'hist2d_bwd:k{k}'
        check(torch.equal(got, ref), f'{key} at main-path shapes differs '
              'from indexing')
        g2 = g.reshape(-1, k)
        lib_ms = statistics.median(cuda_ms(lambda: g2[flat], 3)[0]
                                   for _ in range(3))
        bms = 1e3 * (4.0 * n * (2 + k) + 4.0 * bins * bins * k) / PEAK_BYTES
        print(f'phase 5 {key}: {n} rays from {bins} x {bins} x {k}, '
              f'kernel {ms:.3f} ms ({bms / ms:.1%} of bound), plain '
              f'{plain_ms:.2f} ms, indexing gather {lib_ms:.3f} ms '
              f'({bms / lib_ms:.1%}), bound {bms:.3f} ms (bytes); kernel / '
              f'indexing {ms / lib_ms:.3f}; {n / (ms * 1e-3):.3e} rays/s, '
              f'equal to indexing', flush=True)
        rows.append(dict(name=key, route='cuda', source=SOURCES['hist2d'],
                         replaces=REPLACES['hist2d'],
                         launches=int(timing['trace_grad_launches'].get(
                             key, 0)),
                         max_abs_err=float((got - ref).abs().max()),
                         max_rel_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by='bytes', library_ms=lib_ms))
        check(rows[-1]['launches'] > 0, f'{key} was not launched on its '
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
    if sys.argv[1:] == ['--sweep-plain-blocks']:
        phase_card()
        sweep_plain_blocks()
        return 0
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
        phase_adjoint_kernels(timing)
        phase_grad_main(timing)
        phase_grad_cross()
        phase_grad_b2(timing)
        phase_trace_grad(timing)
        rows = phase_kernel_line(timing) + hist_rows(timing) + \
            adjoint_rows(timing)
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
