#!/usr/bin/env python3
"""The port's histogram kernels against those of an earlier commit, on one
NVIDIA GPU, in one process: a plot's histogram step (``hist_plot``, one
launch for the eight histograms with colorize) and the weighted histogram
``hist2d_kernel`` (B4), on the rays of one pass of the trace main path of
``chip_smoke.py`` (1e7 rays, float32).

    git archive <commit> xrt_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/torch_hist_compare.py build/parent/xrt_tpu_torch/csrc

The earlier sources must have the C entry ``hist2d_launch`` of the
float-atomics kernel (its last arguments: ``use_shared``, the stream).
Without an argument only the current kernels run.  Prints:

* the card's name and power limit;
* every histogram kernel's registers and spills (``nvcc -Xptxas -v``) and
  its atomic and match instructions (``cuobjdump -sass``: whether a 64-bit
  or shared add is native or a compare-and-swap loop);
* checks: ``hist_plot`` and ``hist2d_kernel`` from two launches and from
  every route that takes the table bit-identical, and against the plain
  versions with float64 sums (< 1e-5 of the largest bin, the same
  non-empty bins);
* one trace pass of ``run_ray_tracing`` with the earlier histogram step
  and with ``hist_plot``, in turns (host clock, median of 4 passes);
* times by CUDA events (median of 3 runs of 5 calls), earlier and current
  in turns (earlier, current, current, earlier): the earlier histogram step
  of a plot (colorize and eight launches of the earlier kernel) against
  ``hist_plot`` at 128 and 1024 bins with each route; the kernel's three
  launches (scale pass, main kernel, conversion) by ``torch.profiler``;
  ``hist2d_kernel`` at 128 x 128 (k = 1, 3) and 1024 x 1024 (k = 3) with
  each route, beside the earlier kernel, ``index_add_`` on prepared
  indices and the plain version; and each one's bytes bound.

Writes the numbers to ``build/compare/hist_compare.json`` as well.
"""
import contextlib
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
BUILD = ROOT / 'build' / 'compare'
OUT = BUILD / 'hist_compare.json'
NVCC = '/usr/local/cuda/bin/nvcc'
CUOBJDUMP = '/usr/local/cuda/bin/cuobjdump'
P_ = ctypes.c_void_p
EARLIER_ARGTYPES = ([ctypes.c_int, ctypes.c_int, P_, P_, P_,
                     ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
                     ctypes.c_int, ctypes.c_double, ctypes.c_double,
                     ctypes.c_int, P_, ctypes.c_int, P_])
EARLIER_MAX_SHARED = 232448
PEAK_BYTES = 3.35e12
SASS_OPS = re.compile(r'\b(ATOMS|ATOMG|ATOM|REDG|RED|MATCH)(\.[A-Z0-9_.]+)?')


def say(line):
    print(line, flush=True)


def sass_summary(so):
    """{kernel: {instruction: count}} of the atomics and matches."""
    txt = subprocess.run([CUOBJDUMP, '-sass', str(so)], capture_output=True,
                         text=True).stdout
    out, name = {}, None
    for line in txt.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            name = subprocess.run(['c++filt', m.group(1)],
                                  capture_output=True,
                                  text=True).stdout.strip() or m.group(1)
            name = re.sub(r'\(.*', '', name).replace('(anonymous namespace)::',
                                                     '')
            continue
        for op in SASS_OPS.finditer(line):
            d = out.setdefault(name, {})
            key = op.group(0)
            d[key] = d.get(key, 0) + 1
    return out


def build_earlier(csrc):
    from xrt_tpu_torch.ops import _cuda
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / 'libearlier_hist2d.so'
    r = subprocess.run([NVCC, *_cuda.NVCC_FLAGS, '-I', str(csrc), '-o',
                        str(so), str(csrc / 'hist2d.cu')],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    f = ctypes.CDLL(str(so)).hist2d_launch
    f.argtypes, f.restype = EARLIER_ARGTYPES, ctypes.c_int
    return f


def build_variant(tag, defines):
    """{name: library} of the current sources built with extra defines."""
    from xrt_tpu_torch.ops import _cuda
    d = BUILD / tag
    d.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ('hist2d', 'hist_plot'):
        so = d / f'lib{name}.so'
        r = subprocess.run([NVCC, *_cuda.NVCC_FLAGS, *defines, '-o', str(so),
                            str(_cuda.CSRC / f'{name}.cu')],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(r.stdout + r.stderr)
        libs[name] = ctypes.CDLL(str(so))
    return libs


@contextlib.contextmanager
def using(libs):
    """The wrappers launch the kernels of *libs* inside the block."""
    from xrt_tpu_torch.ops import _cuda
    load = _cuda.load
    _cuda.load = lambda name: libs[name] if name in libs else load(name)
    try:
        yield
    finally:
        _cuda.load = load


def main():
    import torch
    import chip_smoke as cs
    from xrt_tpu_torch import histogram as th, runner
    from xrt_tpu_torch.ops import _cuda
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    say(f'card: {card}')
    res = dict(card=card, checks={}, times={}, sass={}, ptxas={})
    _cuda.build(('hist2d', 'hist_plot'))
    for name in ('hist2d', 'hist_plot'):
        rows = cs.ptxas_rows(_cuda.build_log(name))
        for fn, regs, st, ld in rows:
            say(f'ptxas {name} {fn}: {regs} registers, spill stores {st} B, '
                f'loads {ld} B')
        res['ptxas'][name] = rows
        sass = sass_summary(_cuda.library_path(name))
        for fn, ops in sorted(sass.items()):
            say(f'sass {name} {fn}: {ops}')
        res['sass'][name] = sass
    args_ = [a for a in sys.argv[1:] if not a.startswith('-D')]
    defines = [a for a in sys.argv[1:] if a.startswith('-D')]
    earlier = build_earlier(Path(args_[0])) if args_ else None

    # the rays of one pass of the trace main path, limits from a
    # calibration pass
    n = cs.TRACE_NRAYS
    src, tor, scr = cs.trace_beamline(n, torch.float32)
    rng = torch.Generator('cuda').manual_seed(11)

    def one_pass():
        glo, _ = tor.reflect(src.shine(rng))
        return {'screen': scr.expose(glo)}
    plots = {b: cs.trace_plot(b) for b in (128, 1024)}
    for p in plots.values():
        runner.calibrate_limits([p], one_pass())
    beams = one_pass()
    torch.cuda.synchronize()

    def med(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        return statistics.median(cs.cuda_ms(fn, reps)[0] for _ in range(3))

    def plot_args(p):
        x, y, c, inten, flux, mask, _ = runner._plot_arrays(p, beams)
        lims = tuple(tuple(a.limits) for a in (p.xaxis, p.yaxis, p.caxis))
        bins = (p.xaxis.bins, p.yaxis.bins, p.caxis.bins)
        return (x, y, c, flux, inten, mask, bins, lims, p.colorFactor,
                p.colorSaturation)

    def earlier_hist(x, y, W, bins, xlim, ylim):
        k = W.shape[1]
        yb = 1 if y is None else bins
        out = torch.zeros((yb, bins, k), device='cuda')
        shared = yb * bins * k * 4 <= EARLIER_MAX_SHARED
        err = earlier(0, k, x.data_ptr(), None if y is None else y.data_ptr(),
                      W.data_ptr(), x.shape[0], float(xlim[0]),
                      float(xlim[1]) - float(xlim[0]), bins,
                      0.0 if y is None else float(ylim[0]),
                      1.0 if y is None else float(ylim[1]) - float(ylim[0]),
                      yb, out.data_ptr(), int(shared),
                      _cuda.stream_ptr(x.device))
        _cuda.check(err, 'earlier hist2d')
        return out

    def earlier_step(x, y, c, flux, inten, mask, bins, lims, cf, cs_):
        """the earlier histogram step of a plot: colorize and 8 launches"""
        (xb, yb, cb), (xl, yl, cl) = bins, lims
        fm = mask.to(x.dtype)
        af = torch.abs(flux * fm)
        w2 = (inten * fm)[:, None]
        rgb = th.colorize(c, af, cl, cf, cs_)
        a1 = af[:, None]
        return [earlier_hist(x, None, a1, xb, xl, None),
                earlier_hist(x, None, rgb, xb, xl, None),
                earlier_hist(y, None, a1, yb, yl, None),
                earlier_hist(y, None, rgb, yb, yl, None),
                earlier_hist(c, None, a1, cb, cl, None),
                earlier_hist(c, None, rgb, cb, cl, None),
                earlier_hist(x, y, w2, xb, xl, yl),
                earlier_hist(x, y, rgb, xb, xl, yl), torch.sum(af)]

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    if earlier is not None:
        pass_times(res, earlier_step, one_pass, plots[128])

    for bins, p in plots.items():
        args = plot_args(p)
        auto = th.plot_route((bins,) * 3)
        routes = th.ROUTES[th.ROUTES.index(auto):]
        outs = {r: th.hist_plot_kernel(*args, route=r) for r in routes}
        again = th.hist_plot_kernel(*args)
        ref = th.hist_plot_plain(*args, sum_dtype=torch.float64)
        ok = same(outs[auto], again) and all(same(outs[auto], o)
                                             for o in outs.values())
        worst, nonempty = 0.0, True
        for k in th.PLOT_HISTS:
            r = ref[k]
            worst = max(worst, float((outs[auto][k].double() - r).abs().max()
                                     / r.abs().max()))
            nonempty &= bool(torch.equal(outs[auto][k] != 0, r != 0))
        ti = abs(float(outs[auto]['intensity']) / float(ref['intensity']) - 1)
        say(f'check hist_plot {bins} bins: routes {routes} and two launches '
            f'bit-identical {ok}; vs float64 sums max rel {worst:.2e}, '
            f'non-empty bins identical {nonempty}; total rel {ti:.1e}')
        res['checks'][f'hist_plot:{bins}'] = dict(
            bits=ok, max_rel=worst, nonempty=nonempty, total_rel=ti)
        # times, in turns
        t = {}
        fns = {f'route {r}': (lambda r=r: th.hist_plot_kernel(*args,
                                                              route=r))
               for r in routes}
        fns['plain'] = lambda: th.hist_plot_plain(*args)
        order = list(fns)
        if earlier is not None:
            fns['earlier step'] = lambda: earlier_step(*args)
            order = ['earlier step'] + order + order[::-1] + ['earlier step']
        else:
            order = order + order[::-1]
        for name in order:
            t.setdefault(name, []).append(med(fns[name]))
        nb = 4 * (3 * bins + bins * bins) + 1
        bound = 1e3 * (21.0 * n + 4.0 * nb) / PEAK_BYTES
        say(f'time hist_plot {bins} bins: ' + ', '.join(
            f'{k} {" / ".join(f"{v:.4f}" for v in vs)} ms'
            for k, vs in t.items()) + f'; bound {bound:.4f} ms (bytes)')
        # the three launches of the auto route, by the profiler
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                th.hist_plot_kernel(*args)
            torch.cuda.synchronize()
        parts = {e.key: e.device_time_total / e.count / 1e3
                 for e in prof.key_averages() if e.device_time_total > 0}
        say(f'parts hist_plot {bins} bins ({auto}): ' + ', '.join(
            f'{k[:60]} {v:.4f} ms' for k, v in parts.items()))
        res['times'][f'hist_plot:{bins}'] = dict(t, bound_ms=bound,
                                                  parts_ms=parts, route=auto)

    # hist2d_kernel at the main path's shapes
    x, y, c, inten, flux, mask, _ = runner._plot_arrays(plots[128], beams)
    fm = mask.to(x.dtype)
    w = (inten * fm)[:, None].contiguous()
    rgb = th.colorize(c, torch.abs(flux * fm), plots[128].caxis.limits,
                      0.85, 1.0).contiguous()
    for name, W, bins in (('k1 128', w, 128), ('k3 128', rgb, 128),
                          ('k3 1024', rgb, 1024)):
        p = plots[bins]
        xl, yl = tuple(p.xaxis.limits), tuple(p.yaxis.limits)
        k = W.shape[1]
        hargs = (x, y, W, bins, bins, xl, yl)
        routes = [r for r in th.ROUTES
                  if th.ROUTES.index(r) >= th.ROUTES.index(
                      th.hist_route(bins, bins, k))]
        outs = {r: th.hist2d_kernel(*hargs, route=r) for r in routes}
        auto = th.hist_route(bins, bins, k)
        again = th.hist2d_kernel(*hargs)
        ok = all(torch.equal(outs[auto], o) for o in outs.values()) and \
            torch.equal(again, outs[auto])
        ref = th.hist2d_plain(*hargs, sum_dtype=torch.float64)
        rel = float((outs[auto].double() - ref).abs().max() / ref.abs().max())
        ne = bool(torch.equal(outs[auto] != 0, ref != 0))
        say(f'check hist2d {name}: routes {routes} and two launches '
            f'bit-identical {ok}; vs float64 max rel {rel:.2e}, non-empty '
            f'bins identical {ne}')
        res['checks'][f'hist2d:{name}'] = dict(bits=ok, max_rel=rel,
                                               nonempty=ne)
        fx, inx = th._bin_index(x, xl, bins)
        fy, iny = th._bin_index(y, yl, bins)
        inside = inx & iny
        flat = torch.where(inside, fy * bins + fx, torch.zeros_like(fx)).long()
        wi = torch.where(inside[:, None], W, torch.zeros_like(W))
        fns = {f'route {r}': (lambda r=r: th.hist2d_kernel(*hargs, route=r))
               for r in routes}
        fns['index_add_'] = lambda: torch.zeros(
            (bins * bins, k), device='cuda').index_add_(0, flat, wi)
        fns['plain'] = lambda: th.hist2d_plain(*hargs)
        order = list(fns)
        if earlier is not None:
            fns['earlier'] = lambda: earlier_hist(x, y, W, bins, xl, yl)
            order = ['earlier'] + order + order[::-1] + ['earlier']
        else:
            order = order + order[::-1]
        t = {}
        for key in order:
            t.setdefault(key, []).append(med(fns[key]))
        bound = 1e3 * (4.0 * n * (2 + k) + 4.0 * bins * bins * k) / PEAK_BYTES
        say(f'time hist2d {name}: ' + ', '.join(
            f'{key} {" / ".join(f"{v:.4f}" for v in vs)} ms'
            for key, vs in t.items()) + f'; bound {bound:.4f} ms (bytes)')
        res['times'][f'hist2d:{name}'] = dict(t, bound_ms=bound, route=auto)
    for j, d in enumerate(defines):
        variant_times(res, build_variant(f'variant{j}', [d]), [d], plots,
                      beams, med)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(res, indent=1, default=str))
    ok = all(v['bits'] and v['nonempty'] and v['max_rel'] < 1e-5
             for v in res['checks'].values())
    say(f'all checks {"passed" if ok else "FAILED"}')
    return 0 if ok else 1


def pass_times(res, earlier_step, one_pass, calibrated):
    """One trace pass of ``run_ray_tracing`` (1e7 rays, a 128-bin plot, 4
    repeats after a warm-up run) with the earlier histogram step in place of
    ``runner.histogram_plot`` and with the current one, in turns: the
    median time a pass by the host clock after a synchronize."""
    import time
    import torch
    import chip_smoke as cs
    from xrt_tpu_torch import runner
    current = runner.histogram_plot

    def earlier(plot, beams):
        x, y, c, inten, flux, mask, counters = runner._plot_arrays(plot,
                                                                   beams)
        lims = tuple(tuple(a.limits) for a in (plot.xaxis, plot.yaxis,
                                               plot.caxis))
        bins = (plot.xaxis.bins, plot.yaxis.bins, plot.caxis.bins)
        h = earlier_step(x, y, c, flux, inten, mask, bins, lims,
                         plot.colorFactor, plot.colorSaturation)
        out = {}
        for k, v in zip(('xh', 'xhRGB', 'yh', 'yhRGB', 'eh', 'ehRGB', 'xyh',
                         'xyhRGB'), h[:8]):
            if k == 'xyh':
                v = v[..., 0]
            elif k != 'xyhRGB':
                v = v[0] if k.endswith('RGB') else v[0, :, 0]
            out[k] = v
        out.update(intensity=h[8], counters=counters)
        return out

    def run(step):
        runner.histogram_plot = step
        try:
            plot = cs.trace_plot(128)
            for a, b in zip((plot.xaxis, plot.yaxis, plot.caxis),
                            (calibrated.xaxis, calibrated.yaxis,
                             calibrated.caxis)):
                a.limits = list(b.limits)
            t = []

            def run_process(beamLine, rng):
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                return one_pass()
            runner.run_ray_tracing(plot, repeats=4, run_process=run_process)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            return statistics.median(1e3 * (b - a) for a, b in zip(t, t[1:]))
        finally:
            runner.histogram_plot = current
    run(current)        # warm-up
    t = {'earlier': [], 'current': []}
    for who in ('earlier', 'current', 'current', 'earlier'):
        t[who].append(run(earlier if who == 'earlier' else current))
    say(f'time trace pass (1e7 rays, 128-bin plot, median of 4 passes): '
        f'earlier histogram step {" / ".join(f"{v:.2f}" for v in t["earlier"])}'
        f' ms, hist_plot {" / ".join(f"{v:.2f}" for v in t["current"])} ms')
    res['times']['trace_pass'] = t


def variant_times(res, libs, defines, plots, beams, med):
    """The current kernels against the same sources built with *defines*,
    in turns, on the trace's rays and on a focused beam; and whether the
    two give the same bits."""
    import torch
    import chip_smoke as cs
    from xrt_tpu_torch import histogram as th, runner
    cases = {}
    p = plots[128]
    x, y, c, inten, flux, mask, _ = runner._plot_arrays(p, beams)
    lims = tuple(tuple(a.limits) for a in (p.xaxis, p.yaxis, p.caxis))
    trace = (x, y, c, flux, inten, mask, (128, 128, 128), lims, 0.85, 1.0)
    cases['hist_plot trace global'] = (th.hist_plot_kernel, trace, 'global')
    cases['hist_plot focused global'] = (
        th.hist_plot_kernel, cs.plot_case('focused', 128), 'global')
    for k, route in ((1, 'shared'), (3, 'global')):
        for case in ('shared', 'focused'):
            cases[f'hist2d k{k} {case} {route}'] = (
                th.hist2d_kernel, cs.hist_case(case, k), route)
    out = {}
    for name, (fn, args, route) in cases.items():
        t = {'current': [], 'variant': []}
        for who in ('current', 'variant', 'variant', 'current'):
            with using(libs if who == 'variant' else {}):
                t[who].append(med(lambda: fn(*args, route=route)))
        with using(libs):
            b = fn(*args, route=route)
        a = fn(*args, route=route)
        same = cs.bits_equal(a, b)
        say(f'variant {" ".join(defines)} {name}: current '
            f'{" / ".join(f"{v:.4f}" for v in t["current"])} ms, variant '
            f'{" / ".join(f"{v:.4f}" for v in t["variant"])} ms; same bits '
            f'{same}')
        out[name] = dict(t, same_bits=same)
    res.setdefault('variants', []).append(dict(defines=defines, times=out))


if __name__ == '__main__':
    sys.exit(main())
