"""The diced Johansson analyzer on the PyTorch port: speed test 1 of xrt.

Workload (xrt tests/speed/1_SourceZCrystalThetaAlpha_speed.py): a diced
Johansson 2D-bent Si(444) crystal analyzer (R = 500 mm, theta = 60 deg,
facets 2.1 x 1.4 mm with 0.05 mm gaps) traced from three geometric sources
(a flat energy band, a single line, 7 lines), 96 iterations x 1e5 rays
each, each iteration filling xrt's three histograms: the crystal's
footprint at 400 x 400 and 128 x 128, and the detector image at 128 x 128
(``histogram.hist2d``: the CUDA kernel ``hist2d_kernel`` on the card).

    python tools/torch_bench_analyzer.py [--nrays=100000] [--repeats=96]
        [--f64]

runs on the CUDA card after a warm-up step per source, and prints the
summary line of the reference's benchmark: rays, time, rays/s and the
accumulated flux, with xrt's published CPU times (an i7-7700K: 436.1 s on
1 thread, 157.1 s on 4 processes) beside it as context only.
"""
import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the reference configuration: CrystalDiamond((4, 4, 4), d111 / 4), a
# diced Johansson toroid, R = 500 mm, theta = 60 deg, alpha = 0
D111 = 3.1354161
THETA_DEG = 60.0
R = 500.0
DX_CRYSTAL = DY_CRYSTAL = 100.0
BEAM_H = 0.2 / 2.35
BEAM_V = 0.07 / 2.35
E_AXIS_FLAT = 8.0e-4     # xrt's eAxesFlat[theta=60][Si444] (diced Joh.)
#: the three histograms of a step: (beam, x, y, bins, x limits, y limits)
HISTS = (('local', 'x', 'y', 400, (-52, 52), (-52, 52)),
         ('local', 'x', 'y', 128, (-1.6, 1.6), (-1.6, 1.6)),
         ('detector', 'x', 'z', 128, (-2.5, 2.5), (-1.5, 1.5)))
#: xrt's published times of the same workload, s (context, not a target)
XRT_I7_1THREAD, XRT_I7_4PROC = 436.1, 157.1


def build(nrays, dtype=None, device=None):
    """(sources, analyzer, detector, (eMin, eMax)) of speed test 1."""
    import torch
    from xrt_tpu_torch.materials import CrystalDiamond
    from xrt_tpu_torch.oes import DicedJohanssonToroid
    from xrt_tpu_torch.physconsts import CH
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    dtype = torch.float32 if dtype is None else dtype
    crystal = CrystalDiamond.create(hkl=(4, 4, 4), d=D111 / 4,
                                    elements='Si', rho=2.33, name='Si',
                                    dtype=dtype, device=device)
    theta = math.radians(THETA_DEG)
    sinTheta = math.sin(theta)
    d = float(crystal.d)
    dTheta = float(crystal.get_dtheta_symmetric_Bragg(
        CH / (2 * d * sinTheta)))
    E0 = CH / (2 * d * math.sin(theta + dTheta))
    p = q = 2.0 * R * sinTheta
    Rs = 2.0 * R * sinTheta ** 2
    sin2T, cos2T = math.sin(2 * theta), math.cos(2 * theta)
    pdp = 2.0 * R * math.sin(theta - DY_CRYSTAL / 6 / R)
    analyzer = DicedJohanssonToroid.create(
        dxFacet=2.1, dyFacet=1.4, dxGap=0.05, dyGap=0.05,
        Rm=R, Rs=Rs, material=crystal, center=(0, p, 0), pitch=theta,
        limPhysX=(-DX_CRYSTAL / 2, DX_CRYSTAL / 2),
        limPhysY=(-DY_CRYSTAL / 2, DY_CRYSTAL / 2))
    detector = Screen.create(center=(0, p + q * cos2T, q * sin2T),
                             x=(1, 0, 0), z=(0, -sin2T, cos2T))

    def source(distE, energies):
        return GeometricSource.create(
            nrays=nrays, dx=BEAM_H, dz=BEAM_V,
            distxprime='flat', dxprime=DX_CRYSTAL / pdp,
            distzprime='flat', dzprime=DY_CRYSTAL * sinTheta / pdp,
            distE=distE, energies=energies, polarization=None,
            dtype=dtype, device=device)

    eMin, eMax = E0 * (1 - E_AXIS_FLAT), E0 * (1 + E_AXIS_FLAT)
    dE7 = E0 * E_AXIS_FLAT / 4
    sources = [source('flat', (eMin, eMax)),
               source('lines', (E0,)),
               source('lines', tuple(E0 + (i - 3) * dE7 for i in range(7)))]
    return sources, analyzer, detector, (eMin, eMax)


def trace(analyzer, detector, beam, generator=None):
    """(crystal-local beam, detector beam) of one source beam."""
    glo, loc = analyzer.reflect(beam, generator)
    return loc, detector.expose(glo)


def histograms(loc, det):
    """The three histograms of a step, each weighted by the intensity of
    the rays that reached it (state 1)."""
    import torch
    from xrt_tpu_torch.histogram import hist2d
    beams = {'local': loc, 'detector': det}
    out = []
    for name, xf, yf, bins, xl, yl in HISTS:
        b = beams[name]
        w = torch.where(b.state == 1, b.Jss + b.Jpp, torch.zeros_like(b.Jss))
        out.append(hist2d(getattr(b, xf), getattr(b, yf), w, bins, bins, xl,
                          yl))
    return out


def run_source(src, analyzer, detector, repeats, generator):
    """*repeats* steps of one source; returns the three accumulated
    histograms."""
    acc = None
    for _ in range(repeats):
        hs = histograms(*trace(analyzer, detector, src.shine(generator),
                               generator))
        acc = hs if acc is None else [a + h for a, h in zip(acc, hs)]
    return acc


def run(nrays=100000, repeats=96, dtype=None, seed=0):
    """Speed test 1 on the card after a warm-up step per source: total
    time, time per source, rays/s, the accumulated flux and the histogram
    kernel's launches in the timed steps (its counts are set to 0 after
    the warm-up)."""
    import torch
    from xrt_tpu_torch import histogram
    sources, analyzer, detector, _ = build(nrays, dtype, 'cuda')
    gen = torch.Generator('cuda').manual_seed(seed)
    for src in sources:
        run_source(src, analyzer, detector, 1, gen)
    torch.cuda.synchronize()
    histogram.LAUNCHES.clear()
    t0 = time.perf_counter()
    per_source, flux = [], None
    for src in sources:
        ts = time.perf_counter()
        acc = run_source(src, analyzer, detector, repeats, gen)
        total = sum(torch.sum(h) for h in acc)
        flux = total if flux is None else flux + total
        torch.cuda.synchronize()
        per_source.append(time.perf_counter() - ts)
    flux = float(flux)
    dt = time.perf_counter() - t0
    n = 3 * repeats * nrays
    return dict(seconds=dt, per_source=per_source, rays=n,
                rays_per_s=n / dt, flux=flux,
                launches=dict(histogram.LAUNCHES))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--nrays', type=int, default=100000)
    ap.add_argument('--repeats', type=int, default=96)
    ap.add_argument('--f64', action='store_true')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('torch_bench_analyzer: no CUDA device', file=sys.stderr)
        return 1
    res = run(args.nrays, args.repeats,
              torch.float64 if args.f64 else torch.float32)
    dt = res['seconds']
    print(f'analyzer workload: {res["rays"]:.3g} rays '
          f'(3 sources x {args.repeats} x {args.nrays}), '
          f'{dt:.2f} s = {res["rays_per_s"] / 1e6:.2f} M rays/s; '
          f'accumulated flux {res["flux"]:.5g}')
    print('per source: ' + ', '.join(f'{t:.3f} s' for t in
                                     res['per_source']) +
          f'; histogram launches {res["launches"]}')
    print(f'xrt on an i7-7700K (identical workload, context only): '
          f'{XRT_I7_1THREAD} s (1 thread), {XRT_I7_4PROC} s (4 processes) '
          f'-> {XRT_I7_1THREAD / dt:.1f}x / {XRT_I7_4PROC / dt:.1f}x')
    return 0


if __name__ == '__main__':
    sys.exit(main())
