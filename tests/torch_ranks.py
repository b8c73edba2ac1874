"""The rank program of ``tests/test_torch_parallel.py``: a gloo world of
four CPU processes (``torch.multiprocessing``, a file store), and in it
the worlds of 2 and 3 as subgroups.

    python tests/torch_ranks.py INPUTS.npz OUTDIR

Each rank writes ``OUTDIR/rank<r>.npz`` with what it computed; the test
compares.  *INPUTS.npz* holds the JAX package's receiver samples of the
Gaussian -> slit -> toroid -> screen chain in float64 and float32
(``f64_w0x``, ``f64_w0z``, ``f64_w1x``, ... ``f32_w1z``) and the chain's
kernel modes, written by ``tests/jax_parallel_ref.py``.  Nothing here
imports the JAX package: every number is the port's.
"""
import math
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
NS, ND = 700, 333          # deliberately not multiples of the world sizes

E0 = 500.0
P, Q, PITCH = 5000.0, 1000.0, 6e-3
XS = np.asarray([0.0])
ZS = np.linspace(-0.02, 0.02, 41)


def kirchhoff_inputs():
    """The inputs of ``tests/test_parallel_kirchhoff.py``, float64."""
    rng = np.random.default_rng(0)
    T = torch.as_tensor
    xs = T(rng.uniform(-1, 1, NS))
    ys = T(rng.uniform(-1, 1, NS))
    zs = T(rng.uniform(-0.01, 0.01, NS))
    xd = T(rng.uniform(-0.5, 0.5, ND))
    yd = T(rng.uniform(-0.5, 0.5, ND)) + 100.0
    zd = T(rng.uniform(-0.5, 0.5, ND))
    Es = T(rng.normal(size=NS) + 1j * rng.normal(size=NS))
    Ep = T(rng.normal(size=NS) + 1j * rng.normal(size=NS))
    k = torch.full((NS,), 2 * np.pi / 1.5e-7, dtype=torch.float64)
    n = [torch.zeros(()), torch.zeros(()), torch.ones(())]
    nl = T(rng.uniform(0.7, 1.0, NS))
    w = T((rng.uniform(size=NS) > 0.1).astype(float))
    return xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, w


def chain_elements(dtype):
    from xrt_tpu_torch.apertures import RectangularAperture
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import ToroidMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GaussianBeam
    mat = Material.create('Au', rho=19.3, kind='mirror', dtype=dtype,
                          device='cpu')
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


def chain(dtype, **kw):
    """The port's own WaveChain (nrays 601), absolute intensity."""
    from xrt_tpu_torch.wavechain import WaveChain
    src, slit, tor, scr = chain_elements(dtype)
    run = (WaveChain(src, nrays=601, fixedEnergy=E0)
           .through_aperture(slit).through_oe(tor)
           .to_screen(scr, XS, ZS)).build(torch.Generator().manual_seed(5),
                                          dtype=dtype, device='cpu', **kw)
    wave, logs = run()
    return WaveChain.absolute_intensity(wave, logs)


def tag(dtype):
    return 'f64' if dtype == torch.float64 else 'f32'


def receivers(inp, dtype):
    """The receiving waves of the JAX package's samples."""
    from xrt_tpu_torch import waves as tw
    src, slit, tor, scr = chain_elements(dtype)
    t = tag(dtype)
    a = tw.prepare_wave_on_aperture(
        slit, src, 0, samples=(inp[f'{t}_w0x'], inp[f'{t}_w0z']),
        dtype=dtype, device='cpu')
    b = tw.prepare_wave_on_oe(
        tor, slit, 0,
        samples=(inp[f'{t}_w1x'], inp[f'{t}_w1y'], inp[f'{t}_w1z']),
        dtype=dtype, device='cpu')
    c = tw.prepare_wave_on_screen(scr, tor, XS, ZS, dtype=dtype,
                                  device='cpu')
    return (src, slit, tor, scr), (a, b, c)


def hops(inp, dtype, mesh=None, ring=False):
    """The chain hop by hop on the JAX package's samples."""
    from xrt_tpu_torch import waves as tw
    from xrt_tpu_torch.wavechain import WaveChain
    (src, _, tor, _), (a, b, c) = receivers(inp, dtype)
    modes = [tuple(str(v) for v in inp[f'{tag(dtype)}_mode{i}'])
             for i in (1, 2)]
    f32 = dtype == torch.float32
    logs = torch.zeros((), dtype=dtype)
    cur = src.shine(torch.Generator().manual_seed(0), a)
    if f32:
        cur, ls = tw.rescale_field(cur)
        logs = logs + ls
    hop = tw.diffract(cur, b, phase_mode=modes[0][0], monochromatic=True,
                      accumulate=modes[0][1], narrowband=False, mesh=mesh,
                      ring=ring)
    _, cur = tw.reflect_wave(tor, hop)
    if f32:
        cur, ls = tw.rescale_field(cur)
        logs = logs + ls
    out = tw.diffract(cur, c, phase_mode=modes[1][0], monochromatic=True,
                      accumulate=modes[1][1], narrowband=False, mesh=mesh,
                      ring=ring)
    return WaveChain.absolute_intensity(out, logs)


def wave_grad(inp, dtype, mesh=None, ring=False):
    """d sum(Jss + Jpp) / d w0 of the source field diffracted onto the
    toroid's samples (the reference's multi-device gradient check)."""
    from xrt_tpu_torch import waves as tw
    (src, _, _, _), (a, b, _) = receivers(inp, dtype)
    w0 = torch.tensor(0.05, dtype=dtype, requires_grad=True)
    srcw = src.replace(w0=w0).shine(torch.Generator().manual_seed(3), a,
                                    toGlobal=False)
    out = tw.diffract(srcw, b, mesh=mesh, ring=ring)
    loss = torch.sum(out.Jss + out.Jpp)
    loss.backward()
    return float(loss.detach()), float(w0.grad)


TRACE_NRAYS = 4000


def trace_line():
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import ToroidMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    p, q, pitch = 10000.0, 2000.0, 4e-3
    src = GeometricSource.create(nrays=TRACE_NRAYS, dx=0.1, dz=0.05,
                                 dxprime=3e-5, dzprime=3e-5,
                                 energies=(9000.0,), distE='lines',
                                 dtype=torch.float64, device='cpu')
    R = 2 * p * q / (p + q) / math.sin(pitch)
    r = 2 * p * q / (p + q) * math.sin(pitch)
    mat = Material.create('Rh', rho=12.41, dtype=torch.float64,
                          device='cpu')
    mirror = ToroidMirror.create(center=(0, p, 0), pitch=pitch, R=R, r=r,
                                 material=mat, limPhysX=(-20, 20),
                                 limPhysY=(-300, 300))
    screen = Screen.create(center=(0, p + q, 2 * pitch * q))

    def run_process(bl, g, pitch_=None):
        m = mirror if pitch_ is None else mirror.replace(pitch=pitch_)
        glo, _ = m.reflect(src.shine(g), generator=g)
        return {'screen': screen.expose(glo)}
    return run_process


def trace_plot():
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    return XYCPlot(beam='screen',
                   xaxis=XYCAxis('x', 'mm', limits=(-1, 1)),
                   yaxis=XYCAxis('z', 'mm', limits=(-1, 1)),
                   caxis=XYCAxis('energy', 'eV', limits=(8990, 9010)))


PLOT_TOTALS = ('total1D_x', 'total1D_y', 'total1D_c', 'total2D',
               'total2D_RGB', 'total1D_x_RGB')


def plot_totals(plot, prefix):
    out = {f'{prefix}_{k}': np.asarray(getattr(plot, k)) for k in
           PLOT_TOTALS}
    out[f'{prefix}_intensity'] = np.asarray(plot.intensity)
    out[f'{prefix}_nRaysAll'] = np.asarray(plot.nRaysAll)
    out[f'{prefix}_nRaysGood'] = np.asarray(plot.nRaysGood)
    return out


def hist_loss(beams, mesh):
    """A central flux of the screen image and the image, reduced."""
    from xrt_tpu_torch.histogram import hist2d
    img = beams['screen']
    w = torch.where(img.state == 1, img.Jss + img.Jpp,
                    torch.zeros_like(img.Jss))
    h = hist2d(img.x, img.z, w, 32, 32, (-1.0, 1.0), (-1.0, 1.0))
    loss = torch.sum(h[12:20, 12:20])
    return (loss, h) if mesh is None else mesh.all_reduce(loss, h)


def worker(rank, inputs, outdir, initf):
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    dist.init_process_group('gloo', init_method='file://' + initf,
                            rank=rank, world_size=WORLD)
    from xrt_tpu_torch import parallel as par
    from xrt_tpu_torch.runner import (_accumulate, histogram_plot,
                                      run_ray_tracing)
    from xrt_tpu_torch.waves import kirchhoff_integral_xla
    inp = dict(np.load(inputs))
    out = {}
    # the worlds of 2 and 3 are subgroups of the world of 4; every rank
    # makes every group (a collective), members compute
    groups = {2: dist.new_group([0, 1]), 3: dist.new_group([0, 1, 2]),
              4: dist.group.WORLD}
    args = kirchhoff_inputs()
    xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, w = args
    ref = kirchhoff_integral_xla(*args)
    out['kirchhoff_single'] = np.stack([o.numpy() for o in ref])
    nb = [torch.broadcast_to(ni, (NS,)) for ni in n]
    flat = par._kirchhoff_xla_flat
    for W, group in groups.items():
        if rank >= W:
            continue
        mesh = par.make_mesh(group, device='cpu')
        res = {
            'sharded': par.kirchhoff_sharded(mesh, *args),
            'ring': par.kirchhoff_ring(mesh, *args),
            'call': par.dst_sharded_call(
                mesh, flat, [xd, yd, zd],
                [xs, ys, zs, Es, Ep, k, *nb, nl, w]),
            'call_ring': par.dst_sharded_call(
                mesh, flat, [xd, yd, zd],
                [xs, ys, zs, Es, Ep, k, *nb, nl, w], ring=True,
                src_pad=par.XLA_SRC_PAD)}
        for name, o in res.items():
            out[f'kirchhoff_{name}_w{W}'] = np.stack([v.numpy() for v in o])
        out[f'bytes_w{W}'] = np.asarray(mesh.bytes_moved)
        # the gradient of the ring's output in the fields and positions
        Es1 = Es.clone().requires_grad_(True)
        xd1 = xd.clone().requires_grad_(True)
        o = par.kirchhoff_ring(mesh, xd1, yd, zd, xs, ys, zs, Es1, Ep, k, n,
                               nl, w)
        sum((v.abs() ** 2).sum() for v in o[:2]).backward()
        out[f'ring_grad_Es_w{W}'] = Es1.grad.numpy()
        out[f'ring_grad_xd_w{W}'] = xd1.grad.numpy()
    Es1 = Es.clone().requires_grad_(True)
    xd1 = xd.clone().requires_grad_(True)
    o = kirchhoff_integral_xla(xd1, yd, zd, xs, ys, zs, Es1, Ep, k, n, nl, w)
    sum((v.abs() ** 2).sum() for v in o[:2]).backward()
    out['single_grad_Es'] = Es1.grad.numpy()
    out['single_grad_xd'] = xd1.grad.numpy()

    mesh = par.make_mesh(device='cpu')
    # the wave chain: the port's own chain, and hop by hop on the JAX
    # package's samples
    for dt in (torch.float64, torch.float32):
        t = tag(dt)
        out[f'chain_{t}_single'] = chain(dt)
        out[f'chain_{t}_mesh'] = chain(dt, mesh=mesh)
        out[f'chain_{t}_ring'] = chain(dt, mesh=mesh, ring=True)
        out[f'hops_{t}_single'] = hops(inp, dt)
        out[f'hops_{t}_mesh'] = hops(inp, dt, mesh)
        out[f'hops_{t}_ring'] = hops(inp, dt, mesh, ring=True)
        out[f'grad_{t}_single'] = np.asarray(wave_grad(inp, dt))
        out[f'grad_{t}_mesh'] = np.asarray(wave_grad(inp, dt, mesh))
        out[f'grad_{t}_ring'] = np.asarray(wave_grad(inp, dt, mesh,
                                                     ring=True))

    # run_ray_tracing over the world of 4 against one rank, and against
    # the ordered sum of four unsharded passes with the same generators
    run_process = trace_line()
    p4 = trace_plot()
    run_ray_tracing([p4], repeats=2, run_process=run_process, rng=0,
                    device='cpu', mesh=mesh)
    out.update(plot_totals(p4, 'mesh'))
    if rank == 0:
        p1 = trace_plot()
        run_ray_tracing([p1], repeats=2, run_process=run_process, rng=0,
                        device='cpu')
        out.update(plot_totals(p1, 'single'))
        pr = trace_plot()
        rng = torch.Generator().manual_seed(0)
        for _ in range(2):
            gens = par.split_generator(rng, WORLD)
            hs = [histogram_plot(pr, run_process(None, g)) for g in gens]
            total = hs[0]
            for h in hs[1:]:
                total = _sum_hists(total, h)
            _accumulate(pr, total)
        out.update(plot_totals(pr, 'ordered'))

    # the data-parallel pitch gradient (sharded_trace)
    pitch = torch.tensor(4e-3, requires_grad=True)

    def rp(bl, g):
        return run_process(bl, g, mesh.replicate(pitch))
    loss, h = par.sharded_trace(rp, None, mesh,
                                torch.Generator().manual_seed(1), hist_loss)
    loss.backward()
    out['dp_loss'] = np.asarray(float(loss.detach()))
    out['dp_hist'] = h.detach().numpy()
    out['dp_grad'] = np.asarray(float(pitch.grad))
    if rank == 0:
        gens = par.split_generator(torch.Generator().manual_seed(1), WORLD)
        losses, grads, hists = [], [], []
        for g in gens:
            p_ = torch.tensor(4e-3, requires_grad=True)
            lo, hh = hist_loss(run_process(None, g, p_), None)
            lo.backward()
            losses.append(lo.detach())
            grads.append(p_.grad)
            hists.append(hh.detach())
        out['dp_ref_loss'] = np.asarray(float(_ordered(losses)))
        out['dp_ref_hist'] = _ordered(hists).numpy()
        out['dp_ref_grad'] = np.asarray(float(_ordered(grads)))
    np.savez(os.path.join(outdir, f'rank{rank}.npz'), **out)
    dist.barrier()
    dist.destroy_process_group()


def _ordered(ts):
    acc = ts[0]
    for t in ts[1:]:
        acc = acc + t
    return acc


def _sum_hists(a, b):
    if isinstance(a, dict):
        return {k: _sum_hists(a[k], b[k]) for k in a}
    return a + b


def main(inputs, outdir):
    os.environ['OMP_NUM_THREADS'] = '1'
    sys.path.insert(0, ROOT)
    initf = os.path.join(outdir, 'init')
    mp.start_processes(worker, args=(inputs, outdir, initf), nprocs=WORLD,
                       start_method='spawn')


if __name__ == '__main__':
    main(*sys.argv[1:3])
