"""Command-line entry: trace a beamline saved as JSON, and the x-ray
calculator.

    python -m xrt_tpu_torch trace beamline.json [--repeats R] [--seed S]
                                                [--save out.png]
    python -m xrt_tpu_torch trace beamline.json --multihost \\
        --coordinator host:port --num-processes N --process-id I
    python -m xrt_tpu_torch info beamline.json
    python -m xrt_tpu_torch serve beamline.json [--port P]
    python -m xrt_tpu_torch calc rocking --material Si --hkl 111 --R 2000
    python -m xrt_tpu_torch qook project.xml
    python -m xrt_tpu_torch codegen beamline.json -o script.py

Port of the reference package's command line, with every subcommand and
argument of it.  The JSON layout is the one written by
:meth:`xrt_tpu_torch.beamline.BeamLine.export_to_json` (or by the
reference package: either reads the other's).  Everything runs on the card
unless ``--device cpu`` is given; without CUDA and without it, a command
that traces exits with an error.  ``trace --multihost`` starts one process
per card (by hand with ``--coordinator``, ``--num-processes`` and
``--process-id``, or under ``torchrun``), each tracing its own rays; the
histograms are summed over the ranks (:mod:`xrt_tpu_torch.parallel`).
``glow`` writes the 3D view, ``bob`` the Phoebus screens, and ``serve
--ui`` serves the browser page (:mod:`xrt_tpu_torch.webui`): with a layout
it records the flow and replays it on each edit, without one it starts an
empty beamline in assembly mode.

    python -m xrt_tpu_torch glow beamline.json [--save glow.html]
    python -m xrt_tpu_torch bob beamline.json [--out bob]
    python -m xrt_tpu_torch serve [beamline.json] --ui [--port P]
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python -m xrt_tpu_torch')
    device_help = ('the device to run on: the card (cuda) by default; cpu '
                   'runs the plain PyTorch versions')
    ap.add_argument('--device', default=None, help=device_help)
    # --device after the subcommand too (SUPPRESS keeps the parent's value
    # when it is not given there)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument('--device', default=argparse.SUPPRESS,
                        help=device_help)
    sub = ap.add_subparsers(dest='cmd', required=True)
    # x-ray calculator (the reference's 00_xRayCalculator capability):
    # material/crystal curves straight from the material classes, as CSV
    calc = sub.add_parser(
        'calc', parents=[common],
        help='x-ray calculator: reflectivity / transmission / refraction '
             'index / crystal rocking curve')
    calc.add_argument('what', choices=('reflectivity', 'transmission',
                                       'index', 'rocking'))
    calc.add_argument('--material', default='Si',
                      help='element or compound formula (e.g. Rh, SiO2)')
    calc.add_argument('--rho', type=float, default=0.0,
                      help='density g/cm3 (default: table value if known)')
    calc.add_argument('--t', type=float, default=None,
                      help='thickness mm (transmission)')
    calc.add_argument('--hkl', default='111', help='crystal hkl (rocking)')
    calc.add_argument('--E', default='9000',
                      help="energy eV: single value or 'min:max:n'")
    calc.add_argument('--theta', default='1:10:128',
                      help="grazing angle mrad: value or 'min:max:n' "
                           '(reflectivity)')
    calc.add_argument('--dtheta', default='-50:150:200',
                      help="rocking offset urad: 'min:max:n'")
    # bent-crystal (Takagi-Taupin) options: the capability of the
    # reference's xrtBentXtal GUI calculator (gui/xrtBentXtal.py:3-27)
    calc.add_argument('--R', type=float, default=None,
                      help='meridional bending radius mm (rocking): '
                           'switches to the Takagi-Taupin solver')
    calc.add_argument('--Rs', type=float, default=None,
                      help='sagittal bending radius mm (rocking)')
    calc.add_argument('--tc', type=float, default=None,
                      help='crystal thickness mm (rocking)')
    calc.add_argument('--asym', type=float, default=0.0,
                      help='asymmetry angle deg (rocking)')
    calc.add_argument('--geom', default='Bragg reflected',
                      choices=('Bragg reflected', 'Bragg transmitted',
                               'Laue reflected', 'Laue transmitted'))
    calc.add_argument('--nu', type=float, default=None,
                      help='isotropic Poisson ratio (default: anisotropic '
                           'elastic constants by crystal name)')
    calc.add_argument('--scan', default=None,
                      help="sweep a bending parameter over values and "
                           "overlay the rocking curves: 'R=inf,2000,500' "
                           "or 'R=500:4000:4' or 'Rs=...' or 'tc=...' "
                           "(the reference xrtBentXtal app's core use)")
    calc.add_argument('--save', default=None,
                      help='save the (overlaid) rocking curves to this '
                           'PNG instead of printing CSV only')

    # run a reference xrtQook project file directly
    qk = sub.add_parser(
        'qook', parents=[common],
        help='load & run a reference xrtQook project XML (materials, '
             'elements, plots and the run card)')
    qk.add_argument('project', help='Qook project .xml')
    qk.add_argument('--nrays', type=int, default=None)
    qk.add_argument('--repeats', type=int, default=None)
    qk.add_argument('--save', default=None,
                    help='save the (first) plot to this file')

    for c in ('trace', 'info', 'serve', 'bob', 'codegen', 'glow'):
        s = sub.add_parser(c, parents=[common])
        if c == 'serve':
            s.add_argument('beamline', nargs='?', default=None,
                           help='beamline JSON file (omit with --ui to '
                                'assemble a beamline from an empty page '
                                'in the browser)')
        else:
            s.add_argument('beamline', help='beamline JSON file')
        if c == 'codegen':
            s.add_argument('-o', '--out', default=None,
                           help='output script file (default: stdout); '
                                "the analog of xrtQook's script generation")
            s.add_argument('--repeats', type=int, default=3)
        if c == 'glow':
            s.add_argument('--save', default='glow.html',
                           help='standalone 3D HTML view (or .png)')
            s.add_argument('--max-rays', type=int, default=200)
        if c == 'bob':
            s.add_argument('--out', default='bob',
                           help='output directory for Phoebus screens')
            s.add_argument('--prefix', default='$(P)')
        if c == 'trace':
            s.add_argument('--repeats', type=int, default=1)
            s.add_argument('--save', default=None,
                           help='save the detector image to this file')
            s.add_argument('--seed', type=int, default=0)
            s.add_argument('--multihost', action='store_true',
                           help='start a torch.distributed process group '
                                'and split the rays of every pass over all '
                                'its ranks (one process per card; the '
                                "analog of the reference's multi-GPU/ZMQ "
                                'scaling)')
            s.add_argument('--coordinator', default=None,
                           help='rank 0\'s address host:port (default: '
                                "torchrun's environment)")
            s.add_argument('--num-processes', type=int, default=None)
            s.add_argument('--process-id', type=int, default=None)
        if c == 'serve':
            s.add_argument('--port', type=int, default=0)
            s.add_argument('--host', default='127.0.0.1')
            s.add_argument('--ui', action='store_true',
                           help='serve the browser control page (element '
                                'tree + live 3D view + detector '
                                'histogram; the Qook/Glow capability '
                                'analog) instead of the JSON-lines TCP '
                                'protocol')
    args = ap.parse_args(argv)
    if getattr(args, 'cmd', None) == 'serve' and not args.ui and \
            args.beamline is None:
        ap.error('serve: a beamline JSON file is required without --ui')

    if args.cmd == 'codegen':
        from .codegen import generate_script
        text = generate_script(args.beamline, repeats=args.repeats)
        if args.out:
            with open(args.out, 'w') as f:
                f.write(text)
            print(f'wrote {args.out}')
        else:
            print(text)
        return 0

    from . import config
    if getattr(args, 'multihost', False):
        return _trace_multihost(args)
    try:
        dev = config.resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    if args.cmd == 'calc':
        return _calc(args, dev)

    if args.cmd == 'qook':
        return _qook(args, dev)

    from .beamline import BeamLine
    bl = BeamLine.load_from_json(args.beamline, device=dev) \
        if args.beamline is not None else None

    if args.cmd == 'info':
        for name, kind, method, _ in bl.flow:
            el = bl[name]
            print(f'{name:>16}  {type(el).__name__:<24} .{method}()')
        return 0

    if args.cmd == 'glow':
        fn = bl.glow(save=args.save, maxRays=args.max_rays)
        print(f'wrote {fn if fn else args.save}')
        return 0

    if args.cmd == 'bob':
        from .epics import generate_bob_screens
        files = generate_bob_screens(bl, args.out, args.prefix)
        for fn in files:
            print(f'wrote {fn}')
        return 0

    if args.cmd == 'serve' and args.ui:
        import torch
        from .webui import WebUI
        if bl is None:
            # assembly from scratch: an empty beamline, traced with the
            # default flow as elements are added
            bl = BeamLine(name='new beamline')
            srv = WebUI(bl, host=args.host, port=args.port,
                        device=dev).start()
        else:
            # a loaded beamline: record its flow so parameter edits replay
            # only the dirty part; the first structural edit (add, remove,
            # reorder) switches the session to assembly mode
            from .flow import record_flow
            with record_flow(bl) as flow:
                bl.propagate_flow(torch.Generator(dev).manual_seed(0))
            srv = WebUI(bl, flow, host=args.host, port=args.port,
                        device=dev).start()
        print(f'beamline UI on http://{srv.host}:{srv.port}/ (element '
              'tree + assembly + 3D view + live histogram)', flush=True)
        try:
            srv._thread.join()
        except KeyboardInterrupt:
            srv.stop()
        return 0

    if args.cmd == 'serve':
        from .server import BeamLineServer
        srv = BeamLineServer(
            bl, trace_fn=lambda elements: _trace_summary(bl, dev),
            host=args.host, port=args.port, device=dev).start()
        print(f'serving beamline on {srv.host}:{srv.port} '
              '(JSON lines: list/get/set/acquire/shutdown)', flush=True)
        try:
            srv._thread.join()
        except KeyboardInterrupt:
            srv.stop()
        return 0

    # trace
    import torch
    rng = torch.Generator(dev).manual_seed(args.seed)
    beams = None
    for _ in range(args.repeats):
        beams = bl.propagate_flow(rng)
    last = list(beams)[-1]
    img = beams[last]
    good = (img.state == 1).cpu().numpy()
    I = (img.Jss + img.Jpp).detach().double().cpu().numpy()
    x = img.x.detach().double().cpu().numpy()
    z = img.z.detach().double().cpu().numpy()
    print(f"traced; final beam '{last}': {good.sum()} good rays, "
          f'flux={I[good].sum():.5g}')
    if good.any():
        print(f'  x: {x[good].mean():.4g} +- {x[good].std():.4g} mm')
        print(f'  z: {z[good].mean():.4g} +- {z[good].std():.4g} mm')
    if args.save:
        from .plotspec import XYCAxis, XYCPlot
        from .plotting import save_plot
        from .runner import _accumulate, calibrate_limits, histogram_plot
        plot = XYCPlot(beam=last, xaxis=XYCAxis('x', 'mm'),
                       yaxis=XYCAxis('z', 'mm'),
                       caxis=XYCAxis('energy', 'eV'))
        calibrate_limits([plot], beams)
        _accumulate(plot, histogram_plot(plot, beams))
        save_plot(plot, args.save)
        print(f'saved {args.save}')
    return 0


def _qook(args, dev):
    from .plotting import save_plot
    from .qook import load_qook_project
    from .runner import run_ray_tracing
    prj = load_qook_project(args.project, nrays=args.nrays, device=dev)
    for tag, skip in prj.skipped.items():
        print(f'note: {tag}: ignored reference-only parameters '
              f'{sorted(skip)}')
    run_kwargs = dict(prj.run_kwargs)
    run_kwargs.pop('updateEvery', None)
    if args.repeats is not None:
        run_kwargs['repeats'] = args.repeats
    plots = prj.plots
    if not plots:
        from .plotspec import XYCAxis, XYCPlot
        last = prj.beamline.flow[-1][0]
        plots = [XYCPlot(beam=last, xaxis=XYCAxis('x', 'mm'),
                         yaxis=XYCAxis('z', 'mm'),
                         caxis=XYCAxis('energy', 'eV'))]
    run_ray_tracing(plots, beamLine=prj.beamline,
                    run_process=lambda bl_, g: bl_.propagate_flow(g),
                    device=dev, **run_kwargs)
    for pl in plots:
        print(f"plot '{pl.beam}': flux={pl.intensity:.5g} "
              f'nGood={pl.nRaysGood} dx={pl.dx:.4g} dy={pl.dy:.4g}')
    if args.save:
        save_plot(plots[0], args.save)
        print(f'saved {args.save}')
    return 0


def _trace_multihost(args):
    """``trace --multihost``: one process per card, the rays of every pass
    split over the ranks of the process group (NCCL on the cards, gloo
    with ``--device cpu``)."""
    import torch
    import torch.distributed as dist
    from .beamline import BeamLine
    from .parallel import make_mesh, sharded_step
    from .plotspec import XYCAxis, XYCPlot
    from .runner import _accumulate, calibrate_limits
    on_cpu = args.device is not None and \
        torch.device(args.device).type == 'cpu'
    backend = 'gloo' if on_cpu else 'nccl'
    if args.coordinator:
        dist.init_process_group(
            backend, init_method=f'tcp://{args.coordinator}',
            world_size=args.num_processes, rank=args.process_id)
    else:       # torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR)
        dist.init_process_group(backend)
    try:
        mesh = make_mesh(device=args.device if on_cpu or args.device not in
                         (None, 'cuda') else None)
        bl = BeamLine.load_from_json(args.beamline, device=mesh.device)
        print(f'multihost: process {dist.get_rank()} of '
              f'{dist.get_world_size()}, {mesh}', flush=True)
        rng = torch.Generator(mesh.device).manual_seed(args.seed)
        beams0 = bl.propagate_flow(rng)
        last = list(beams0)[-1]
        plot = XYCPlot(beam=last, xaxis=XYCAxis('x', 'mm'),
                       yaxis=XYCAxis('z', 'mm'),
                       caxis=XYCAxis('energy', 'eV'))
        calibrate_limits([plot], beams0)

        def run_process(bl_, g):
            return bl_.propagate_flow(g)

        for _ in range(args.repeats):
            hists = sharded_step(run_process, bl, [plot], mesh, rng)
            _accumulate(plot, hists[0])
        print(f"'{last}': flux={plot.intensity:.6g} over {mesh.size} "
              f'ranks x {args.repeats} repeats, nGood={plot.nRaysGood}',
              flush=True)
        if args.save and mesh.rank == 0:
            from .plotting import save_plot
            save_plot(plot, args.save)
            print(f'saved {args.save}')
    finally:
        dist.destroy_process_group()
    return 0


def _parse_range(spec, scale=1.0):
    import numpy as np
    if ':' in spec:
        lo, hi, n = spec.split(':')
        return np.linspace(float(lo), float(hi), int(n)) * scale
    return np.asarray([float(spec)]) * scale


def _calc(args, dev):
    """Material-property calculator (the capability of the reference's
    examples/withRaycing/00_xRayCalculator scripts), CSV to stdout; the
    curves are computed in float64 on *dev*."""
    import math
    import re as _re

    import numpy as np
    import torch

    from . import materials as xm
    F64 = dict(dtype=torch.float64, device=dev)

    def T(v):
        return torch.as_tensor(np.asarray(v, float), **F64)

    def H(v):
        return v.detach().cpu().numpy()

    formula = args.material
    parts = _re.findall(r'([A-Z][a-z]?)(\d*)', formula)
    parts = [(el, int(q) if q else 1) for el, q in parts if el]
    if len(parts) == 1 and parts[0][1] == 1:
        elements, quantities = parts[0][0], None
    else:
        elements = tuple(el for el, _ in parts)
        quantities = tuple(q for _, q in parts)

    E = _parse_range(args.E)
    if args.what == 'rocking':
        hkl = tuple(int(c) for c in args.hkl)
        kw = dict(hkl=hkl, geom=args.geom, **F64)
        if args.tc is not None:
            kw['t'] = args.tc
        if args.nu is not None:
            kw['nu'] = args.nu
        cr = xm.CrystalSi.create(**kw) if args.material == 'Si' else \
            xm.CrystalFromCell.create(name=args.material, **kw)
        E0 = float(E[0])
        thetaB = float(cr.get_Bragg_angle(E0))
        dth = _parse_range(args.dtheta, 1e-6)
        th = thetaB + dth
        alpha = math.radians(args.asym)
        bent = args.R is not None or args.Rs is not None

        if args.scan:
            # xrtBentXtal-style parameter sweep: overlaid rocking curves
            # for a list/range of bending radii or thicknesses
            # (gui/xrtBentXtal.py:3-27)
            pname, spec = (s.strip() for s in args.scan.split('='))
            if pname not in ('R', 'Rs', 'tc'):
                raise SystemExit(f'--scan parameter must be R, Rs or tc '
                                 f'(got {pname!r})')
            if ':' in spec:
                lo, hi, n = spec.split(':')
                vals = list(np.linspace(float(lo), float(hi), int(n)))
            else:
                vals = [float('inf') if v.strip() in ('inf', 'flat')
                        else float(v) for v in spec.split(',')]
        else:
            pname, vals = None, [None]

        curves = []
        tht = T(th)
        for v in vals:
            Ry_v, Rx_v, cr_v = args.R, args.Rs, cr
            if pname == 'R':
                Ry_v = v
            elif pname == 'Rs':
                Rx_v = v
            elif pname == 'tc':
                cr_v = cr.replace(t=float(v))
            bent_v = (Ry_v is not None and np.isfinite(Ry_v)) or \
                     (Rx_v is not None and np.isfinite(Rx_v))
            g0 = -torch.sin(tht + alpha)
            gh = torch.sin(tht - alpha) if not cr_v.geom.startswith('L') \
                else -torch.sin(tht - alpha)
            hns0 = -torch.sin(tht)
            E_ = torch.full(tht.shape, E0, **F64)
            if bent_v:
                rs_, rp_ = cr_v.get_amplitude_TT(
                    E_, g0, gh, hns0, alphaAsym=alpha,
                    Ry=Ry_v if Ry_v is not None else float('inf'),
                    Rx=Rx_v if Rx_v is not None else float('inf'))[0:2]
            else:
                rs_, rp_ = cr_v.get_amplitude(E_, g0, gh, hns0)[0:2]
            Rs_c, Rp_c = H(torch.abs(rs_) ** 2), H(torch.abs(rp_) ** 2)
            label = '' if v is None else (
                f'{pname}=flat' if not np.isfinite(v)
                else f'{pname}={v:g} mm')
            curves.append((label, v, Rs_c, Rp_c))

        step = (dth[1] - dth[0]) * 1e6 if len(dth) > 1 else 1.0
        for label, v, Rs_c, Rp_c in curves:
            bent_tag = label or (f'TT bent Ry={args.R} Rs={args.Rs} mm'
                                 if bent else 'flat (2-beam)')
            fwhm = float((Rs_c > Rs_c.max() / 2).sum() * step)
            integ = float(Rs_c.sum() * step)
            print('# dtheta(urad), |rs|^2, |rp|^2   '
                  f'[{args.material}{args.hkl} {args.geom} at E={E0} eV, '
                  f'thetaB={math.degrees(thetaB):.4f} deg, {bent_tag}; '
                  f's: FWHM={fwhm:.3g} urad, integrated={integ:.4g} urad]')
            for a, b, c in zip(dth * 1e6, Rs_c, Rp_c):
                print(f'{a:.6g}, {b:.6g}, {c:.6g}')
        if args.save:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(7, 5))
            for i, (label, v, Rs_c, Rp_c) in enumerate(curves):
                col = f'C{i}'
                fwhm = float((Rs_c > Rs_c.max() / 2).sum() * step)
                ax.plot(dth * 1e6, Rs_c, col, label=(label or 'curve') +
                        f' s (FWHM {fwhm:.3g} urad)')
                ax.plot(dth * 1e6, Rp_c, col + '--', alpha=0.6,
                        label=(label or 'curve') + ' p')
            ax.set_xlabel(r'$\theta-\theta_B$ ($\mu$rad)')
            ax.set_ylabel('reflectivity')
            ax.set_title(f'{args.material}{args.hkl} {args.geom} '
                         f'E={E0:g} eV'
                         + (f', scan {pname}' if pname else ''))
            ax.legend(fontsize=8)
            fig.tight_layout()
            fig.savefig(args.save, dpi=120)
            plt.close(fig)
            print(f'# saved {args.save}')
        return 0

    Ej = T(E)
    mat = xm.Material.create(elements, quantities=quantities, rho=args.rho,
                             kind='mirror' if args.what == 'reflectivity'
                             else 'plate', **F64)
    if args.what == 'index':
        n = H(mat.get_refractive_index(Ej))
        mu = H(mat.get_absorption_coefficient(Ej))
        print('# E(eV), delta, beta, mu(1/cm)')
        for e, nv, m in zip(E, n, mu):
            print(f'{e:.6g}, {1 - nv.real:.6g}, {-nv.imag:.6g}, {m:.6g}')
        return 0
    if args.what == 'transmission':
        t = args.t if args.t is not None else 0.1
        mu = H(mat.get_absorption_coefficient(Ej))
        Tr = np.exp(-mu * t * 0.1)
        print(f'# E(eV), transmission through {t} mm {formula}')
        for e, tv in zip(E, Tr):
            print(f'{e:.6g}, {tv:.6g}')
        return 0
    # reflectivity vs grazing angle at fixed E (or vs E at fixed angle)
    th = _parse_range(args.theta, 1e-3)
    if len(E) > 1 and len(th) == 1:
        rs, rp = mat.get_amplitude(
            Ej, torch.full(Ej.shape, math.sin(float(th[0])), **F64))[0:2]
        print(f'# E(eV), |rs|^2, |rp|^2  [theta={th[0]*1e3} mrad]')
        for e, a, b in zip(E, H(torch.abs(rs) ** 2),
                           H(torch.abs(rp) ** 2)):
            print(f'{e:.6g}, {a:.6g}, {b:.6g}')
    else:
        E0 = float(E[0])
        rs, rp = mat.get_amplitude(torch.full(th.shape, E0, **F64),
                                   torch.sin(T(th)))[0:2]
        print(f'# theta(mrad), |rs|^2, |rp|^2  [E={E0} eV]')
        for a, b, c in zip(th * 1e3, H(torch.abs(rs) ** 2),
                           H(torch.abs(rp) ** 2)):
            print(f'{a:.6g}, {b:.6g}, {c:.6g}')
    return 0


def _trace_summary(bl, dev):
    import torch
    beams = bl.propagate_flow(torch.Generator(dev).manual_seed(0))
    last = list(beams)[-1]
    img = beams[last]
    good = (img.state == 1).cpu().numpy()
    I = (img.Jss + img.Jpp).detach().double().cpu().numpy()
    return {'beam': last, 'ngood': int(good.sum()),
            'flux': float(I[good].sum())}


if __name__ == '__main__':
    sys.exit(main())
