"""Generate a standalone runnable Python script from a saved beamline
layout: the headless analog of xrtQook's script generation (the reference
GUI writes a full xrt script from its element tree,
gui/xrtQook/widgets/qookbase.py `generateCode`).  Port of the reference
package's ``codegen.py``; it reads the JSON layouts of either package
(:mod:`xrt_tpu_torch.beamline`).

    python -m xrt_tpu_torch codegen beamline.json -o my_beamline.py

The generated script imports ``xrt_tpu_torch``, rebuilds every material and
element with explicit ``create()`` calls (editable, self-documenting) in
``build_beamline(device)``, registers them on a
:class:`~xrt_tpu_torch.beamline.BeamLine`, and its ``main()`` runs
:func:`~xrt_tpu_torch.runner.run_ray_tracing` on the card (``--device cpu``
to run on the CPU) with an x-z detector plot on the last beam of the flow.
"""
from __future__ import annotations

import json
from typing import Dict, List

_TOP = __name__.split('.')[0]


def _module(name):
    """The port's module of a layout's module path (the writer's top-level
    package name replaced by this package's)."""
    parts = name.split('.', 1)
    return _TOP if len(parts) == 1 else f'{_TOP}.{parts[1]}'


def _device_args(cls):
    """``device=device`` where *cls*'s create() takes a device."""
    from .beamline import _create_signature_names
    return ['device=device'] if 'device' in _create_signature_names(cls) \
        else []


def _literal(v, indent=0):
    """Python literal for a JSON-decoded layout value."""
    if isinstance(v, dict) and v.get('__complex__'):
        re, im = v['__complex__']
        return f'complex({re!r}, {im!r})'
    if isinstance(v, float) and v != v:                # NaN
        return "float('nan')"
    if isinstance(v, float) and v in (float('inf'), float('-inf')):
        return "float('inf')" if v > 0 else "float('-inf')"
    if isinstance(v, list):
        return '[' + ', '.join(_literal(x) for x in v) + ']'
    return repr(v)


def _material_expr(mdict) -> str:
    """Expression rebuilding a serialized material; nested materials
    (multilayer layers) are inlined."""
    from . import materials as xm
    cls = mdict['class']
    args = []
    for k, v in mdict['params'].items():
        if isinstance(v, dict) and v.get('__material__'):
            args.append(f'{k}={_material_expr(v)}')
        else:
            args.append(f'{k}={_literal(v)}')
    args += _device_args(getattr(xm, cls))
    call = f"xm.{cls}.create({', '.join(args)})"
    raw = mdict.get('raw') or {}
    if raw:
        # tabulated fields create() cannot take: go through the loader
        return ('material_from_dict(json.loads('
                + repr(json.dumps(mdict)) + '), device=device)')
    return call


def generate_script(layout, repeats=3, save=None) -> str:
    """Return the text of a runnable script for *layout* (a dict, a JSON
    string, or a filename of a JSON layout)."""
    import importlib
    if isinstance(layout, str):
        if layout.lstrip().startswith('{'):
            layout = json.loads(layout)
        else:
            with open(layout) as f:
                layout = json.load(f)

    name = layout.get('name') or 'beamline'
    imports: Dict[str, set] = {}
    lines_mats: List[str] = []
    lines_els: List[str] = []
    needs_loader = False
    for entry in layout['elements']:
        mod = _module(entry['module'])
        imports.setdefault(mod, set()).add(entry['class'])
        ecls = getattr(importlib.import_module(mod), entry['class'])
        mat_args = []
        for fname, mdict in (entry.get('materials') or {}).items():
            var = f"{entry['name']}_{fname}"
            expr = _material_expr(mdict)
            if 'material_from_dict' in expr:
                needs_loader = True
            lines_mats.append(f'{var} = {expr}')
            mat_args.append(f'{fname}={var}')
        params = [f'{k}={_literal(v)}' for k, v in entry['params'].items()]
        params += mat_args + _device_args(ecls)
        call = f"{entry['class']}.create({', '.join(params)})"
        mkw = ''.join(f', {k}={_literal(v)}' for k, v in
                      (entry.get('methodKwargs') or {}).items())
        lines_els.append(
            f"bl.add('{entry['name']}', {call},\n"
            f"       kind='{entry['kind']}', method='{entry['method']}'"
            f"{mkw})")
    last = layout['elements'][-1]['name'] if layout['elements'] else None

    imp_lines = ['import argparse',
                 f'import {_TOP}.materials as xm',
                 f'from {_TOP}.beamline import BeamLine',
                 f'from {_TOP}.runner import run_ray_tracing',
                 f'from {_TOP}.plotspec import XYCPlot, XYCAxis']
    if needs_loader:
        imp_lines += ['import json',
                      f'from {_TOP}.materials.serialize import '
                      'material_from_dict']
    for mod in sorted(imports):
        imp_lines.append(
            f"from {mod} import {', '.join(sorted(imports[mod]))}")

    def indented(lines):
        return ['    ' + ln if ln else ln for ln in
                '\n'.join(lines).split('\n')]

    body = [f'"""{name}: generated by `python -m {_TOP} codegen`.',
            '', f'Edit freely: this is a plain {_TOP} user script.',
            '"""']
    body += imp_lines + ['', '',
                         'def build_beamline(device=None):',
                         '    """The beamline, its sources and materials on '
                         '*device* (the card if None)."""',
                         '    # --- materials']
    body += indented(lines_mats or ['# (none serialized in the layout)'])
    body += ['    # --- beamline',
             f'    bl = BeamLine(name={name!r}, '
             f"azimuth={layout.get('azimuth', 0.0)!r}, "
             f"height={layout.get('height', 0.0)!r}, "
             f"alignE={layout.get('alignE', 9000.0)!r})"]
    body += indented(lines_els)
    body += ['    return bl',
             '', '',
             'def run_process(beamLine, generator):',
             '    return beamLine.propagate_flow(generator)',
             '', '',
             'def main(repeats=%d, save=%r, device=None, seed=0):' % (
                 repeats, save),
             '    bl = build_beamline(device)',
             '    plot = XYCPlot(',
             f"        beam='{last}',",
             "        xaxis=XYCAxis('x', 'mm'),",
             "        yaxis=XYCAxis('z', 'mm'),",
             "        caxis=XYCAxis('energy', 'eV'))",
             '    run_ray_tracing([plot], repeats=repeats, beamLine=bl,',
             '                    run_process=run_process, rng=seed,',
             '                    device=device)',
             '    if save:',
             f'        from {_TOP}.plotting import save_plot',
             '        save_plot(plot, save)',
             "    print(f'{plot.beam}: flux={plot.intensity:.6g} '",
             "          f'nGood={plot.nRaysGood}')",
             '    return plot',
             '', '',
             "if __name__ == '__main__':",
             '    ap = argparse.ArgumentParser()',
             "    ap.add_argument('--repeats', type=int, default=%d)"
             % repeats,
             "    ap.add_argument('--save', default=None)",
             "    ap.add_argument('--device', default=None,",
             "                    help='the card by default; cpu to run on "
             "the CPU')",
             "    ap.add_argument('--seed', type=int, default=0)",
             '    a = ap.parse_args()',
             '    main(a.repeats, a.save, a.device, a.seed)', '']
    return '\n'.join(body)
