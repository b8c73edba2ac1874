"""Guards of the port's independence from the JAX package.

* Importing ``xrt_tpu_torch`` (every module) adds no ``jax``, ``flax`` or
  ``xrt_tpu`` module to ``sys.modules``, checked in a fresh interpreter.
* No import statement under ``xrt_tpu_torch/``, in ``chip_smoke.py`` or in
  the port's tools (``tools/torch_bench_softimax.py``,
  ``tools/torch_bench_analyzer.py``) names ``jax``, ``flax`` or ``xrt_tpu``
  (other than ``xrt_tpu_torch``),
  and no text there names ``jax`` or ``flax`` at all.  ``xrt_tpu`` may be
  named in comments and docstrings only (the kernels cite the TPU kernels
  they replace): no string literal of the package names it, so no path
  into ``xrt_tpu/`` can be built.
* The atomic tables are read from ``xrt_tpu_torch/data/`` and are
  byte-identical copies of the reference package's.
* ``chip_smoke.py`` on a host without a CUDA device exits non-zero and
  prints no result.
"""
import ast
import os
import pkgutil
import re
import subprocess
import sys

import xrt_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'xrt_tpu')
PORT_TOOLS = ('torch_bench_softimax.py', 'torch_bench_analyzer.py')


def _forbidden(mod):
    top = mod.split('.')[0]
    return top in FORBIDDEN


def _port_files():
    pkg = os.path.join(ROOT, 'xrt_tpu_torch')
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, 'chip_smoke.py')
    for tool in PORT_TOOLS:
        yield os.path.join(ROOT, 'tools', tool)


def test_import_adds_no_jax_or_reference_module():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        xrt_tpu_torch.__path__, 'xrt_tpu_torch.'))
    code = (
        'import sys, importlib\n'
        'before = set(sys.modules)\n'
        f'for m in {mods!r}:\n'
        '    importlib.import_module(m)\n'
        'new = set(sys.modules) - before\n'
        'bad = sorted(m for m in new if m.split(".")[0] in '
        f'{FORBIDDEN!r})\n'
        'print("BAD", bad)\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stderr
    assert 'BAD []' in r.stdout, r.stdout
    assert len(mods) >= 15
    assert {'xrt_tpu_torch.coherence', 'xrt_tpu_torch.modes',
            'xrt_tpu_torch.kde'} <= set(mods)


def test_no_import_statement_names_jax_or_the_reference():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            elif isinstance(node, ast.Call) and getattr(
                    node.func, 'attr', getattr(node.func, 'id', '')) in (
                    'import_module', '__import__') and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad, bad


def test_no_port_file_names_jax():
    """Not even in a comment or a string: the port's sources (Python and
    CUDA) and chip_smoke.py say nothing of jax or flax."""
    paths = list(_port_files())
    for dirpath, _, files in os.walk(os.path.join(ROOT, 'xrt_tpu_torch',
                                                  'csrc')):
        paths += [os.path.join(dirpath, f) for f in files]
    bad = []
    for path in paths:
        with open(path) as f:
            text = f.read().lower()
        bad += [(path, w) for w in ('jax', 'flax') if w in text]
    assert not bad, bad
    assert any(p.endswith('.cu') for p in paths)


def test_the_guards_cover_every_kernel_source():
    """Every source the port builds lies under ``xrt_tpu_torch/csrc`` (the
    directory the text guard walks), with the adjoint kernels among them,
    and every Python module of the package is among the files the import
    and string guards read."""
    from xrt_tpu_torch.ops import _cuda
    csrc = os.path.join(ROOT, 'xrt_tpu_torch', 'csrc')
    assert os.path.realpath(str(_cuda.CSRC)) == os.path.realpath(csrc)
    for name in _cuda.SOURCES:
        assert os.path.isfile(os.path.join(csrc, name + '.cu')), name
    assert {'kirchhoff_recentred_bwd', 'kirchhoff_ddphase_bwd',
            'hist2d'} <= set(_cuda.SOURCES)
    assert sorted(f for f in os.listdir(csrc) if f.endswith('.cu')) == \
        sorted(n + '.cu' for n in _cuda.SOURCES)
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    mods = {m.name.replace('.', os.sep) for m in pkgutil.walk_packages(
        xrt_tpu_torch.__path__, 'xrt_tpu_torch.') if not m.ispkg}
    assert {m + '.py' for m in mods} <= files


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and \
                isinstance(node.body[0].value, ast.Constant):
            out.add(id(node.body[0].value))
    return out


def test_no_string_of_the_package_builds_a_path_into_the_reference():
    """Outside docstrings no string literal under ``xrt_tpu_torch/`` names
    ``xrt_tpu`` (other than ``xrt_tpu_torch``), and the data directory the
    materials read lies inside the port's own package."""
    bad = []
    for path in _port_files():
        if os.path.basename(path) == 'chip_smoke.py':
            continue        # it cites file:line of the kernels it replaces
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        doc = _docstrings(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and id(node) not in doc and \
                    re.search(r'xrt_tpu(?!_torch)', node.value):
                bad.append((path, node.lineno, node.value))
    assert not bad, bad
    from xrt_tpu_torch.materials import data
    pkg = os.path.join(ROOT, 'xrt_tpu_torch')
    assert os.path.commonpath([os.path.realpath(data.DATA_DIR),
                               os.path.realpath(pkg)]) == \
        os.path.realpath(pkg)


def test_the_slice_exports_its_sources_and_optics():
    from xrt_tpu_torch import oes, sources
    assert {'BlazedGrating', 'EllipticalMirrorParam',
            'EllipticalMirror'} <= set(oes.__all__)
    assert 'Undulator' in sources.__all__
    assert oes.EllipticalMirror is oes.EllipticalMirrorParam
    # the crystal slice: crystals, monochromators, analyzers, BeamLine
    from xrt_tpu_torch import beamline, materials
    assert {'DCM', 'DCMwithSagittalFocusing', 'DicedJohanssonToroid',
            'JohannCylinder', 'GeneralBraggToroid'} <= set(oes.__all__)
    assert {'CrystalSi', 'CrystalDiamond', 'CrystalFromCell'} <= \
        set(materials.__all__)
    assert hasattr(beamline.BeamLine, 'place')
    # the port's tools name no path into the reference package (the
    # SoftiMAX tool reads its golden samples from tests/golden only)
    for tool in PORT_TOOLS:
        with open(os.path.join(ROOT, 'tools', tool)) as f:
            text = f.read()
        assert not re.search(r'xrt_tpu(?!_torch)', text), tool


def test_data_tables_are_byte_identical_copies():
    names = ('Henke.npz', 'Chantler.npz', 'BrCo.npz', 'AtomicData.dat',
             'f0_xop.dat')
    for name in names:
        with open(os.path.join(ROOT, 'xrt_tpu_torch', 'data', name),
                  'rb') as f:
            mine = f.read()
        with open(os.path.join(ROOT, 'xrt_tpu', 'data', name), 'rb') as f:
            ref = f.read()
        assert mine == ref, name
    assert sorted(os.listdir(os.path.join(ROOT, 'xrt_tpu_torch',
                                          'data'))) == sorted(names)


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip('a CUDA device is present')
    r = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
