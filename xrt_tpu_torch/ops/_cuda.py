"""Build and load the hand-written CUDA kernels of ``xrt_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into
``build/kernels/lib<name>-<hash>.so`` (the hash covers the source, the
shared headers and the flags, so an edited source rebuilds) and bound with
``ctypes`` through its plain C interface: a launch is one :func:`launch`
call with the entry point's name, argument types, card and arguments.
Nothing here runs at import: the CPU tests import every module on a host
without ``nvcc``.

``--fmad=false`` keeps every ``a * b + c`` a separate multiply and add: a
contracted FMA breaks the error-free transforms of the double-float code
(see ``csrc/dd.cuh``).  A ``__fmaf_rn`` written by hand is still an FMA,
so the kernels fuse explicitly where no error-free transform lives: the
amplitude and the ten sums of the forward kernels (B1, B2 on the skeleton
``csrc/kirchhoff_fwd.cuh``), the reverse sweeps of the adjoint kernels (B3
on ``csrc/kirchhoff_bwd.cuh``), and ``two_prod``'s error term.  The pair
functions of both skeletons, the toroid crystals' per-ray search
(``csrc/toroid_search.cuh``) and the Kirchhoff stages' per-point
preparation (``csrc/kirchhoff_prep.cuh``) are also compiled for the host
by the CPU tests (``tests/test_torch_forward.py``,
``tests/test_torch_adjoint.py``, ``tests/test_torch_search_kernel.py``,
``tests/test_torch_prep_kernel.py``, through ``host_build`` of
``tests/torch_harness.py``) against a stub of the CUDA runtime.  No
``--use_fast_math``: ``sqrtf``, ``1.0f / x``, ``sinf`` and ``cosf`` stay
IEEE.  ``-Xptxas -v`` puts every kernel's registers and spills into the
build log, which is kept beside the library (:func:`build_log`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / 'build' / \
    'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')
#: kernel sources, one shared library each
SOURCES = ('kirchhoff_recentred', 'kirchhoff_ddphase',
           'kirchhoff_recentred_bwd', 'kirchhoff_ddphase_bwd', 'dd_selftest',
           'hist2d', 'hist_plot', 'toroid_search', 'kirchhoff_prep')


def nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME', ''), '/usr/local/cuda'):
        p = Path(cand) / 'bin' / 'nvcc'
        if cand and p.exists():
            return str(p)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels are built on '
                           'the machine with the card')
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob('*.cuh')) + [CSRC / f'{name}.cu']:
        h.update(f.read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, one ``nvcc``
    each, all started together.  Returns {name: compiler output}; raises
    if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        logs[name] = log
        if p.returncode != 0:
            failed.append(f'{name}:\n{log}')
            continue
        out.with_suffix('.log').write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return logs


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix('.log').read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if needed."""
    path = library_path(name)
    if not path.exists():
        build((name,))
    return ctypes.CDLL(str(path))


def entry(name: str, fn: str, argtypes):
    """The C entry point *fn* of ``csrc/<name>.cu`` with its argument
    types declared (``c_void_p`` for pointers and the stream, so ctypes
    does not cut them to 32 bits); it returns a ``cudaError_t``."""
    f = getattr(load(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(name: str, fn: str, argtypes, device, *args) -> None:
    """Call the C entry point *fn* of ``csrc/<name>.cu`` (its *argtypes*
    end with the stream's) on card *device* with *args* and that card's
    current stream; raise if it returns a nonzero ``cudaError_t``."""
    import torch
    f = entry(name, fn, argtypes)
    with torch.cuda.device(device):
        err = f(*args, stream_ptr(device))
    check(err, fn)
