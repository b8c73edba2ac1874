"""What every test module of the port (``tests/test_torch_*.py``) shares:
the process's torch threads, and the host build of a kernel's
``__host__ __device__`` code.

Importing this module sets torch to one intra-op thread.  The test run
gets its parallelism from pytest-xdist's worker processes; an intra-op
pool in every worker oversubscribes the cores, and its threads then wait
at barriers on peers the scheduler has put aside, in tests made of
thousands of small element-wise operations.  One thread also makes the
CPU's reductions independent of the host's core count.  Every port test
module imports this first, so a module run alone runs as it does in the
suite.

:func:`host_build` compiles per-ray or per-pair functions of
``xrt_tpu_torch/csrc`` with ``g++`` against :data:`STUB_RUNTIME`, behind a
C harness that a test writes, so that their arithmetic is checked on the
CPU against the plain PyTorch versions.
"""
import ctypes
import shutil
import subprocess

import pytest
import torch

from xrt_tpu_torch.ops._cuda import CSRC

torch.set_num_threads(1)

#: what the kernels' ``__host__ __device__`` code needs of the CUDA
#: runtime, for the host: the qualifiers, the stream type, and the
#: intrinsics as the card rounds them (``-ffp-contract=off`` keeps every
#: other multiply and add apart, as ``--fmad=false`` does)
STUB_RUNTIME = r"""
#pragma once
#include <math.h>
#define __device__
#define __host__
#define __forceinline__ inline
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float __frcp_rn(float x) { return 1 / x; }
inline long long __double2ll_rn(double x) { return llrint(x); }
inline float __ll2float_rn(long long x) { return (float)x; }
inline double __ll2double_rn(long long x) { return (double)x; }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned o = *p; *p = o + v; return o;
}
"""
GXX_FLAGS = ('-O1', '-ffp-contract=off', '-std=c++17', '-shared', '-fPIC')


def host_build(tmp_path_factory, name, files, headers=(), defines=()):
    """The shared library ``lib<name>.so`` built for the host with ``g++``
    in a new directory holding :data:`STUB_RUNTIME` as ``cuda_runtime.h``,
    the sources *files* ({file name: text}; the first is compiled, the
    others are headers it includes, such as stubs of a kernel's launch
    skeleton) and copies of the *headers* of ``xrt_tpu_torch/csrc``.
    *defines* are ``-D`` arguments (``'NAME'`` or ``'NAME=VALUE'``).
    Skips the test when there is no ``g++``."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to build the kernels\' host code')
    d = tmp_path_factory.mktemp(name)
    (d / 'cuda_runtime.h').write_text(STUB_RUNTIME)
    for f, text in files.items():
        (d / f).write_text(text)
    for h in headers:
        shutil.copy(CSRC / h, d)
    so = d / f'lib{name}.so'
    subprocess.run([gxx, *GXX_FLAGS, '-I', str(d),
                    *(f'-D{x}' for x in defines), '-o', str(so),
                    str(d / next(iter(files)))], check=True)
    return ctypes.CDLL(str(so))
