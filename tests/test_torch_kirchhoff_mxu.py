"""The port's B1 against the JAX kernel's MXU accumulation modes.

The CUDA kernel runs every ``accumulate`` value ('mxu', 'mxu2',
'mxu-fast', 'mxu32') as the exact per-pair f32 contraction, so its plain
version is held to the JAX interpret-mode kernel in each mode at that
mode's documented bounds, the ``_TOL`` table of the JAX package's
``test_kirchhoff_mxu_parity.py`` (fields Es/Ep, direction integrals a/b/c),
plus that test's check of the normalized per-destination direction.
Inputs and the O0 JAX subprocess as in ``test_torch_kirchhoff.py``.
"""
import numpy as np
import pytest

from test_torch_kirchhoff import (ND, NS, make_inputs, rel_errors,
                                  run_jax_kernels, targs)
from xrt_tpu_torch.ops import kirchhoff as tk

_TOL = {'mxu32': (2e-5, 2e-5), 'mxu': (2e-4, 1e-2),
        'mxu2': (2e-4, 1e-2), 'mxu-fast': (1e-2, 1e-2)}
ACCS = ('mxu32', 'mxu', 'mxu2', 'mxu-fast')


def _seed(mono):
    return 40 if mono else 41


@pytest.fixture(scope='module')
def jax_mxu(clean_env_runner, tmp_path_factory):
    cases = {f'{acc}/{mono}': ('recentred', mono, False, acc, _seed(mono))
             for acc in ACCS for mono in (True, False)}
    return run_jax_kernels(clean_env_runner, tmp_path_factory.mktemp('m'),
                           cases)


@pytest.mark.parametrize('mono', [True, False])
@pytest.mark.parametrize('acc', ACCS)
def test_plain_b1_within_mxu_bounds(jax_mxu, acc, mono):
    a = make_inputs(_seed(mono), NS, ND, poly=not mono)
    got = tk.kirchhoff_integral_kernel(*targs(a), monochromatic=mono,
                                       accumulate=acc, narrowband=False)
    got = np.stack([v.numpy() for v in got])
    ref = jax_mxu[f'{acc}/{mono}']
    ftol, dtol = _TOL[acc]
    errs = rel_errors(got, ref)
    for i, e in enumerate(errs):
        assert e < (ftol if i < 2 else dtol), (acc, mono, i, errs)

    def dirs(o):
        d = np.stack([v.real for v in o[2:5]])
        return d / np.linalg.norm(d, axis=0)
    ang = np.linalg.norm(dirs(got) - dirs(ref), axis=0)
    assert np.median(ang) < 5e-3, (acc, mono, np.median(ang))
