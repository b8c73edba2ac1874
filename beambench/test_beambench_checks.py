"""CPU tests of the checks that decide ``correct``: each plain reference
against the program on a tiny instance of its beamline, the control (the
reference in the precision below the configuration's, in the program's
place) failing the cell's limits, and runs with the timed path broken
underneath coming out not correct.

    python -m pytest beambench -q -p no:cacheprovider
"""
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import calibrate  # noqa: E402
import harness  # noqa: E402
import run  # noqa: E402

TINY = {'softimax': dict(nrays=2000, n_scr=16), 'analyzer': dict(nrays=4000)}
SEED = 3000000101


def _limits(cell):
    return harness.find_cell(cell)[0]['check']['limits']


@pytest.fixture(scope='module')
def analyzer_readings():
    return calibrate.readings('analyzer.trace', SEED, 3.0, True,
                              device='cpu', overrides=TINY['analyzer'])


@pytest.fixture(scope='module')
def softimax_readings():
    return calibrate.readings('softimax.wave', SEED, 1.0, True,
                              device='cpu', overrides=TINY['softimax'])


def test_analyzer_reference_agrees_with_the_program(analyzer_readings):
    r = analyzer_readings['program']
    assert r['passes'] >= 1
    assert r['source_z'] < 6.0
    assert r['rays_off'] < 1e-2      # facet edges, Darwin-curve flanks
    assert r['hist_err'] < 1e-5      # the same bins, float32 sums


def test_analyzer_control_fails_the_limits(analyzer_readings):
    c, lim = analyzer_readings['control'], _limits('analyzer.trace')
    assert any(c[k] > lim[k] for k in lim)


def test_softimax_reference_agrees_with_the_program(softimax_readings):
    r = softimax_readings['program']
    assert r['source_err'] < 2e-4 and r['focus_err'] < 1e-3
    # every step but the one from the blazed grating, whose float32 facet
    # normals the next test looks at
    assert max(v for k, v in r['steps'].items() if k != 'm3') < 3e-3


def test_softimax_grating_step_with_the_programs_normals():
    """PG -> M3: the reference's sums agree with the program's when handed
    the program's own float32 facet normals, and those differ from the
    reference's only at samples within float32 rounding of a groove
    edge."""
    cell, traffic, cfg, drv = harness.find_cell('softimax.wave')
    ref = harness.load_module('references', 'softimax')
    cfg = dict(cfg, **TINY['softimax'])
    rc = drv.build_chain(cfg, device='cpu',
                         generator=torch.Generator().manual_seed(SEED))
    outs = {}
    rc(torch.Generator().manual_seed(SEED + 1), outputs=outs)
    sb, out = outs['m3']
    w = rc.waves['m3']
    d = tuple(h.double() + lo.double() for h, lo in (
        (w.xDiffr, w.xDiffr_lo), (w.yDiffr, w.yDiffr_lo),
        (w.zDiffr, w.zDiffr_lo)))
    n = rc.elements['pg'].local_n(sb.x, sb.y)
    ones = torch.ones_like(sb.x, dtype=torch.float64)
    nx, ny, nz = (t.double() * ones for t in n[-3:])
    nl = sb.a.double() * nx + sb.b.double() * ny + sb.c.double() * nz
    src = (sb.x.double(), sb.y.double(), sb.z.double(),
           sb.Es.to(torch.complex128), sb.Ep.to(torch.complex128),
           nx, ny, nz, nl, (sb.state == 1).double())
    Es, Ep = ref.kirchhoff_sums(d, src, float(sb.E[0]))
    err = ref._rel((out.EsAcc.to(torch.complex128),
                    out.EpAcc.to(torch.complex128)), (Es, Ep))
    assert err < 3e-3
    kind, prm = ref.senders(cfg)['m3']
    nr = ref.normal(kind, prm, sb.x.double(), sb.y.double(), sb.z.double())
    differ = (ny > 0) != (nr[1] > 0)
    period = 1.0 / prm['rho']
    yl = torch.remainder(sb.y.double(), period)
    edge = torch.minimum(yl, period - yl)
    ulp = torch.abs(sb.y.double()) * 2.0 ** -23 + 1e-12
    assert bool(torch.all(edge[differ] <= 4 * ulp[differ]))


def test_softimax_control_fails_the_limits(softimax_readings):
    c, lim = softimax_readings['control'], _limits('softimax.wave')
    assert any(c[k] > lim[k] for k in lim)


def _run(cell, seconds=2.0):
    cfg = harness.find_cell(cell)[0]['config']
    code, out = run.run(['--workload', cell, '--seed', str(SEED),
                         '--seconds', str(seconds), '--trace', '0'],
                        device='cpu', chip_check=False, overrides=TINY[cfg])
    assert code == 0
    return out


def _half_the_rays(fn):
    """*fn* over the first half of each ray column, the weights doubled:
    half of the batch left out, the mean taken over the rest."""
    def half(x, y, cData, flux, w2d, mask, *args, **kw):
        h = x.shape[0] // 2
        return fn(x[:h], y[:h], cData[:h], 2 * flux[:h], 2 * w2d[:h],
                  mask[:h], *args, **kw)
    return half


def _one_bin_altered(fn):
    """*fn* with the fullest bin of each 2D histogram half as full again."""
    def altered(*args, **kw):
        out = fn(*args, **kw)
        xyh = out['xyh'].clone()
        j = int(torch.argmax(xyh))
        xyh.view(-1)[j] *= 1.5
        out['xyh'] = xyh
        return out
    return altered


def test_analyzer_breaks_are_not_correct(monkeypatch):
    from xrt_tpu_torch import runner
    from xrt_tpu_torch.oes import DicedJohanssonToroid
    assert _run('analyzer.trace')['correct']
    with monkeypatch.context() as m:
        # a step that returns its state unchanged
        m.setattr(DicedJohanssonToroid, 'reflect',
                  lambda self, beam, generator=None, **kw: (beam, beam))
        assert not _run('analyzer.trace')['correct']
    with monkeypatch.context() as m:
        m.setattr(runner, 'hist_plot_plain',
                  _half_the_rays(runner.hist_plot_plain))
        assert not _run('analyzer.trace')['correct']
    with monkeypatch.context() as m:
        # an answer altered where it is produced
        m.setattr(runner, 'hist_plot_plain',
                  _one_bin_altered(runner.hist_plot_plain))
        assert not _run('analyzer.trace')['correct']


def _softimax_broken(monkeypatch, patch):
    """The checked numbers of a tiny SoftiMAX run with waves.diffract
    replaced by *patch(diffract)*."""
    from xrt_tpu_torch import waves
    with monkeypatch.context() as m:
        m.setattr(waves, 'diffract', patch(waves.diffract))
        return calibrate.readings('softimax.wave', SEED, 0.5, False,
                                  device='cpu',
                                  overrides=TINY['softimax'])['program']


def _fails(r, lim):
    """Whether a number of *r* other than the grating step's (which the
    program's float32 facet normals move; see the test above) exceeds its
    limit."""
    steps = max(v for k, v in r['steps'].items() if k != 'm3')
    return not (steps <= lim['stage_err'] and
                r['source_err'] <= lim['source_err'] and
                r['focus_err'] <= lim['focus_err'])


def test_softimax_breaks_are_not_correct(monkeypatch):
    lim = _limits('softimax.wave')

    def unchanged(diffract):
        # a step that returns its state unchanged: the grating's receiving
        # wave as it was prepared
        def f(oeLocal, wave, **kw):
            if type(wave.toOE).__name__ == 'BlazedGrating':
                return wave
            return diffract(oeLocal, wave, **kw)
        return f

    def half(diffract):
        # half of the sources left out, the rest weighted double
        def f(oeLocal, wave, **kw):
            n = oeLocal.x.shape[0]
            keep = (torch.arange(n) < n // 2).to(oeLocal.Es.dtype)
            return diffract(oeLocal.replace(Es=2 * oeLocal.Es * keep,
                                            Ep=2 * oeLocal.Ep * keep),
                            wave, **kw)
        return f

    def altered(diffract):
        # an answer altered where it is produced: a focal image's peak
        def f(oeLocal, wave, **kw):
            out = diffract(oeLocal, wave, **kw)
            if type(wave.toOE).__name__ == 'Screen':
                J = out.Jss.clone()
                J[int(torch.argmax(J))] *= 1.5
                out = out.replace(Jss=J)
            return out
        return f
    assert not _fails(_softimax_broken(monkeypatch, lambda d: d), lim)
    for patch in (unchanged, half, altered):
        assert _fails(_softimax_broken(monkeypatch, patch), lim)
