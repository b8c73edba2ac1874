"""The port's coherence analysis and KDE against the JAX package, xrt's golden
data and scipy.

* Every function of ``coherence.py`` on ``ref_coherence.npz``'s field stack
  at ``tests/test_coherence.py``'s tolerances (1e-9; eigenvectors, defined
  up to a phase, by projector collinearity and norms to 1e-6, for the modes
  above 1e-8 of the largest weight: the stack has rank 2), and against the
  JAX package's results on the same stack to 1e-12.
* The blocked mutual intensity (``j4d_block``, ``j4d_apply``,
  ``degree_of_coherence_map``) against the dense J and the JAX package.
* The mutual-intensity plots (fluxKind 'Esxx', 'Es4D', 'EsPCA') through the
  port's ``histogram_plot`` / ``_accumulate`` into the coherence
  functions, as ``tests/test_mutual_intensity.py`` runs them, on the same
  numpy rays in both packages.
* ``GaussianKDE`` against scipy's ``gaussian_kde`` (1-D Scott, 2-D
  Silverman, 1e-6), the weighted subset rule, a scalar bandwidth's
  integral, and the JAX package's densities to 1e-12.
"""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from xrt_tpu import coherence as jc
from xrt_tpu.kde import GaussianKDE as JKDE
from xrt_tpu_torch import coherence as tc
from xrt_tpu_torch.kde import GaussianKDE

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')


@pytest.fixture(scope='module')
def ref():
    return np.load(os.path.join(GOLDEN, 'ref_coherence.npz'))


def close(t, j, rtol):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert np.abs(t - j).max() <= rtol * np.abs(j).max(), (t, j)


def test_1d_coherent_fraction(ref):
    U = torch.from_numpy(ref['U'])
    axis = torch.from_numpy(ref['axis'])
    axes = {'x': ref['axis'], 'z': np.linspace(-1.0, 1.0, U.shape[2])}
    for name in ('x', 'z'):
        got = tc.calc_1D_coherent_fraction(U, name,
                                           torch.from_numpy(axes[name]))
        jgot = jc.calc_1D_coherent_fraction(jnp.asarray(ref['U']), name,
                                            jnp.asarray(axes[name]))
        for i in (0, 1, 2, 3, 4, 6):
            close(got[i], jgot[i], 1e-12)
        assert got[5] == jgot[5]
        if name == 'x':
            J, II, Jd, varI, varJd, limJd, cohFr = got
            np.testing.assert_allclose(J.numpy(), ref['J'], rtol=1e-9,
                                       atol=1e-12)
            np.testing.assert_allclose(II.numpy(), ref['II'], rtol=1e-9)
            np.testing.assert_allclose(Jd.numpy(), ref['Jd'], rtol=1e-9,
                                       atol=1e-12)
            for v, k in ((varI, 'varI'), (varJd, 'varJd'),
                         (cohFr, 'cohFr')):
                np.testing.assert_allclose(float(v), ref[k], rtol=1e-9)
            if np.isnan(ref['limJd']):
                assert limJd is None
            else:
                np.testing.assert_allclose(limJd, ref['limJd'], rtol=1e-9)
    # a p > 0 scales J before the normalization, which removes it
    a = tc.calc_1D_coherent_fraction(U, 'x', axis, p=3.0)
    b = jc.calc_1D_coherent_fraction(jnp.asarray(ref['U']), 'x',
                                     jnp.asarray(ref['axis']), p=3.0)
    close(a[6], b[6], 1e-12)
    with pytest.raises(ValueError):
        tc.calc_1D_coherent_fraction(U, 'q', axis)


def test_local_minimum_of_the_degree_of_coherence():
    """A stack whose DoC dips below 0.5: the host's selection of the first
    local minimum (limDoC) and the restricted variance, as the JAX
    package's."""
    rng = np.random.default_rng(4)
    x = np.linspace(-1, 1, 33)
    U = np.exp(-x[None, :, None] ** 2 * 4 +
               1j * rng.normal(size=(40, 1, 1)) * 6 * x[None, :, None]) * \
        np.ones((1, 1, 5))
    got = tc.calc_1D_coherent_fraction(torch.from_numpy(U), 'x',
                                       torch.from_numpy(x))
    jgot = jc.calc_1D_coherent_fraction(jnp.asarray(U), 'x',
                                        jnp.asarray(x))
    assert got[5] is not None and got[5] == jgot[5]
    close(got[4], jgot[4], 1e-12)
    close(got[6], jgot[6], 1e-12)


def test_dotc(ref):
    U = torch.from_numpy(ref['U'])
    pca = float(tc.calc_degree_of_transverse_coherence_PCA(U))
    np.testing.assert_allclose(pca, ref['dotcPCA'], rtol=1e-9)
    D = ref['U'].reshape(ref['U'].shape[0], -1)
    J = D.T.conj() @ D
    d4 = float(tc.calc_degree_of_transverse_coherence_4D(
        torch.from_numpy(J)))
    np.testing.assert_allclose(d4, ref['dotc4'], rtol=1e-9)
    np.testing.assert_allclose(pca, float(
        jc.calc_degree_of_transverse_coherence_PCA(jnp.asarray(ref['U']))),
        rtol=1e-12)


def _collinear(a, b):
    ip = np.vdot(b, a)
    na, nb = np.vdot(a, a).real, np.vdot(b, b).real
    np.testing.assert_allclose(abs(ip) ** 2, na * nb, rtol=1e-6)
    np.testing.assert_allclose(na, nb, rtol=1e-6)


def test_eigen_modes_pca(ref):
    U = torch.from_numpy(ref['U'])
    w, v = tc.calc_eigen_modes_PCA(U, eigenN=4)
    np.testing.assert_allclose(w.numpy(), ref['wPCA'], rtol=1e-7,
                               atol=1e-12)
    jw, jv = jc.calc_eigen_modes_PCA(jnp.asarray(ref['U']), eigenN=4)
    wmax = float(w.max())
    for i in range(4):
        if float(w[i]) < 1e-8 * wmax:
            continue
        _collinear(v[:, i].numpy(), ref['vPCA'][:, i])
        _collinear(v[:, i].numpy(), np.asarray(jv[:, i]))
    # normalized modes, a cut on the repeats, eigenN=None
    wn, vn = tc.calc_eigen_modes_PCA(U, eigenN=2, maxRepeats=12,
                                     normalize=True)
    jwn, jvn = jc.calc_eigen_modes_PCA(jnp.asarray(ref['U']), eigenN=2,
                                       maxRepeats=12, normalize=True)
    close(wn, jwn, 1e-12)
    np.testing.assert_allclose(torch.linalg.vector_norm(vn, dim=0).numpy(),
                               1.0, rtol=1e-12)
    _collinear(vn[:, -1].numpy(), np.asarray(jvn[:, -1]))
    assert tc.calc_eigen_modes_PCA(U, eigenN=None)[0].shape == (20,)


def test_eigen_modes_4d_vs_pca(ref):
    U = ref['U']
    D = U.reshape(U.shape[0], -1)
    J = D.T.conj() @ D / U.shape[0]
    w4, v4 = tc.calc_eigen_modes_4D(torch.from_numpy(J), eigenN=3)
    wp, _ = tc.calc_eigen_modes_PCA(torch.from_numpy(U), eigenN=3)
    w4, wp = w4.numpy(), wp.numpy()
    sig = wp > 1e-8 * wp.max()
    np.testing.assert_allclose((w4 / w4.sum())[sig], (wp / wp.sum())[sig],
                               rtol=1e-6, atol=1e-10)
    jw4, jv4 = jc.calc_eigen_modes_4D(jnp.asarray(J), eigenN=3)
    close(w4, jw4, 1e-12)
    _collinear(v4[:, -1].numpy(), np.asarray(jv4[:, -1]))
    assert tc.calc_eigen_modes_4D(torch.from_numpy(J), eigenN=0)[0].shape \
        == (192,)


def test_blocked_j4d_matches_dense_and_jax():
    rng = np.random.default_rng(5)
    r, n = 24, 90
    Un = rng.normal(size=(r, n)) + 1j * rng.normal(size=(r, n))
    U = torch.from_numpy(Un)
    J = Un.T @ Un.conj() / r
    rows = torch.arange(10, 30)
    np.testing.assert_allclose(tc.j4d_block(U, rows).numpy(), J[10:30, :],
                               rtol=1e-12)
    close(tc.j4d_block(U, rows), jc.j4d_block(jnp.asarray(Un),
                                              jnp.arange(10, 30)), 1e-14)
    vn = rng.normal(size=n) + 1j * rng.normal(size=n)
    np.testing.assert_allclose(tc.j4d_apply(U, torch.from_numpy(vn)).numpy(),
                               J @ vn, rtol=1e-12)
    g, refpt = tc.degree_of_coherence_map(U)
    jg, jref = jc.degree_of_coherence_map(jnp.asarray(Un))
    assert refpt == jref
    I = np.abs(np.diag(J))
    np.testing.assert_allclose(g.numpy(), np.abs(J[:, refpt]) /
                               np.sqrt(I * I[refpt]), rtol=1e-10)
    close(g, jg, 1e-13)
    assert float(g[refpt]) == pytest.approx(1.0)
    g5, _ = tc.degree_of_coherence_map(U, ref=5)
    close(g5, jc.degree_of_coherence_map(jnp.asarray(Un), ref=5)[0], 1e-13)
    np.testing.assert_allclose(
        float(tc.calc_degree_of_transverse_coherence_PCA(U)),
        float(tc.calc_degree_of_transverse_coherence_4D(torch.from_numpy(J))),
        rtol=1e-10)


def _coherent_rays(seed, n):
    """A fully coherent Gaussian field sampled by rays, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, n)
    z = rng.uniform(-1.0, 1.0, n)
    Es = np.exp(-x ** 2 - z ** 2) * np.exp(1j * 2.0 * x)
    zero = np.zeros_like(x)
    return dict(x=x, y=zero, z=z, a=zero, b=np.ones_like(x), c=zero,
                E=np.full_like(x, 9000.0), state=np.ones(n, np.int32),
                path=zero, Jss=(Es * np.conj(Es)).real, Jpp=zero,
                Jsp=np.zeros_like(Es), Es=Es, Ep=np.zeros_like(Es))


def _plots(fluxKind, bins):
    from xrt_tpu.plotspec import XYCAxis as JAxis, XYCPlot as JPlot
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    out = []
    for P, A in ((XYCPlot, XYCAxis), (JPlot, JAxis)):
        out.append(P(beam='b', xaxis=A('x', 'mm', limits=(-1, 1), bins=bins),
                     yaxis=A('z', 'mm', limits=(-1, 1), bins=bins),
                     caxis=A('energy', 'eV', limits=(8990, 9010),
                             bins=bins), fluxKind=fluxKind))
    return out


@pytest.mark.parametrize('fluxKind,bins', [('Esxx', 16), ('Es4D', 8),
                                           ('EsPCA', 8)])
def test_mutual_intensity_plots_into_the_coherence_functions(fluxKind,
                                                             bins):
    from xrt_tpu.beam import Beam as JBeam
    from xrt_tpu.runner import _accumulate as jacc, histogram_plot as jhp
    from xrt_tpu_torch import interop
    from xrt_tpu_torch.runner import _accumulate, histogram_plot
    tp, jp = _plots(fluxKind, bins)
    for i in range(4):
        rays = _coherent_rays(i, 2000)
        _accumulate(tp, histogram_plot(tp, {'b': interop.beam_from_numpy(
            rays, device='cpu', dtype=torch.float64)}))
        jacc(jp, jhp(jp, {'b': JBeam(**{k: jnp.asarray(v)
                                        for k, v in rays.items()})}))
    if fluxKind == 'Esxx':
        J, jJ = tp.totalJ2D, jp.totalJ2D
        np.testing.assert_allclose(J, jJ, rtol=1e-10, atol=1e-12 *
                                   np.abs(jJ).max())
        w = np.linalg.eigvalsh(J)
        assert w[-1] / w.sum() > 0.98
        # the coherence functions on the accumulated J
        close(tc.calc_degree_of_transverse_coherence_4D(torch.from_numpy(J)),
              jc.calc_degree_of_transverse_coherence_4D(jnp.asarray(jJ)),
              1e-10)
    elif fluxKind == 'Es4D':
        J, jJ = tp.totalJ4D, jp.totalJ4D
        assert J.shape == (64, 64)
        np.testing.assert_allclose(J, jJ, rtol=1e-10, atol=1e-12 *
                                   np.abs(jJ).max())
        w4, _ = tc.calc_eigen_modes_4D(torch.from_numpy(J), eigenN=2)
        close(w4, jc.calc_eigen_modes_4D(jnp.asarray(jJ), eigenN=2)[0],
              1e-10)
    else:
        fields = np.stack(tp.fieldsPCA)
        jfields = np.stack(jp.fieldsPCA)
        np.testing.assert_allclose(fields, jfields, rtol=1e-10,
                                   atol=1e-12 * np.abs(jfields).max())
        U = torch.from_numpy(fields.reshape(-1, bins, bins))
        w, _ = tc.calc_eigen_modes_PCA(U)
        assert float(w.max()) / float(w.sum()) > 0.9
        close(w, jc.calc_eigen_modes_PCA(
            jnp.asarray(jfields.reshape(-1, bins, bins)))[0], 1e-10)
        close(tc.calc_degree_of_transverse_coherence_PCA(U),
              jc.calc_degree_of_transverse_coherence_PCA(
                  jnp.asarray(jfields.reshape(-1, bins, bins))), 1e-10)


KDE = dict(dtype=torch.float64, device='cpu')


def test_kde_matches_scipy_and_jax():
    from scipy.stats import gaussian_kde
    rng = np.random.default_rng(0)
    data = rng.normal(size=300)
    pts = np.linspace(-3, 3, 41)
    ours = GaussianKDE(data, **KDE)(pts).numpy()
    np.testing.assert_allclose(ours, gaussian_kde(data)(pts), rtol=1e-6)
    close(ours, JKDE(data)(pts), 1e-12)
    data2 = rng.normal(size=(2, 200))
    pts2 = rng.normal(size=(2, 30))
    ours2 = GaussianKDE(data2, bw_method='silverman', **KDE)(
        torch.from_numpy(pts2)).numpy()
    np.testing.assert_allclose(
        ours2, gaussian_kde(data2, bw_method='silverman')(pts2), rtol=1e-6)
    close(ours2, JKDE(data2, bw_method='silverman')(pts2), 1e-12)
    # points given as (m, d)
    np.testing.assert_allclose(
        GaussianKDE(data2, **KDE)(pts2.T).numpy(),
        GaussianKDE(data2, **KDE)(pts2).numpy(), rtol=1e-15)
    cb = GaussianKDE(data, bw_method=lambda k: 0.4, **KDE)
    close(cb(pts), JKDE(data, bw_method=lambda k: 0.4)(pts), 1e-12)
    with pytest.raises(ValueError):
        GaussianKDE(data, bw_method=[1, 2], **KDE)


def test_kde_weights_and_scalar_bandwidth():
    rng = np.random.default_rng(2)
    data = rng.normal(size=100)
    w = np.zeros(100)
    w[:60] = 1.0
    pts = np.linspace(-2, 2, 21)
    a = GaussianKDE(data, weights=w, **KDE)(pts).numpy()
    b = GaussianKDE(data[:60], **KDE)(pts).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6)
    close(a, JKDE(data, weights=w)(pts), 1e-12)
    data = np.random.default_rng(3).normal(size=500)
    pts = np.linspace(-8, 8, 801)
    pdf = GaussianKDE(data, bw_method=0.3, **KDE)(pts).numpy()
    assert abs(np.trapezoid(pdf, pts) - 1.0) < 1e-3
    f32 = GaussianKDE(data, bw_method=0.3, dtype=torch.float32,
                      device='cpu')(pts)
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), pdf, rtol=1e-4,
                               atol=1e-6 * pdf.max())
