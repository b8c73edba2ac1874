"""Rendering of accumulated XYCPlot histograms.

Port of the reference package's ``plotting.py`` (numpy and matplotlib on
the host: the histograms are host arrays once accumulated), equivalent in
capability to the display layer of the reference
xrt/plotter.py (plot_plots:1873, plot_hist1d:1525, plot_hist2d:1739,
save:1996): the hue+brightness 2D image with side 1D profiles, a
hue-colored caxis histogram strip, FWHM bars, 'kde'-density profiles and
the flux/size readouts, saved to PNG/PDF/SVG via matplotlib (headless
Agg backend).  Eigenmode galleries via :func:`save_modes_plot`
(cf. reference coherence.py:307 plot_eigen_modes).
"""
from __future__ import annotations

import numpy as np
import torch


def rgb_image(plot, saturation='auto'):
    """The (ybins, xbins, 3) displayable RGB image of a plot: accumulated
    RGB weights normalized by their maximum brightness channel (or by the
    shared ``globalMax2D_RGB`` set by
    :func:`~xrt_tpu_torch.runner.normalize_sibling_plots`)."""
    img = np.asarray(plot.total2D_RGB, float)
    mx = getattr(plot, 'globalMax2D_RGB', None) or img.max()
    if mx > 0:
        img = img / mx
    return np.clip(img, 0.0, 1.0)


def _profile(axis, hist):
    """(centers, curve) of a 1D profile honoring axis.density: 'histogram'
    returns the raw histogram, 'kde' a weighted Gaussian KDE evaluated on
    the bin grid (reference plotter.py density='kde', via the port's
    :mod:`~xrt_tpu_torch.kde` on the CPU)."""
    centers = axis.binCenters
    h = np.asarray(hist, float)
    if getattr(axis, 'density', 'histogram') == 'kde' and h.sum() > 0:
        from .kde import Gaussian_kde
        k = Gaussian_kde(centers, weights=h, dtype=torch.float64,
                         device='cpu')
        return centers, k.evaluate(centers).numpy() * h.sum() * \
            (centers[1] - centers[0])
    return centers, h


def _fwhm_bar(ax, centers, h, vertical=False, color='0.3'):
    """Draw the FWHM bar at half maximum (reference plot_hist1d
    annotation)."""
    if h.max() <= 0:
        return
    half = h.max() / 2
    above = np.where(h >= half)[0]
    if len(above) < 2:
        return
    lo, hi = centers[above[0]], centers[above[-1]]
    if vertical:
        ax.plot([half / h.max(), half / h.max()], [lo, hi], '-',
                color=color, lw=1)
    else:
        ax.plot([lo, hi], [half / h.max(), half / h.max()], '-',
                color=color, lw=1)


def save_plot(plot, fileName, dpi=100, title=None, backend='Agg'):
    """Render the accumulated histograms of *plot* to an image file
    (cf. reference XYCPlot.save, plotter.py:1996): central
    hue+brightness map, top/right 1D profiles with FWHM bars, the
    hue-colored color-axis strip, and the numeric readouts."""
    import matplotlib
    matplotlib.use(backend, force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8.0, 7.2))
    # layout similar to the reference: central 2D map + top/right 1D +
    # far-right caxis strip
    axC = fig.add_axes([0.10, 0.09, 0.56, 0.60])
    axX = fig.add_axes([0.10, 0.71, 0.56, 0.17], sharex=axC)
    axY = fig.add_axes([0.68, 0.09, 0.13, 0.60], sharey=axC)
    axE = fig.add_axes([0.86, 0.09, 0.10, 0.60])

    xlim = plot.xaxis.limits
    ylim = plot.yaxis.limits
    img = rgb_image(plot)
    axC.imshow(img, origin='lower', aspect='auto',
               extent=[xlim[0], xlim[1], ylim[0], ylim[1]])
    axC.set_xlabel(f'{plot.xaxis.label} ({plot.xaxis.unit})')
    axC.set_ylabel(f'{plot.yaxis.label} ({plot.yaxis.unit})')

    def draw_1d(ax, axis, hist, rgb, vertical=False):
        centers, h = _profile(axis, hist)
        hmax = max(h.max(), 1e-300)
        colors = np.asarray(rgb, float)
        if colors.max() > 0:
            colors = colors / colors.max()
        colors = np.clip(colors, 0, 1)
        step = centers[1] - centers[0] if len(centers) > 1 else 1.0
        if vertical:
            ax.barh(centers, h / hmax, height=step, color=colors)
        else:
            ax.bar(centers, h / hmax, width=step, color=colors)
        if getattr(axis, 'density', '') == 'kde':
            if vertical:
                ax.plot(h / hmax, centers, '-', color='0.2', lw=1)
            else:
                ax.plot(centers, h / hmax, '-', color='0.2', lw=1)
        _fwhm_bar(ax, centers, h, vertical=vertical)

    draw_1d(axX, plot.xaxis, plot.total1D_x, plot.total1D_x_RGB)
    axX.set_xlim(*xlim)
    axX.tick_params(labelbottom=False)
    draw_1d(axY, plot.yaxis, plot.total1D_y, plot.total1D_y_RGB,
            vertical=True)
    axY.set_ylim(*ylim)
    axY.tick_params(labelleft=False)

    # color-axis histogram strip (reference's vertical caxis histogram)
    clim = plot.caxis.limits
    draw_1d(axE, plot.caxis, plot.total1D_c, plot.total1D_c_RGB,
            vertical=True)
    axE.set_ylim(*clim)
    axE.yaxis.tick_right()
    axE.yaxis.set_label_position('right')
    axE.set_ylabel(f'{plot.caxis.label} ({plot.caxis.unit})')
    axE.tick_params(labelsize=7)
    axE.set_xticks([])

    txt = (f'dx = {plot.dx:.4g}   dz = {plot.dy:.4g}\n'
           f'cx = {plot.cx:.4g}   cz = {plot.cy:.4g}\n'
           f'dE = {plot.dE:.4g}   cE = {plot.cE:.4g}\n'
           f'flux = {plot.flux:.4g}\n'
           f'rays: good {plot.nRaysGood} / all {plot.nRaysAll}')
    fig.text(0.68, 0.87, txt, fontsize=8, va='top', family='monospace')
    fig.suptitle(title or plot.title)
    fig.savefig(fileName, dpi=dpi)
    plt.close(fig)
    return fileName


def save_modes_plot(w, modes, shape, fileName, nmax=4, dpi=100,
                    backend='Agg'):
    """Gallery of coherent eigenmodes (cf. reference coherence.py:307):
    *w* eigenvalues (ascending, as returned by calc_eigen_modes_*),
    *modes* (npoints, nmodes) complex mode fields, *shape* = (ny, nx) of
    the sampling grid."""
    import matplotlib
    matplotlib.use(backend, force=False)
    import matplotlib.pyplot as plt

    w = np.asarray(w, float)
    modes = np.asarray(modes)
    n = min(nmax, modes.shape[1])
    wtot = max(w.sum(), 1e-300)
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 3.2))
    if n == 1:
        axes = [axes]
    for i in range(n):
        j = modes.shape[1] - 1 - i        # descending eigenvalue order
        I = np.abs(modes[:, j]) ** 2
        axes[i].imshow(I.reshape(shape), origin='lower', aspect='auto',
                       cmap='inferno')
        axes[i].set_title(f'mode {i}: {w[::-1][i] / wtot:.1%}',
                          fontsize=9)
        axes[i].set_xticks([])
        axes[i].set_yticks([])
    fig.tight_layout()
    fig.savefig(fileName, dpi=dpi)
    plt.close(fig)
    return fileName
