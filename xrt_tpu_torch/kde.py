"""Weighted Gaussian kernel density estimation.

Port of the reference package's ``kde.py`` (``GaussianKDE``, a weighted
variant of ``scipy.stats.gaussian_kde``): the Scott or Silverman bandwidth
with Kish's effective sample size and the weighted covariance are host
float64 numpy, made once; :meth:`GaussianKDE.evaluate` runs on tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from . import config


class GaussianKDE:
    """Weighted Gaussian KDE over a 1-D or (d, n) dataset.  *dtype* and
    *device* are those of the densities :meth:`evaluate` returns."""

    def __init__(self, dataset, bw_method=None, weights=None, dtype=None,
                 device=None):
        ds = np.atleast_2d(np.asarray(dataset, float))
        if ds.shape[0] > ds.shape[1]:
            ds = ds.T if ds.ndim == 2 and ds.shape[1] in (1, 2, 3) else ds
        self.dataset = ds
        self.d, self.n = self.dataset.shape
        if weights is not None:
            w = np.asarray(weights, float)
            self.weights = w / w.sum()
        else:
            self.weights = np.full(self.n, 1.0 / self.n)
        # Kish effective sample size
        self.neff = 1.0 / np.sum(self.weights ** 2)
        self.dtype, self.device = dtype, device
        self.set_bandwidth(bw_method)

    def scotts_factor(self):
        return self.neff ** (-1.0 / (self.d + 4))

    def silverman_factor(self):
        return (self.neff * (self.d + 2) / 4.0) ** (-1.0 / (self.d + 4))

    covariance_factor = scotts_factor

    def set_bandwidth(self, bw_method=None):
        if bw_method is None or bw_method == 'scott':
            self.covariance_factor = self.scotts_factor
        elif bw_method == 'silverman':
            self.covariance_factor = self.silverman_factor
        elif np.isscalar(bw_method):
            self._bw = bw_method
            self.covariance_factor = lambda: self._bw
        elif callable(bw_method):
            self.covariance_factor = lambda: bw_method(self)
        else:
            raise ValueError("bw_method should be 'scott', 'silverman', a "
                             'scalar or a callable')
        self._compute_covariance()

    def _compute_covariance(self):
        self.factor = self.covariance_factor()
        mean = np.sum(self.weights * self.dataset, axis=1)
        resid = self.dataset - mean[:, None]
        cov = np.einsum('in,jn,n->ij', resid, resid, self.weights)
        cov /= 1.0 - np.sum(self.weights ** 2)
        self.covariance = cov * self.factor ** 2
        self.inv_cov = np.linalg.inv(self.covariance)
        self._norm_factor = np.sqrt(
            np.linalg.det(2 * np.pi * self.covariance))

    def evaluate(self, points):
        """The density at *points* ((d, m), (m, d) or 1-D), a tensor of
        the estimator's dtype on its device."""
        dt = config.resolve_dtype(self.dtype)
        dev = config.resolve_device(self.device)

        def T(v):
            return torch.as_tensor(np.asarray(v, float), dtype=dt,
                                   device=dev)
        pts = torch.atleast_2d(points.to(dtype=dt, device=dev)
                               if isinstance(points, torch.Tensor)
                               else T(points))
        if pts.shape[0] != self.d:
            pts = pts.T
        data = T(self.dataset)                          # (d, n)
        diff = data[:, None, :] - pts[:, :, None]       # (d, m, n)
        tdiff = torch.einsum('ij,jmn->imn', T(self.inv_cov), diff)
        energy = torch.sum(diff * tdiff, dim=0) / 2.0
        return torch.sum(T(self.weights)[None, :] * torch.exp(-energy),
                         dim=1) / self._norm_factor

    __call__ = evaluate
    pdf = evaluate


Gaussian_kde = GaussianKDE
