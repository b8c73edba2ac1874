"""Plot specifications: XYCAxis and XYCPlot.

Host-side (static) descriptions of the accumulated histograms: the port's
own copy of the reference package's ``plotspec.py`` (numpy only).  The
histogramming runs on the device (:mod:`xrt_tpu_torch.histogram`) and the
runner accumulates into the numpy buffers held here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

# hue values of ray categories for caxis 'category' coloring
# (cf. reference raycing hueGood=3, hueOut=1.6, hueOver=1.2, hueDead=0.2
#  xrt/backends/raycing/__init__.py:255-264)
HUE_GOOD = 3.0
HUE_OUT = 1.6
HUE_OVER = 1.2
HUE_DEAD = 0.2

_UNIT_FACTORS = {
    'mm': 1.0, 'mkm': 1e3, 'um': 1e3, u'µm': 1e3, 'nm': 1e6, 'pm': 1e9,
    'rad': 1.0, 'mrad': 1e3, 'mkrad': 1e6, 'urad': 1e6, u'µrad': 1e6,
    'nrad': 1e9, 'eV': 1.0, 'keV': 1e-3, 'MeV': 1e-6, 'fs': 1.0, '': 1.0,
    None: 1.0,
}


def axis_factor(unit):
    return _UNIT_FACTORS.get(unit, 1.0)


@dataclasses.dataclass
class XYCAxis:
    """One axis of an XYCPlot: what to plot (``data`` — a beam-getter name
    like 'x', 'z', 'energy', "x'", "z'" or a callable(beam)->array), with
    which unit factor, how many bins and within which limits (None = auto
    from the first iteration, 'symmetric' = auto symmetric)."""
    label: str = ''
    unit: Optional[str] = 'mm'
    factor: Optional[float] = None
    data: Union[str, Callable] = 'auto'
    limits: Union[None, str, Sequence[float]] = None
    offset: float = 0.0
    bins: int = 128
    ppb: int = 2
    density: str = 'histogram'
    invertAxis: bool = False
    outline: float = 0.5
    extraMargin: int = 1
    fwhmFormatStr: str = '%.1f'

    def __post_init__(self):
        if self.factor is None:
            self.factor = axis_factor(self.unit)
        if self.data == 'auto':
            lbl = self.label
            if lbl in ('x', 'y', 'z', 'path'):
                self.data = lbl
            elif lbl in ("x'", "xprime"):
                self.data = 'xprime'
            elif lbl in ("z'", "zprime"):
                self.data = 'zprime'
            elif lbl.lower() in ('energy', 'e'):
                self.data = 'energy'
        self._limitsInit = self.limits if not isinstance(self.limits, list) \
            else list(self.limits)

    @property
    def binEdges(self):
        lo, hi = self.limits
        return np.linspace(lo, hi, self.bins + 1)

    @property
    def binCenters(self):
        e = self.binEdges
        return 0.5 * (e[:-1] + e[1:])


@dataclasses.dataclass
class XYCPlot:
    """Accumulated 1D+2D histograms of one beam, colored by hue (caxis) and
    brightness (flux).  Results live in numpy accumulators: total2D
    (ybins, xbins), total2D_RGB, total1D_x/y/c (+RGB), hist counters."""
    beam: str = ''
    xaxis: XYCAxis = None
    yaxis: XYCAxis = None
    caxis: Union[XYCAxis, str] = None
    fluxKind: str = 'total'
    rayFlag: Tuple[int, ...] = (1,)
    aspect: Union[str, float] = 'equal'
    title: str = ''
    colorFactor: float = 0.85
    colorSaturation: float = 1.0
    ePos: int = 1
    beamState: Optional[str] = None
    beamC: Optional[str] = None
    fluxFormatStr: str = 'auto'
    persistentName: Optional[str] = None
    saveName: Optional[str] = None

    def __post_init__(self):
        if self.xaxis is None:
            self.xaxis = XYCAxis('x', 'mm')
        if self.yaxis is None:
            self.yaxis = XYCAxis('z', 'mm')
        if self.caxis is None:
            self.caxis = XYCAxis('energy', 'eV', data='energy',
                                 fwhmFormatStr=None)
        elif isinstance(self.caxis, str):
            if self.caxis == 'category':
                ax = XYCAxis('category', '', data='category',
                             limits=[0.0, 4.0])
                ax.useCategory = True
                self.caxis = ax
            else:
                self.caxis = XYCAxis(self.caxis, 'eV', data='energy')
        if not hasattr(self.caxis, 'useCategory'):
            self.caxis.useCategory = self.caxis.data == 'category'
        if not self.title:
            self.title = self.beam
        self.reset()

    # ---- accumulators ----------------------------------------------------
    def reset(self):
        xb, yb, cb = self.xaxis.bins, self.yaxis.bins, self.caxis.bins
        self.total2D = np.zeros((yb, xb))
        self.total2D_RGB = np.zeros((yb, xb, 3))
        self.total1D_x = np.zeros(xb)
        self.total1D_x_RGB = np.zeros((xb, 3))
        self.total1D_y = np.zeros(yb)
        self.total1D_y_RGB = np.zeros((yb, 3))
        self.total1D_c = np.zeros(cb)
        self.total1D_c_RGB = np.zeros((cb, 3))
        self.intensity = 0.0
        self.nRaysAll = 0
        self.nRaysAlive = 0
        self.nRaysGood = 0
        self.nRaysOut = 0
        self.nRaysOver = 0
        self.nRaysDead = 0
        self.nRaysAccepted = 0.0
        self.nRaysAcceptedE = 0.0
        self.nRaysSeeded = 0.0
        self.nRaysSeededI = 0.0
        self.repeats = 0

    # ---- readouts (cf. plotter.py fwhm/center annotations) ---------------
    @staticmethod
    def _fwhm(centers, h):
        if h.max() <= 0:
            return 0.0
        half = h.max() / 2.0
        above = h >= half
        idx = np.where(above)[0]
        if len(idx) == 0:
            return 0.0
        return centers[idx[-1]] - centers[idx[0]]

    @staticmethod
    def _center(centers, h):
        s = h.sum()
        if s <= 0:
            return 0.0
        return float((centers * h).sum() / s)

    @property
    def dx(self):
        return self._fwhm(self.xaxis.binCenters, self.total1D_x)

    @property
    def dy(self):
        return self._fwhm(self.yaxis.binCenters, self.total1D_y)

    @property
    def dE(self):
        return self._fwhm(self.caxis.binCenters, self.total1D_c)

    @property
    def cx(self):
        return self._center(self.xaxis.binCenters, self.total1D_x)

    @property
    def cy(self):
        return self._center(self.yaxis.binCenters, self.total1D_y)

    @property
    def cE(self):
        return self._center(self.caxis.binCenters, self.total1D_c)

    @property
    def flux(self):
        """Absolute flux in ph/s, available when the source does Monte-Carlo
        flux bookkeeping (cf. plotter.py:1866)."""
        if self.nRaysSeeded > 0:
            return self.intensity / self.nRaysAll * \
                self.nRaysAccepted / self.nRaysSeeded
        return self.intensity

    @property
    def power(self):
        """Absorbed/transmitted power in W when fluxKind='power'."""
        return self.intensity / max(self.nRaysAll, 1)

    # ---- persistence (cf. plotter store/restore via runner.py:194-247) ---
    def store_plots(self, fileName=None):
        import pickle
        fileName = fileName or self.persistentName
        state = {k: getattr(self, k) for k in (
            'total2D', 'total2D_RGB', 'total1D_x', 'total1D_x_RGB',
            'total1D_y', 'total1D_y_RGB', 'total1D_c', 'total1D_c_RGB',
            'intensity', 'nRaysAll', 'nRaysAlive', 'nRaysGood', 'nRaysOut',
            'nRaysOver', 'nRaysDead', 'nRaysAccepted', 'nRaysAcceptedE',
            'nRaysSeeded', 'nRaysSeededI', 'repeats')}
        state['xlimits'] = self.xaxis.limits
        state['ylimits'] = self.yaxis.limits
        state['climits'] = self.caxis.limits
        with open(fileName, 'wb') as f:
            pickle.dump(state, f)

    def restore_plots(self, fileName=None):
        import pickle
        fileName = fileName or self.persistentName
        with open(fileName, 'rb') as f:
            state = pickle.load(f)
        self.xaxis.limits = state.pop('xlimits')
        self.yaxis.limits = state.pop('ylimits')
        self.caxis.limits = state.pop('climits')
        for k, v in state.items():
            setattr(self, k, v)
