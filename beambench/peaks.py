"""The yardstick's constants: the card's published peaks and the work of
each hand-written kernel counted from its shape.

``PEAK_F32_OPS``, ``PEAK_BYTES``, ``OPS_PER_PAIR``, ``KEYS`` and
``bound_ms`` are frozen copies of ``chip_smoke.py`` at commit f123111
(where each pair's operations are counted term by term from the kernel
sources), so that the yardstick stays fixed when that file changes.
"""

#: published peaks of one H100 SXM at its 700 W limit (dense, non-tensor
#: float32; HBM3 bandwidth)
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

#: f32 operations per (destination, source) pair of the forward Kirchhoff
#: kernels: B1 ('kirchhoff_recentred') and B2 ('kirchhoff_ddphase'), by the
#: name under which ``xrt_tpu_torch.ops.kirchhoff.LAUNCHES`` counts them
OPS_PER_PAIR = {'kirchhoff_recentred:mono': 116,
                'kirchhoff_ddphase:fast': 160,
                'kirchhoff_ddphase:exact': 183,
                'kirchhoff_recentred_bwd:mono': 259,
                'kirchhoff_ddphase_bwd:fast': 281,
                'kirchhoff_ddphase_bwd:exact': 307}
#: f32 keys read per destination and per source, and outputs written per
#: destination, of the forward kernels
KEYS = (6, 20, 10)


def bound_ms(name, nd, ns):
    """(least ms, 'operations' or 'bytes') of one launch of kernel *name*
    over *nd* destinations and *ns* sources: the larger of its operations
    over the float32 peak and its bytes (inputs read once, outputs written
    once) over the memory bandwidth."""
    kd, ks, ko = KEYS
    t_ops = OPS_PER_PAIR[name] * nd * ns / PEAK_F32_OPS
    if '_bwd' in name:      # reads D, S and G, writes the cotangents of D, S
        t_bytes = 4.0 * (2 * kd * nd + 2 * ks * ns + ko * nd) / PEAK_BYTES
    else:
        t_bytes = 4.0 * (kd * nd + ks * ns + ko * nd) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def hist_plot_bytes(nrays, xbins, ybins, cbins, itemsize=4):
    """Bytes of one ``hist_plot`` launch (B4): the five ray columns (x, y,
    colour, flux, 2D weight) and the bool mask read once, the eight
    histograms and the total written once."""
    nb = xbins + ybins + cbins + xbins * ybins
    return nrays * (5 * itemsize + 1) + (4 * nb + 1) * itemsize


def hist_plot_bound_ms(nrays, xbins, ybins, cbins, itemsize=4):
    """The least ms of one ``hist_plot`` launch: its bytes over the memory
    bandwidth (a few operations a ray: the kernel is bound by bytes)."""
    return 1e3 * hist_plot_bytes(nrays, xbins, ybins, cbins, itemsize) / \
        PEAK_BYTES
