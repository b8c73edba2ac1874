"""und.integral_roofline: the least time of the traced passes' radiation
integrals over their device time (``und.integral_ms``), in %.

The least time is the operations over the card's float32 peak
(``peaks.PEAK_F32_OPS``): the program's counter ``integral.node_evals``
(rays x nodes of nonzero weight x copies of the node grid, each pass)
times :data:`OPS_PER_NODE`.  The bytes (the ray's energy and two angles
read, two complex amplitudes written: ~40 B a ray against ~3e4
operations a ray at 804 nodes) bound it ~40x lower, and are left out.

:data:`OPS_PER_NODE` is counted from the far-field formula of a planar
undulator (xrt's ``Undulator._build_I_map``, K_x = 0), not from any
implementation: per (ray, node), with every term of the ray alone or of
the node alone (sin z, cos z, cos^2 z, sin 2z, the weight) computed once
and not counted, an FMA as 2 operations, a sine, a cosine or a division
as 1:

=========================================================  ===
phase  w1 z + c1 sin z + c2 sin 2z                           5
cos, sin of the phase                                         2
beta_x = (K / gamma) cos z                                    1
b_x = theta - beta_x                                          1
B1m = c3 + c4 cos^2 z                                         2
1 - n.beta = c5 + 0.5 b_x^2 - A1m B1m                         5
weight f = w_node / (1 - n.beta)^2                            2
b_z = B1m - A1m                                               1
n.beta' = c6 sin z + c7 sin 2z                                3
n.(n - beta) = theta b_x + psi^2 + dir_z b_z                  4
s integrand  b_x n.beta' - beta'_x n.(n - beta)               3
p integrand  psi n.beta'                                      1
f s, f p                                                      2
Bs, Bp += (f s, f p) (cos + i sin)                            8
=========================================================  ===
total                                                        40

Zero-weight padding nodes are not counted.  So the share reads the same
work whatever computes the integral, and no implementation of the
formula can read above 100%.
"""
import peaks
from program_records import counter_sums, span_ms

#: float32 operations of one (ray, node) evaluation of the far-field
#: integral (the table above)
OPS_PER_NODE = 40


def bound_ms(node_evals):
    """The least ms of *node_evals* evaluations on one card."""
    return 1e3 * node_evals * OPS_PER_NODE / peaks.PEAK_F32_OPS


def read(run):
    got = counter_sums('integral.node_evals')
    ms = span_ms('sources.integrate')
    if got is None or got[0][0] is None or not ms:
        return None
    (evals,), npass = got
    return 100.0 * bound_ms(evals / npass) / ms
