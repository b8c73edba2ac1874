"""nf.integral_roofline: the least time of the traced passes' near-field
radiation integrals over their device time (the program's
``sources.integrate`` spans, as ``und.integral_ms`` reads them), in %.

The least time is the operations over the card's float64 peak
(:data:`PEAK_F64_OPS`): the program's counter ``integral.near_evals``
(rays x nodes of nonzero weight x Np periods, each near-field call of a
pass) times :data:`OPS_PER_NEAR_NODE`.  The bytes (the ray's energy and
two angles read, two complex amplitudes written: ~56 B a ray against
~8.5e5 operations a ray at 111 x 128 nodes) bound it far lower, and are
left out.  None where the program counts no ``integral.near_evals``.

:data:`OPS_PER_NEAR_NODE` is counted from the near-field formula of a
planar undulator (xrt's ``Undulator._build_I_map`` with R0, K_x = 0), not
from any implementation: per (ray, node), with every term of the ray
alone (1 / gamma and its square, w / wu, R0 tan theta, R0 tan psi and its
square, the carrier phase, which turns the ray's sum once) or of the node
alone (sin z, cos z, sin 2z, the weight, the node's place in its period)
computed once and not counted, an FMA as 2 operations, a sine, a cosine,
a square root or a division as 1, and every product reused once made:

======================================================================  ===
drx = R0x - (K sin z) rg                                                  2
p1 = 0.25 zterm rg = (K^2 sin 2z / 8) rg^2                                1
drz = R0n - (betam zloc - p1)                                             3
s2 = drx^2 + dry^2                                                        2
dist = sqrt(s2 + drz^2)                                                   3
drs = 0.5 s2 / drz                                                        2
phase = w/wu zloc (1 - betam) + w/wu (drs + p1)                           4
cos, sin of the phase                                                     2
beta_x = (K cos z) rg                                                     1
B1m = 0.5 rg^2 + (0.5 K^2 cos^2 z) rg^2                                   2
beta'_z = (0.5 K^2 sin 2z) rg                                             1
t2 = s2 / (dist (dist + drz))                                             3
n = dr / dist (three components)                                          3
1 - n.beta = B1m (1 - t2) + t2 - n_x beta_x                               5
weight f = w_node / (1 - n.beta)^2                                        2
b_x = n_x - beta_x, b_z = B1m - t2                                        2
n.beta' = n_x beta'_x + n_z beta'_z                                       3
n.(n - beta) = n_x b_x + n_y n_y + n_z b_z                                5
s integrand  b_x n.beta' - beta'_x n.(n - beta)                           3
p integrand  n_y n.beta'                                                  1
f s, f p                                                                  2
Bs, Bp += (f s, f p) (cos + i sin)                                        8
======================================================================  ===
total                                                                    60

Zero-weight padding nodes are not counted.  So the share reads the same
work whatever computes the integral, and no implementation of the
formula can read above 100%.
"""
from program_records import counter_sums, span_ms

#: float64 operations of one (ray, node) evaluation of the near-field
#: integral (the table above)
OPS_PER_NEAR_NODE = 60
#: the published dense float64 peak of one H100 SXM without tensor cores
#: (FLOP/s); ``peaks.py`` holds the float32 one
PEAK_F64_OPS = 33.5e12


def bound_ms(near_evals):
    """The least ms of *near_evals* evaluations on one card."""
    return 1e3 * near_evals * OPS_PER_NEAR_NODE / PEAK_F64_OPS


def read(run):
    got = counter_sums('integral.near_evals')
    ms = span_ms('sources.integrate')
    if got is None or got[0][0] is None or not ms:
        return None
    (evals,), npass = got
    return 100.0 * bound_ms(evals / npass) / ms
