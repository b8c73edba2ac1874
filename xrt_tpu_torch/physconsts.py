"""Physical constants used throughout xrt_tpu_torch.

A copy of the reference package's table (the port imports nothing of it).
Values follow CODATA and match the conventions of the reference xrt package
(xrt/backends/raycing/physconsts.py) so that golden-data comparisons agree to
full precision.  All plain Python floats.
"""

PI = 3.1415926535897932384626433832795
PI2 = 2.0 * PI
SQRT2PI = PI2 ** 0.5
SQ3 = 3.0 ** 0.5
SQ2 = 2.0 ** 0.5
SQPI = PI ** 0.5

SIE0 = 1.602176565e-19          # elementary charge [C]
C = 2.99792458e10               # speed of light [cm/s]
E0 = SIE0 * C / 10              # charge in CGS-ish units used by xrt
M0 = 9.109383701528e-28         # electron mass [g]
SIM0 = 9.109383701528e-31       # electron mass [kg]
M0C2 = 0.510998928              # electron rest energy [MeV]
HPLANCK = 6.626069573e-27       # Planck [erg*s]
EV2ERG = 1.602176565e-12        # eV -> erg
K2B = 2 * PI * M0 * C ** 2 * 0.001 / E0   # undulator K <-> B conversion
EMC = 0.5866791802416487        # e/(m c) [1/(T*mm)] style constant used by xrt
SIHPLANCK = 6.626069573e-34
SIC = C * 1e-2
FINE_STR = 1 / 137.03599976
E2W = 1519267514747457.9195337718065469   # omega = E2W * E[eV]
E2WC = 5067.7309392068091                 # omega/c in 1/mm per eV
R0 = 2.817940285e-5             # classical electron radius [A]
AVOGADRO = 6.02214199e23        # atoms/mol
CHeVcm = HPLANCK * C / EV2ERG   # c*h in eV*cm
CH = CHeVcm * 1e8               # c*h in eV*A  = 12398.419...
CHBAR = CH / PI2                # c*hbar in eV*A = 1973.27...
