"""Mechanical positioning stages: a tripod (Z, pitch, roll), one x stage
(a stripe's lateral shift) and two x stages (shift and yaw).

Port of the reference package's ``stages.py``.  The stages are host-side
calculators, as there: give them the wanted orientation and read the
motor positions (``set_jacks`` / ``set_x_stages``), or give them motor
positions and read the orientation back (``get_orientation``), then pass
it to ``OE.create`` (``oes.DCMOnTripodWithOneXStage``,
``oes.MirrorOnTripodWithTwoXStages``).  Plain Python floats: beamline
metrology, not ray tracing.
"""
from __future__ import annotations

import math


def _rot_z(x, y, cosA, sinA):
    return cosA * x - sinA * y, sinA * x + cosA * y


class Tripod:
    """Three-jack support setting Z, pitch and roll.

    *jack1..3* are [x, y, z] points in the global system with the optics
    horizontal; *center* is the OE center [x, y, z]; *height* is the nominal
    beamline height (for the calibration readouts); *azimuth* is the
    beamline azimuth.
    """

    def __init__(self, jack1, jack2, jack3, center, height=0.0, azimuth=0.0):
        if not (jack1[2] == jack2[2] == jack3[2]):
            raise ValueError('The mirror must be initially horizontal!')
        self.jack1 = list(jack1)
        self.jack2 = list(jack2)
        self.jack3 = list(jack3)
        self.center = list(center)
        self.cosAzimuth = math.cos(azimuth)
        self.sinAzimuth = math.sin(azimuth)
        centerMinusNominal = self.center[2] - height
        self.jack1Offset = centerMinusNominal - self.jack1[2]
        self.jack2Offset = centerMinusNominal - self.jack2[2]
        self.jack3Offset = centerMinusNominal - self.jack3[2]
        # the invariant distance from the jack-balls plane to the optical
        # plane, and jack xy in the local virgin system
        self.jackToMirrorInvariant = self.center[2] - self.jack1[2]
        self.jack1local = [j - c for j, c in zip(self.jack1, self.center)]
        self.jack2local = [j - c for j, c in zip(self.jack2, self.center)]
        self.jack3local = [j - c for j, c in zip(self.jack3, self.center)]
        for jl in (self.jack1local, self.jack2local, self.jack3local):
            jl[0], jl[1] = _rot_z(jl[0], jl[1],
                                  self.cosAzimuth, self.sinAzimuth)

    def set_jacks(self, pitch=0.0, roll=0.0, positionRoll=0.0):
        """The z of each jack for the centre, *pitch* and *roll*: updates
        the stored global jack z's and returns the calibrated readouts
        (jack1Calib, jack2Calib, jack3Calib)."""
        A, B, C = 0.0, 0.0, 1.0
        effPitch = pitch * math.cos(positionRoll)
        if roll != 0:
            cosRoll, sinRoll = math.cos(roll), math.sin(roll)
            A, C = cosRoll * A + sinRoll * C, -sinRoll * A + cosRoll * C
        if effPitch != 0:
            cosPitch, sinPitch = math.cos(effPitch), math.sin(effPitch)
            B, C = cosPitch * B - sinPitch * C, sinPitch * B + cosPitch * C
        # optical plane passes through the origin; shift to the balls plane
        D = -self.jackToMirrorInvariant
        for jl, j in zip(
                (self.jack1local, self.jack2local, self.jack3local),
                (self.jack1, self.jack2, self.jack3)):
            jl[2] = (D - A * jl[0] - B * jl[1]) / C
            j[2] = jl[2] + self.center[2]
        self.jack1Calib = self.jack1[2] + self.jack1Offset
        self.jack2Calib = self.jack2[2] + self.jack2Offset
        self.jack3Calib = self.jack3[2] + self.jack3Offset
        return self.jack1Calib, self.jack2Calib, self.jack3Calib

    def get_orientation(self, positionRoll=0.0):
        """Finds (pitch, roll, center z) given the jack z's."""
        j1, j2, j3 = self.jack1, self.jack2, self.jack3
        A = (j2[1]-j1[1])*(j3[2]-j1[2]) - (j3[1]-j1[1])*(j2[2]-j1[2])
        B = (j3[0]-j1[0])*(j2[2]-j1[2]) - (j2[0]-j1[0])*(j3[2]-j1[2])
        C = (j2[0]-j1[0])*(j3[1]-j1[1]) - (j3[0]-j1[0])*(j2[1]-j1[1])
        ABCNorm = (A**2 + B**2 + C**2) ** 0.5
        if C < 0:      # keep the normal looking upwards
            ABCNorm *= -1
        A, B, C = A / ABCNorm, B / ABCNorm, C / ABCNorm
        D = A * j1[0] + B * j1[1] + C * j1[2]   # balls plane
        D += self.jackToMirrorInvariant         # optical plane
        self.center[2] = (D - A*self.center[0] - B*self.center[1]) / C
        locA, locB = _rot_z(A, B, self.cosAzimuth, self.sinAzimuth)
        roll = math.atan(locA / C)
        tanPitch = -locB / (locA * math.sin(roll) + C * math.cos(roll))
        pitch = math.atan(tanPitch) * math.cos(positionRoll)
        return pitch, roll, self.center[2]


class OneXStage:
    """A single X-stage providing a lateral shift, used to select one of
    several optical stripes on a mirror."""

    def __init__(self, dx=0.0, surface=None, limOptX=None, limPhysX=None):
        self.dx = dx
        self.surface = surface
        self.limOptX = limOptX
        self.limPhysX = limPhysX
        self.curSurface = 0

    def select_surface(self, surfaceName):
        """Finds the dx offset that centers the requested stripe."""
        if self.surface is None:
            return self.dx
        self.curSurface = list(self.surface).index(surfaceName)
        cs = self.curSurface
        lim = self.limPhysX if self.limOptX is None else self.limOptX
        self.dx = -(lim[0][cs] + lim[1][cs]) * 0.5
        return self.dx


class TwoXStages(OneXStage):
    """Two X-stages setting lateral shift and yaw.
    *tx1, tx2* are [x, y] points (lists) in the local system at different
    y's."""

    def __init__(self, tx1, tx2, dx=0.0, **kwargs):
        if tx2[1] == tx1[1]:
            raise ValueError("tx1 and tx2 stages must be at different y's!")
        self.tx1 = list(tx1)
        self.tx2 = list(tx2)
        OneXStage.__init__(self, dx=dx, **kwargs)

    def set_x_stages(self, yaw=0.0, positionRoll=0.0):
        """The x of each stage for the shift ``dx`` and *yaw*: (tx1 x,
        tx2 x)."""
        tanYaw = math.tan(yaw)
        self.tx1[0] = -tanYaw * self.tx1[1] + self.dx
        self.tx2[0] = -tanYaw * self.tx2[1] + self.dx
        if positionRoll != 0:
            self.tx1[0] *= math.cos(positionRoll)
            self.tx2[0] *= math.cos(positionRoll)
        return self.tx1[0], self.tx2[0]

    def select_surface(self, surfaceName, yaw=0.0, positionRoll=0.0):
        OneXStage.select_surface(self, surfaceName)
        return self.set_x_stages(yaw, positionRoll)

    def get_orientation(self, positionRoll=0.0):
        """Finds (dx, yaw) given the stage x's."""
        tx10, tx20 = self.tx1[0], self.tx2[0]
        if positionRoll != 0:
            tx10 *= math.cos(positionRoll)
            tx20 *= math.cos(positionRoll)
        dy = self.tx2[1] - self.tx1[1]
        self.dx = tx10 - (tx20 - tx10) * self.tx1[1] / dy
        yaw = -math.atan((tx20 - tx10) / dy)
        return self.dx, yaw
