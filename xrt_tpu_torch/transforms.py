"""Coordinate rotations and global<->local frame transforms.

Port of ``xrt_tpu/transforms.py``.  The coordinate conventions are those of
xrt raycing: y is along the beam, z is up, x makes a right-handed system;
*pitch* is rotation about x, *roll* about y, *yaw* about z.  A leading '-'
in *rotationSequence* reverses the sequence.  Angles may be Python numbers
or tensors.
"""
from __future__ import annotations

import math

import torch


def cos(v):
    return torch.cos(v) if isinstance(v, torch.Tensor) else math.cos(v)


def sin(v):
    return torch.sin(v) if isinstance(v, torch.Tensor) else math.sin(v)


def rotate_x(y, z, cosangle, sinangle):
    """Rotation about x (pitch); returns (yNew, zNew)."""
    return cosangle * y - sinangle * z, sinangle * y + cosangle * z


def rotate_y(x, z, cosangle, sinangle):
    """Rotation about y (roll); returns (xNew, zNew)."""
    return cosangle * x + sinangle * z, -sinangle * x + cosangle * z


def rotate_z(x, y, cosangle, sinangle):
    """Rotation about z (yaw); returns (xNew, yNew)."""
    return cosangle * x - sinangle * y, sinangle * x + cosangle * y


def _seq_letters(rotationSequence: str):
    if rotationSequence[0] == '-':
        return (rotationSequence[6], rotationSequence[4], rotationSequence[2])
    return (rotationSequence[1], rotationSequence[3], rotationSequence[5])


def rotate_xyz(x, y, z, rotationSequence='RzRyRx', pitch=0., roll=0., yaw=0.):
    """Rotate vectors (x, y, z) by pitch/roll/yaw in the given sequence;
    returns new (x, y, z)."""
    angles = {'z': yaw, 'y': roll, 'x': pitch}
    for s in _seq_letters(rotationSequence):
        angle = angles[s]
        cA = cos(angle)
        sA = sin(angle)
        if s == 'x':
            y, z = rotate_x(y, z, cA, sA)
        elif s == 'y':
            x, z = rotate_y(x, z, cA, sA)
        else:
            x, y = rotate_z(x, y, cA, sA)
    return x, y, z


def rotate_point(point, rotationSequence='RzRyRx', pitch=0., roll=0.,
                 yaw=0.):
    """A point (x, y, z) rotated as :func:`rotate_xyz`; returns a list."""
    return list(rotate_xyz(point[0], point[1], point[2], rotationSequence,
                           pitch, roll, yaw))


def rotate_beam(beam, rotationSequence='RzRyRx', pitch=0., roll=0., yaw=0.):
    """Rotate the position and direction tensors of a Beam; returns a
    new Beam."""
    x, y, z = rotate_xyz(beam.x, beam.y, beam.z, rotationSequence,
                         pitch, roll, yaw)
    a, b, c = rotate_xyz(beam.a, beam.b, beam.c, rotationSequence,
                         pitch, roll, yaw)
    return beam.replace(x=x, y=y, z=z, a=a, b=b, c=c)


def _turned(sinAzimuth):
    return not (isinstance(sinAzimuth, float) and sinAzimuth == 0.0)


def global_to_virgin_local(beam, center=None, sinAzimuth=0.0,
                           cosAzimuth=1.0):
    """Global frame -> virgin-local frame of an element at *center* in a
    beamline of the given azimuth (cf. beamline.py:52-87)."""
    x, y, z, a, b = beam.x, beam.y, beam.z, beam.a, beam.b
    if center is not None:
        x, y, z = x - center[0], y - center[1], z - center[2]
    if _turned(sinAzimuth):
        x, y = rotate_z(x, y, cosAzimuth, sinAzimuth)
        a, b = rotate_z(a, b, cosAzimuth, sinAzimuth)
    elif center is None:
        return beam
    return beam.replace(x=x, y=y, z=z, a=a, b=b)


def virgin_local_to_global(beam, center=None, sinAzimuth=0.0,
                           cosAzimuth=1.0, skip_xyz=False, skip_abc=False):
    """Inverse of :func:`global_to_virgin_local` (cf. beamline.py:89-117);
    *skip_xyz* / *skip_abc* leave the positions / directions."""
    updates = {}
    x, y, z = beam.x, beam.y, beam.z
    if _turned(sinAzimuth):
        if not skip_abc:
            a, b = rotate_z(beam.a, beam.b, cosAzimuth, -sinAzimuth)
            updates.update(a=a, b=b)
        if not skip_xyz:
            x, y = rotate_z(x, y, cosAzimuth, -sinAzimuth)
    if center is not None and not skip_xyz:
        x, y, z = x + center[0], y + center[1], z + center[2]
    if not skip_xyz:
        updates.update(x=x, y=y, z=z)
    return beam.replace(**updates) if updates else beam


def to_local_frame(beam, center, ex, ey, ez):
    """Position and direction (x, y, z, a, b, c) of *beam* in the frame
    with unit axes (ex, ey, ez) at *center*, as screens and apertures
    hold it."""
    dx = beam.x - center[0]
    dy = beam.y - center[1]
    dz = beam.z - center[2]
    return (dx * ex[0] + dy * ex[1] + dz * ex[2],
            dx * ey[0] + dy * ey[1] + dz * ey[2],
            dx * ez[0] + dy * ez[1] + dz * ez[2],
            beam.a * ex[0] + beam.b * ex[1] + beam.c * ex[2],
            beam.a * ey[0] + beam.b * ey[1] + beam.c * ey[2],
            beam.a * ez[0] + beam.b * ez[1] + beam.c * ez[2])
