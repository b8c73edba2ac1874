"""Console diagnostics: colorized prints and the verbosity gate.

The port's own copy of the reference package's ``singletons.py`` (the
reference xrt's singletons.py:1-42), ANSI-escape based so it needs no
colorama dependency."""
from __future__ import annotations

import os
import sys

#: [0-100] regulates the level of diagnostics printout (reference
#: _VERBOSITY_; change at runtime or via XRT_TPU_VERBOSITY)
_VERBOSITY_ = int(os.environ.get('XRT_TPU_VERBOSITY', 10))

colors = ('BLACK', 'RED', 'GREEN', 'YELLOW', 'BLUE', 'MAGENTA', 'CYAN',
          'WHITE', 'RESET')
_FORE = {c: f'\033[{30 + i}m' for i, c in enumerate(colors[:-1])}
_FORE['RESET'] = '\033[39m'
_BACK = {c: f'\033[{40 + i}m' for i, c in enumerate(colors[:-1])}
_BACK['RESET'] = '\033[49m'


def _want_color(stream):
    return hasattr(stream, 'isatty') and stream.isatty() and \
        os.environ.get('NO_COLOR') is None


def colorPrint(s, fcolor=None, bcolor=None, verbosity=0, stream=None):
    """Colorized print, gated by ``_VERBOSITY_`` (message prints when
    *verbosity* <= the global level); colors degrade to plain text on
    non-tty streams."""
    if verbosity > _VERBOSITY_:
        return
    stream = stream or sys.stdout
    if _want_color(stream):
        style = _FORE.get(fcolor, _FORE['RESET']) + \
            _BACK.get(bcolor, _BACK['RESET'])
        print(f'{style}{s}\033[0m', file=stream)
    else:
        print(s, file=stream)


def is_sequence(arg):
    """True for list/tuple/array-like, False for strings/bytes/scalars
    (reference singletons.py:31-42)."""
    if isinstance(arg, (str, bytes)):
        return False
    if not (hasattr(arg, '__getitem__') or hasattr(arg, '__iter__')):
        return False
    try:
        len(arg)
    except TypeError:
        return False
    return True
