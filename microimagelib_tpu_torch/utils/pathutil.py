"""Path helpers mirroring the reference's tiny utilities
(reference:src/apifunc.cpp:53-89): ``concat`` (varargs path join) and
``fexists`` (file existence)."""

from __future__ import annotations

import os


def concat(*parts):
    """Plain string concatenation, as the reference's varargs concat."""
    return "".join(str(p) for p in parts)


def fexists(path):
    return os.path.isfile(path)
