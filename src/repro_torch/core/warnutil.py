"""Warnings that point at the *user's* code, not the library's.

A fixed ``warnings.warn(..., stacklevel=N)`` is right for one call depth
only. :func:`warn_external` computes the stacklevel at call time by walking
the stack past every frame that lives inside the ``repro_torch`` package,
so the warning lands on the first caller outside it.
"""

from __future__ import annotations

import os
import sys
import warnings

__all__ = ["warn_external"]

#: Absolute directory of the ``repro_torch`` package (``src/repro_torch``).
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def warn_external(message: str, category: type = UserWarning) -> None:
    """``warnings.warn`` attributed to the first caller frame outside
    ``repro_torch``."""
    level = 1                    # stacklevel=1 == this function's frame
    frame = sys._getframe(0)
    while frame is not None and os.path.abspath(
            frame.f_code.co_filename).startswith(_PKG_DIR + os.sep):
        frame = frame.f_back
        level += 1
    warnings.warn(message, category, stacklevel=level)
