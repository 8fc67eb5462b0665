"""Debug hooks.

A copy of ``iterated_learning_for_vlm_tpu/utils/debug.py`` (reference
``prototype/solver/crash_on_ipy.py``): drop into a debugger on uncaught
exceptions. Uses pdb; activate with ``install_crash_handler()`` (the
launcher's ``--debug``) or ``ILVLM_DEBUG=1``.
"""
from __future__ import annotations

import os
import pdb
import sys
import traceback


def _hook(exc_type, value, tb):
    if hasattr(sys, "ps1") or not sys.stderr.isatty():
        sys.__excepthook__(exc_type, value, tb)
    else:
        traceback.print_exception(exc_type, value, tb)
        pdb.post_mortem(tb)


def install_crash_handler():
    sys.excepthook = _hook


if os.environ.get("ILVLM_DEBUG"):
    install_crash_handler()
