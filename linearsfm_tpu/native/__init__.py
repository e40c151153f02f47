"""Native (C) runtime components, compiled from source on demand with a
Python fallback.

Currently: `fastparse` — the local-map text reader hot path. The extension
is built from fastparse.c into this package directory at first use (never
committed); a failed build logs a warning and the pure-Python tokenizer in
io/localmap.py takes over.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sysconfig

log = logging.getLogger("linearsfm_tpu")

_HERE = os.path.dirname(os.path.abspath(__file__))


def _build() -> bool:
    import numpy as np
    src = os.path.join(_HERE, "fastparse.c")
    out = os.path.join(_HERE, f"fastparse{sysconfig.get_config_var('EXT_SUFFIX') or '.so'}")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return True
    inc_py = sysconfig.get_paths()["include"]
    inc_np = np.get_include()
    # Build to a per-process name and rename into place, so concurrent
    # processes never load a half-written library.
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["gcc", "-O2", "-shared", "-fPIC", src, f"-I{inc_py}", f"-I{inc_np}",
           "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("fastparse build failed (%s); using the Python reader", e)
        return False
    if r.returncode != 0:
        log.warning("fastparse build failed; using the Python reader: %s",
                    r.stderr.decode()[-400:])
        return False
    os.replace(tmp, out)
    return True


_fastparse = None
_tried = False


def get_fastparse():
    """The compiled module, or None if unavailable."""
    global _fastparse, _tried
    if _tried:
        return _fastparse
    _tried = True
    if _build():
        try:
            from . import fastparse  # type: ignore
            _fastparse = fastparse
        except ImportError as e:
            log.warning("fastparse failed to load (%s); using the Python "
                        "reader", e)
    return _fastparse
