"""Host syncs as torch's sync debug mode reports them.

Frozen copy of ``count_syncs_by_source`` in ``chip_smoke.py`` at commit
6cc9e90, as a context manager: every "synchroniz..." warning is counted,
those raised inside ``torch.linalg.eigh`` (cuSOLVER's info check) as the
library's and all others as ``other``, with the source line of each other
one. It goes through ``warnings``, which is not thread-safe: use it only
where one thread drives the device.
"""

from __future__ import annotations

import contextlib
import os
import traceback
import warnings

import torch


@contextlib.contextmanager
def count_syncs_by_source():
    """Yields {"library", "other", "eigh_calls", "other_sites"}, filled in
    while the block runs."""
    counts = {"library": 0, "other": 0, "eigh_calls": 0, "other_sites": []}
    inside, running = [False], [False]
    real_eigh = torch.linalg.eigh

    def eigh(*args, **kw):
        counts["eigh_calls"] += 1
        inside[0] = True
        try:
            return real_eigh(*args, **kw)
        finally:
            inside[0] = False

    def show(message, *args, **kw):
        if "synchroniz" not in str(message) or not running[0]:
            return
        counts["library" if inside[0] else "other"] += 1
        if not inside[0]:
            counts["other_sites"].append(" < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno}"
                for f in traceback.extract_stack()[-8:-1][::-1]))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.linalg.eigh = eigh
        torch.cuda.set_sync_debug_mode("warn")
        running[0] = True
        try:
            yield counts
        finally:
            running[0] = False
            torch.cuda.set_sync_debug_mode("default")
            torch.linalg.eigh = real_eigh
