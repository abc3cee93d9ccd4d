# Frozen copy of chip_smoke.py:count_syncs and package_sites at commit
# 50013dad8c92 (ROOT is the checkout's root, as it was).
"""Host-device synchronisations, as torch's sync debug mode reports them."""
from __future__ import annotations

import os
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def count_syncs(fn):
    """{call site: count} of every synchronising call that ``fn`` makes, as
    torch's sync debug mode reports them."""
    import torch

    sites = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def package_sites(sites):
    """The call sites of ``count_syncs`` inside the package."""
    return {k: v for k, v in sites.items() if k.startswith("msckf_stereo_c_torch/")}
