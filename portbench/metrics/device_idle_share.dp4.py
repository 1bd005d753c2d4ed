"""device_idle_share (metrics/device_idle_share.py) in the four-card cell, whose
per-layer metrics move peak_device_mib: sites_per_s is no end-to-end
metric there (PERF.md §2).  The same reading."""
from portbench import catalog

MOVES = "peak_device_mib"
ROUTES, read = catalog.twin(__file__, "device_idle_share")
