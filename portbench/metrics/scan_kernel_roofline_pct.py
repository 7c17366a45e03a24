"""scan_kernel_roofline_pct: scan_roofline_pct's share, the least time of
each call's exhaustive search over the device time inside each call
span, with the device time cut to the scan kernels alone.

The scan kernels are the device operations whose name matches MATCH:
csrc/scan_tile.cuh's `scan_kernel` (the fp32 tile loop behind segmin.cu
and surface.cu) and csrc/segmin_i8.cu's `segmin_i8_*kernel` (the int8
route), so the share follows the scan whichever route computes it.
Where no such kernel ran in a call span, nothing."""

import copy
import re

from ..trace import Trace
from . import scan_roofline_pct

MATCH = re.compile(r"(?<![A-Za-z0-9_])(scan_kernel|segmin_i8_\w*kernel)"
                   r"(?![A-Za-z0-9_])")


def compute(run):
    t = run.trace
    if t is None:
        return None
    scan = copy.copy(run)
    scan.trace = Trace([op for op in t.device_ops if MATCH.search(op[0])],
                       t.spans)
    return scan_roofline_pct.compute(scan)
