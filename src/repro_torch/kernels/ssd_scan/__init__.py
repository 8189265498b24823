from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    SsdScanFn, ssd_scan, ssd_scan_fwd, ssd_scan_naive, ssd_scan_plain)
