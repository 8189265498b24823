"""Recompute the cost fields of existing dry-run records from their stored
op logs (no new run). Port of `repro/launch/reanalyze.py`. Usage:
  PYTHONPATH=src python -m repro_torch.launch.reanalyze [dir]
"""
import argparse
import glob
import json
import sys

from repro_torch.launch.dryrun import OUT_DIR
from repro_torch.launch.op_costs import analyze, read_log


def reanalyze(path: str) -> dict:
    """The record at `path` with its cost, collective and kernel fields
    recomputed from the op log beside it, written back."""
    deep = analyze(read_log(path.replace(".json", ".ops.jsonl.gz")))
    with open(path) as f:
        rec = json.load(f)
    rec["deep_cost"] = {"dot_flops": deep["dot_flops"],
                        "hbm_bytes": deep["hbm_bytes"],
                        "unknown_trip_whiles": 0}
    rec["cost"].update(flops=deep["dot_flops"],
                       bytes_accessed=deep["hbm_bytes"])
    rec["collectives_bytes"] = deep["collectives_bytes"]
    rec["collectives_count"] = deep["collectives_count"]
    rec["collectives_bytes_periter"] = deep["collectives_bytes_periter"]
    rec["kernels"] = deep["kernel_calls"]
    rec["n_ops"] = deep["n_ops"]
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", nargs="?", default=OUT_DIR)
    d = ap.parse_args(argv).dir
    for path in sorted(glob.glob(d + "/*.json")):
        try:
            rec = reanalyze(path)
        except FileNotFoundError:
            print("no op log for", path)
            continue
        print("reanalyzed", path.split("/")[-1],
              f"hbm={rec['deep_cost']['hbm_bytes'] / 1e12:.2f}TB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
