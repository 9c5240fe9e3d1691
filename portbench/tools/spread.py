"""Spread of each metric over sets of runs, from their result lines.

    python3 portbench/tools/spread.py set1/*.out -- set2/*.out

Each file's last line is a run's result.  For each metric and set: the
median and the interquartile distance as a share of the median
(``statistics.quantiles(values, n=4)``); then the wider of the sets'
spreads, and five times it, the bound it suggests (never under 1%).
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import quartile_spread  # noqa: E402


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    sets, cur = [], []
    for a in argv:
        if a == "--":
            sets.append(cur)
            cur = []
        else:
            cur.append(a)
    sets.append(cur)
    per_metric = {}
    for i, files in enumerate(sets):
        for f in files:
            line = json.loads(Path(f).read_text().strip().splitlines()[-1])
            for name, m in line["metrics"].items():
                per_metric.setdefault(name, [[] for _ in sets])[i].append(m["value"])
    for name, groups in per_metric.items():
        spreads = [quartile_spread(g) for g in groups if len(g) >= 2]
        meds = [statistics.median(g) for g in groups if g]
        widest = max(spreads) if spreads else float("nan")
        print(json.dumps({"metric": name, "medians": meds, "spreads": spreads,
                          "widest": widest, "bound_5x": max(5 * widest, 0.01)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
