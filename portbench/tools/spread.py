"""The spread of each end-to-end metric over sets of runs of one cell, as
the bounds in BENCHMARK.json are set from it: per set, the distance
between the first and third quartiles (`statistics.quantiles(n=4)`) as a
share of the median; per metric, the wider of the sets'.

    python3 portbench/tools/spread.py <set A result files...> -- <set B result files...>

Each file holds a run's standard output (its last line is the result)."""

from __future__ import annotations

import json
import statistics
import sys


def results(paths):
    return [json.loads(open(p).read().strip().splitlines()[-1]) for p in paths]


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def table(sets):
    names = sorted({k for s in sets for r in s for k in r["metrics"]})
    out = {}
    for name in names:
        per_set = [[r["metrics"][name]["value"] for r in s if name in r["metrics"]] for s in sets]
        out[name] = {"medians": [statistics.median(v) for v in per_set],
                     "spreads": [spread(v) for v in per_set],
                     "values": per_set}
        out[name]["widest"] = max(out[name]["spreads"])
    return out


def main(argv) -> int:
    cut = argv.index("--")
    sets = [results(argv[:cut]), results(argv[cut + 1:])]
    for s in sets:
        print("correct:", [r["correct"] for r in s])
    print(json.dumps(table(sets), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
