"""Summarise a timed run of the test suite.

Run the Tier-1 command of ROADMAP.md with ``MNT_TEST_CLOCK_LOG=LOG`` set
(the repository's ``conftest.py`` then appends one JSON line per test:
its worker, and its start and end on the controller's clock), then::

    python3 scripts/port_test_clock.py LOG [--last 12]

It prints the wall from the first start to the last end, each worker's
busy seconds and its last end, the worker-seconds of the files that
take the most, and the work units (a file, or a test of a split file)
that ended last, each with its worker, start and end in seconds from
the first start.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from conftest import SPLIT_FILES  # noqa: E402


def unit_of(nodeid: str) -> str:
    path = nodeid.split("::", 1)[0]
    return nodeid if path in SPLIT_FILES else path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log")
    ap.add_argument("--last", type=int, default=12,
                    help="units to list, the last to end first")
    ap.add_argument("--files", type=int, default=15,
                    help="files to list, the most worker-seconds first")
    a = ap.parse_args(argv)
    rows = [json.loads(line) for line in open(a.log) if line.strip()]
    rows = [r for r in rows if r["start"] is not None]
    t0 = min(r["start"] for r in rows)
    busy = collections.defaultdict(float)
    worker_end = collections.defaultdict(float)
    file_s = collections.defaultdict(float)
    units = {}
    for r in rows:
        s, e = r["start"] - t0, r["end"] - t0
        busy[r["worker"]] += e - s
        worker_end[r["worker"]] = max(worker_end[r["worker"]], e)
        file_s[r["nodeid"].split("::", 1)[0]] += e - s
        u = units.setdefault(unit_of(r["nodeid"]),
                             {"worker": r["worker"], "start": s, "end": e})
        u["start"], u["end"] = min(u["start"], s), max(u["end"], e)
    wall = max(worker_end.values())
    print(f"tests {len(rows)}  wall {wall:.1f} s  worker-seconds "
          f"{sum(busy.values()):.1f}")
    for w in sorted(busy):
        print(f"  {w}: busy {busy[w]:.1f} s, last end {worker_end[w]:.1f} s")
    print("files, most worker-seconds first:")
    for f, s in sorted(file_s.items(), key=lambda kv: -kv[1])[:a.files]:
        print(f"  {s:8.1f} s  {f}")
    print("units, the last to end first (worker, start, end):")
    last = sorted(units.items(), key=lambda kv: -kv[1]["end"])[:a.last]
    for name, u in last:
        print(f"  {u['worker']:>5} {u['start']:8.1f} {u['end']:8.1f}  {name}")
    for f in SPLIT_FILES:
        ends = [u["end"] for n, u in units.items() if n.startswith(f)]
        if ends:
            print(f"{f}: {len(ends)} units, last end {max(ends):.1f} s "
                  f"({wall - max(ends):.1f} s before the wall)")


if __name__ == "__main__":
    main()
