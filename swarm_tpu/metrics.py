"""Run metrics, filled in by the engines on each run.

Counters are pairwise comparisons (the BASELINE.md north-star
denominators). A "comparison" is one candidate pair examined:
 - d=1: candidate pairs produced by the sort-join (key matches checked
   by the windowed dist-1 verifier) plus graft-join candidates;
 - d>=2: qgram screen evaluations (gen-1 pool scan + subseed scans)
   plus exact alignments.

Engines name the engine that served each stage (engines["d1_network"]
== "sortjoin", ...), so a caller can check which engine actually ran.
SWARM_TPU_METRICS=FILE writes both as one JSON object at the end of
each run.
"""

import os

last_run = {}
engines = {}


def reset() -> None:
    last_run.clear()
    engines.clear()


def record(**kv) -> None:
    for k, v in kv.items():
        last_run[k] = last_run.get(k, 0) + int(v)


def engine(**stages) -> None:
    """Name the engine that served each stage of this run."""
    engines.update(stages)


def total_comparisons() -> int:
    return sum(v for k, v in last_run.items() if k.endswith("_comparisons"))


def dump() -> None:
    path = os.environ.get("SWARM_TPU_METRICS")
    if not path:
        return
    import json

    with open(path, "w") as fh:
        json.dump({"counters": last_run, "engines": engines}, fh)
