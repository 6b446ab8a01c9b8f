"""Raw-stderr parity WITHOUT -l: progress milestone streams.

Without -l the reference writes its log (banner + per-phase progress
percentages) to stderr; the percentage milestones appear only in this
mode (src/utils/progress.cc). These tests diff raw stderr byte-for-byte
on corpora large enough (>= GRANULARITY amplicons) that every phase
emits real milestone sequences — the regime the -l-based suite never
sees.
"""

import pytest

from genfasta import amplicon_cloud

OUTPUTS = ["-o", "out.txt", "-s", "stats.txt"]
FULL_OUTPUTS = OUTPUTS + [
    "-u", "uclust.txt", "-i", "structure.txt", "-w", "seeds.fasta",
]


def big_cloud(seed, **kw):
    # ~1,200 amplicons: 6x the 200-step progress granularity
    args = dict(seed=seed, n_centers=12, cloud_size=100, length=60,
                max_edits=2, max_abundance=50)
    args.update(kw)
    return amplicon_cloud(**args)


def test_stderr_d1(both):
    both.compare(FULL_OUTPUTS + ["-j", "network.txt"], big_cloud(31))


def test_stderr_d1_fastidious(both):
    both.compare(["-f"] + FULL_OUTPUTS, big_cloud(32))


def test_stderr_d1_fastidious_boundary(both):
    both.compare(["-f", "-b", "20"] + OUTPUTS, big_cloud(33))


def test_stderr_d0(both):
    both.compare(["-d", "0"] + FULL_OUTPUTS, big_cloud(34))


@pytest.mark.parametrize("d", [2, 3])
def test_stderr_general(both, d):
    fasta = amplicon_cloud(seed=35 + d, n_centers=8, cloud_size=40,
                           length=50, max_edits=2, max_abundance=30)
    both.compare(["-d", str(d)] + FULL_OUTPUTS, fasta)


def test_stderr_d1_mothur(both):
    both.compare(["-r", "-o", "out.txt"], big_cloud(38))


def test_trace_artifact(tmp_path):
    """SWARM_TPU_TRACE writes a chrome-trace JSON of phase spans."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from genfasta import amplicon_cloud

    repo = Path(__file__).resolve().parent.parent
    (tmp_path / "in.fasta").write_text(
        amplicon_cloud(seed=21, n_centers=4, cloud_size=8, length=60)
    )
    trace = tmp_path / "trace.json"
    env = {
        **os.environ,
        "PYTHONPATH": str(repo),
        "JAX_PLATFORMS": "cpu",
        "SWARM_TPU_FORCE_PLATFORM": "cpu",
        "SWARM_TPU_TRACE": str(trace),
    }
    r = subprocess.run(
        [sys.executable, str(repo / "bin" / "swarm"), "-d", "1",
         "-o", "o.txt", "in.fasta"],
        cwd=tmp_path, env=env, capture_output=True, timeout=120,
    )
    assert r.returncode == 0
    data = json.loads(trace.read_text())
    names = [e["name"] for e in data["traceEvents"]]
    assert "Building network:" in names and "Clustering:" in names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in data["traceEvents"])
