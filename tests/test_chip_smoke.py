"""chip_smoke.py off the GPU, its comparison helper, and the engine
records it reads (swarm_tpu/metrics.py)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from swarm_tpu import metrics  # noqa: E402


def test_smoke_fails_without_gpu():
    # PATH without nvidia-smi: no card, even on a machine that has one
    env = {**os.environ, "PATH": os.path.dirname(sys.executable)}
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_smoke_fails_outside_checkout(tmp_path):
    shutil.copy2(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_device_check_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeError, match="not a GPU"):
        chip_smoke.device_info({"JAX_PLATFORMS": "cpu"})


def _run_dirs(tmp_path, a_bytes, b_bytes):
    dirs = []
    for name, blob in (("a", a_bytes), ("b", b_bytes)):
        d = tmp_path / name
        d.mkdir()
        (d / "o.txt").write_bytes(blob)
        (d / "s.txt").write_bytes(b"1\t2\n")
        dirs.append(d)
    return dirs


@pytest.mark.parametrize(
    "b_bytes,res_b,want",
    [
        (b"ab\tcd\n", (0, b""), []),
        (b"ab\tce\n", (0, b""), ["o.txt differs"]),  # one byte
        (b"ab\tcd\n", (0, b"x"), ["stdout differs"]),
        (b"ab\tcd\n", (1, b""), ["exit code 0 != 1"]),
    ],
)
def test_differences_catches_one_byte(tmp_path, b_bytes, res_b, want):
    a, b = _run_dirs(tmp_path, b"ab\tcd\n", b_bytes)
    got = chip_smoke.differences(["-d", "1", "-o", "-s"], a, (0, b""),
                                 b, res_b)
    assert got == want


def test_metrics_engine_record():
    metrics.reset()
    metrics.record(d1_join_comparisons=3)
    metrics.engine(d1_network="sortjoin")
    metrics.engine(graft="sorted")
    assert metrics.engines == {"d1_network": "sortjoin", "graft": "sorted"}
    metrics.reset()
    assert metrics.engines == {} and metrics.last_run == {}


def test_cli_writes_engine_record(tmp_path):
    sys.path.insert(0, str(REPO / "tests"))
    from genfasta import amplicon_cloud

    (tmp_path / "in.fasta").write_text(
        amplicon_cloud(seed=3, n_centers=4, cloud_size=10, length=60))
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "SWARM_TPU_METRICS": str(tmp_path / "m.json")}
    subprocess.run(
        [sys.executable, str(REPO / "bin" / "swarm"), "-o", "o.txt",
         "in.fasta"], cwd=tmp_path, env=env, capture_output=True,
        check=True, timeout=300)
    record = json.loads((tmp_path / "m.json").read_text())
    assert record["engines"] == {"d1_network": "native"}
    assert record["counters"]["d1_join_comparisons"] >= 0
