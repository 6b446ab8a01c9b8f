"""Platform query, engine choice and the persistent compile cache."""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from swarm_tpu import device

REPO = Path(__file__).resolve().parent.parent


def test_device_platform_reports_backend_without_thread():
    before = threading.active_count()
    assert device.device_platform() == "cpu"
    assert threading.active_count() == before
    src = Path(device.__file__).read_text()
    assert "threading" not in src and "except Exception" not in src


@pytest.mark.parametrize(
    "forced,platform,want",
    [
        ("cpu", "cpu", True),   # tests: device engines on virtual CPUs
        ("", "cpu", False),     # CPU-only machine: native host engines
        ("", "gpu", True),
    ],
)
def test_use_device_engines(monkeypatch, forced, platform, want):
    if forced:
        monkeypatch.setenv("SWARM_TPU_FORCE_PLATFORM", forced)
    else:
        monkeypatch.delenv("SWARM_TPU_FORCE_PLATFORM", raising=False)
    monkeypatch.setattr(device, "device_platform", lambda: platform)
    assert device.use_device_engines() is want


_PROBE = (
    "from swarm_tpu.ops import d2_network, neighbors_jax as nj;"
    "print(nj.compile_cache_dir()); print(d2_network._params_path())"
)


@pytest.mark.parametrize("case", ["env", "default", "cpu"])
def test_compile_cache_dir(tmp_path, case):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                        "SWARM_TPU_FORCE_PLATFORM")}
    env["PYTHONPATH"] = str(REPO)
    if case == "env":
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
        want = str(tmp_path / "cc")
    elif case == "default":
        want = str(REPO / ".jax_cache")
    else:
        env["JAX_PLATFORMS"] = "cpu"
        want = "None"
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                       capture_output=True, text=True, cwd=tmp_path,
                       check=True)
    cache, params = r.stdout.split()
    assert cache == want
    if want == "None":
        assert params == "None"
    else:
        assert params == os.path.join(want, "d2_screen_params.json")
