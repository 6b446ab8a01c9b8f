"""Test configuration.

JAX tests run on a virtual 8-device CPU mesh, so multi-device sharding
is exercised without accelerator hardware. SWARM_TPU_TEST_PLATFORM=cuda
keeps JAX on the GPU instead, for the tests marked `gpu`
(`python -m pytest -m gpu tests/`; chip_smoke.py runs them). Parity
tests build the reference swarm binary (from the read-only checkout)
once per machine and diff outputs.
"""

import os

# must be set before jax is imported anywhere; inherited by the CLI
# subprocesses the tests start
_PLATFORM = os.environ.get("SWARM_TPU_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _PLATFORM
if _PLATFORM == "cpu":
    # let the auto engine choice take the device engines on the CPU
    os.environ["SWARM_TPU_FORCE_PLATFORM"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", _PLATFORM)
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
REFERENCE_DIR = Path("/root/reference")
BUILD_DIR = Path("/tmp/swarm_ref_build")


@pytest.fixture(scope="session")
def ref_binary() -> Path:
    """Build (once) and return the path of the reference swarm binary."""
    binary = BUILD_DIR / "bin" / "swarm"
    if binary.exists():
        return binary
    if not REFERENCE_DIR.exists():
        pytest.skip("reference checkout not available")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / "src_copy"
    if not work.exists():
        shutil.copytree(REFERENCE_DIR, work)
    subprocess.run(
        ["make", "-j", "8"], cwd=work, check=True, capture_output=True
    )
    (BUILD_DIR / "bin").mkdir(exist_ok=True)
    shutil.copy2(work / "bin" / "swarm", binary)
    return binary


class BothRunner:
    """Run the reference binary and swarm_tpu on the same input; compare."""

    OUTPUT_FLAGS = {
        "-o": "out.txt",
        "-s": "stats.txt",
        "-u": "uclust.txt",
        "-i": "structure.txt",
        "-j": "network.txt",
        "-w": "seeds.fasta",
        "-l": "log.txt",
    }

    def __init__(self, ref_binary: Path, tmp_path: Path):
        self.ref_binary = ref_binary
        self.tmp_path = tmp_path

    def run_one(self, which: str, args, fasta_text, stdin_data=None):
        workdir = self.tmp_path / which
        workdir.mkdir(parents=True, exist_ok=True)
        args = list(args)
        if fasta_text is not None:
            (workdir / "input.fasta").write_bytes(
                fasta_text.encode() if isinstance(fasta_text, str) else fasta_text
            )
            # pass the corpus on the command line unless the test already
            # names an input (positional arg or explicit '-'); a corpus
            # that is written but never read makes the test vacuous
            if "input.fasta" not in args and "-" not in args:
                args.append("input.fasta")
        if which == "ref":
            cmd = ["swarm"] + list(args)
            executable = str(self.ref_binary)
            result = subprocess.run(
                cmd,
                executable=executable,
                cwd=workdir,
                input=stdin_data,
                capture_output=True,
                timeout=600,
            )
        else:
            launcher = REPO_ROOT / "bin" / "swarm"
            shutil.copy2(launcher, workdir / "swarm")
            result = subprocess.run(
                [sys.executable, "swarm"] + list(args),
                cwd=workdir,
                input=stdin_data,
                capture_output=True,
                timeout=600,
                env={
                    **os.environ,
                    "PYTHONPATH": str(REPO_ROOT),
                    "SWARM_TPU_PROGNAME": "swarm",
                },
            )
        return workdir, result

    def compare(self, args, fasta_text, stdin_data=None, check_stderr=True):
        ref_dir, ref = self.run_one("ref", args, fasta_text, stdin_data)
        ours_dir, ours = self.run_one("ours", args, fasta_text, stdin_data)

        assert ref.returncode == ours.returncode, (
            f"exit codes differ: ref={ref.returncode} ours={ours.returncode}\n"
            f"ref stderr: {ref.stderr!r}\nours stderr: {ours.stderr!r}"
        )
        assert ref.stdout == ours.stdout, (
            f"stdout differs\nref: {ref.stdout!r}\nours: {ours.stdout!r}"
        )
        if check_stderr:
            assert ref.stderr == ours.stderr, (
                f"stderr differs\nref: {ref.stderr!r}\nours: {ours.stderr!r}"
            )
        for flag, filename in self.OUTPUT_FLAGS.items():
            if flag in args:
                ref_file = ref_dir / filename
                ours_file = ours_dir / filename
                ref_bytes = ref_file.read_bytes() if ref_file.exists() else None
                ours_bytes = ours_file.read_bytes() if ours_file.exists() else None
                assert ref_bytes == ours_bytes, (
                    f"{filename} differs\nref:\n{ref_bytes!r}\nours:\n{ours_bytes!r}"
                )
        return ref, ours


@pytest.fixture
def both(ref_binary, tmp_path):
    return BothRunner(ref_binary, tmp_path)
