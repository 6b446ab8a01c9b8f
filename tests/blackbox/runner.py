#!/usr/bin/env python3
"""Side-by-side black-box runner: swarm_tpu vs the reference binary.

Runs every case from cases.py in a fresh working directory for each
side, then byte-compares exit code, stdout, stderr, and the full set
of files either side created. The swarm_tpu side executes via
os.fork() from this (pre-imported) process so the 888-case battery
does not pay 888 interpreter+import startups; the reference side is a
subprocess invoked with argv[0] == "swarm" so error messages match
byte-for-byte (same trick as tests/conftest.py BothRunner).

Usage: python tests/blackbox/runner.py [--limit N] [--filter SUBSTR]
       [--json PATH]
Exit code 0 iff every case agrees.
"""

import argparse
import json
import os
import shlex
import shutil
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

# Start the reference-side launcher shell FIRST, while this process is
# still small: Linux never resets ru_maxrss on execve, so a reference
# binary forked from a fat Python (post-JAX import, hundreds of MB)
# inherits that high-water mark and its --ceiling accounting
# (arch_get_memused, src/arch.cc:41-75) fatals where a shell-launched
# run succeeds. All reference invocations below are passed through
# this lean bash co-process so they see the canonical envelope.
_BASH = subprocess.Popen(
    ["bash"], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
    text=True, bufsize=1,
)

# the parent must never initialize a JAX backend before forking
# (XLA thread pools do not survive fork); tiny corpora route to the
# native host engines, which never touch the device
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["SWARM_TPU_FORCE_PLATFORM"] = "cpu"

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
REFERENCE_DIR = Path("/root/reference")
BUILD_DIR = Path("/tmp/swarm_ref_build")

sys.path.insert(0, str(REPO_ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from cases import all_cases  # noqa: E402

from swarm_tpu.fatal import FatalError  # noqa: E402
from swarm_tpu.main import run as swarm_run  # noqa: E402


def ref_binary() -> Path:
    binary = BUILD_DIR / "bin" / "swarm"
    if binary.exists():
        return binary
    for cand in (Path("/tmp/ref_build/bin/swarm"),
                 Path("/tmp/swarm_ref_build_bench/bin/swarm")):
        if cand.exists():
            return cand
    if not REFERENCE_DIR.exists():
        raise SystemExit("reference checkout not available")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / "src_copy"
    if not work.exists():
        shutil.copytree(REFERENCE_DIR, work)
    subprocess.run(["make", "-j", "8"], cwd=work, check=True,
                   capture_output=True)
    (BUILD_DIR / "bin").mkdir(exist_ok=True)
    shutil.copy2(work / "bin" / "swarm", binary)
    return binary


def run_ref(binary: Path, case: dict, workdir: Path):
    args = list(case["args"])
    if case.get("fasta") is not None:
        (workdir / "input.fasta").write_bytes(case["fasta"])
        if "input.fasta" not in args:
            args.append("input.fasta")
    (workdir / ".stdin").write_bytes(case.get("stdin") or b"")
    # `exec -a swarm` gives the binary argv[0] == "swarm" so its error
    # messages match ours byte-for-byte; `cat |` makes stdin a pipe
    # (the hint at src/db.cc:117-121 fires on non-regular input only)
    quoted = " ".join(shlex.quote(a) for a in args)
    cmd = (
        f"cd {shlex.quote(str(workdir))} && cat .stdin | "
        f"timeout 120 bash -c 'exec -a swarm {shlex.quote(str(binary))} "
        f'"$@"\' swarm {quoted} > .stdout 2> .stderr; echo __RC__$?'
    )
    _BASH.stdin.write(cmd + "\n")
    _BASH.stdin.flush()
    while True:
        line = _BASH.stdout.readline()
        if not line:
            raise RuntimeError("launcher shell died")
        if line.startswith("__RC__"):
            rc = int(line[6:].strip())
            break
    stdout = (workdir / ".stdout").read_bytes()
    stderr = (workdir / ".stderr").read_bytes()
    (workdir / ".stdout").unlink()
    (workdir / ".stderr").unlink()
    (workdir / ".stdin").unlink()
    return rc & 0xFF, stdout, stderr


def run_ours(case: dict, workdir: Path):
    args = list(case["args"])
    if case.get("fasta") is not None:
        (workdir / "input.fasta").write_bytes(case["fasta"])
        if "input.fasta" not in args:
            args.append("input.fasta")
    out_path = workdir / ".stdout"
    err_path = workdir / ".stderr"
    # stdin must be a PIPE, as subprocess.run gives the reference —
    # the "Waiting for data..." hint fires on non-regular input only
    stdin_data = case.get("stdin") or b""
    assert len(stdin_data) < 60000, "pipe-buffer limit in the harness"
    pipe_r, pipe_w = os.pipe()
    os.write(pipe_w, stdin_data)
    os.close(pipe_w)

    sys.stdout.flush()
    sys.stderr.flush()
    pid = os.fork()
    if pid == 0:  # child
        status = 1
        try:
            signal.alarm(120)
            os.chdir(workdir)
            fd_out = os.open(".stdout", os.O_WRONLY | os.O_CREAT, 0o644)
            fd_err = os.open(".stderr", os.O_WRONLY | os.O_CREAT, 0o644)
            os.dup2(pipe_r, 0)
            os.dup2(fd_out, 1)
            os.dup2(fd_err, 2)
            try:
                status = swarm_run(args, "swarm")
            except FatalError:
                status = 1
            except BrokenPipeError:
                status = 1
            except SystemExit as exc:
                status = int(exc.code or 0)
            except BaseException:
                import traceback

                traceback.print_exc(file=sys.stderr)
                status = 97  # loud: an exception class the CLI never emits
        finally:
            try:
                sys.stdout.flush()
                sys.stderr.flush()
            except Exception:
                pass
            os._exit(status)
    os.close(pipe_r)
    _, wait_status = os.waitpid(pid, 0)
    if os.WIFSIGNALED(wait_status):
        rc = 128 + os.WTERMSIG(wait_status)
    else:
        rc = os.WEXITSTATUS(wait_status)
    stdout = out_path.read_bytes() if out_path.exists() else b""
    stderr = err_path.read_bytes() if err_path.exists() else b""
    for f in (out_path, err_path):
        if f.exists():
            f.unlink()
    return rc, stdout, stderr


def snapshot(workdir: Path) -> dict:
    """All files created by the run (input removed), name -> bytes."""
    files = {}
    for f in sorted(workdir.rglob("*")):
        if f.is_file() and f.name != "input.fasta":
            files[str(f.relative_to(workdir))] = f.read_bytes()
    return files


def compare_case(binary: Path, case: dict, root: Path):
    ref_dir = root / "ref"
    ours_dir = root / "ours"
    ref_dir.mkdir()
    ours_dir.mkdir()
    ref_rc, ref_out, ref_err = run_ref(binary, case, ref_dir)
    ours_rc, ours_out, ours_err = run_ours(case, ours_dir)
    problems = []
    if ref_rc != ours_rc:
        problems.append(f"exit code: ref={ref_rc} ours={ours_rc}")
    if ref_out != ours_out:
        problems.append(f"stdout: ref={ref_out[:200]!r} ours={ours_out[:200]!r}")
    if ref_err != ours_err:
        # show the first differing line for debuggability
        rl, tl = ref_err.splitlines(), ours_err.splitlines()
        diff = next(
            ((a, b) for a, b in zip(rl, tl) if a != b),
            (rl[len(tl):len(tl) + 1], tl[len(rl):len(rl) + 1]),
        )
        problems.append(f"stderr: first diff ref={diff[0]!r} ours={diff[1]!r}")
    ref_files = snapshot(ref_dir)
    ours_files = snapshot(ours_dir)
    if set(ref_files) != set(ours_files):
        problems.append(
            f"file sets: ref={sorted(ref_files)} ours={sorted(ours_files)}"
        )
    else:
        for name, blob in ref_files.items():
            if ours_files[name] != blob:
                problems.append(
                    f"{name}: ref={blob[:160]!r} ours={ours_files[name][:160]!r}"
                )
    return problems


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--filter", default="")
    ap.add_argument("--json", default="")
    opts = ap.parse_args()

    binary = ref_binary()
    # warm the native extension in the parent (children inherit the
    # loaded .so instead of racing 888 rebuild attempts)
    from swarm_tpu import _native

    _native.available()

    cases = all_cases()
    if opts.filter:
        cases = [c for c in cases if opts.filter in c["name"]]
    if opts.limit:
        cases = cases[: opts.limit]

    failures = []
    passed = 0
    with tempfile.TemporaryDirectory(prefix="swarm_blackbox_") as tmp:
        tmp_root = Path(tmp)
        for i, case in enumerate(cases):
            case_root = tmp_root / f"case{i}"
            case_root.mkdir()
            try:
                problems = compare_case(binary, case, case_root)
            except Exception as exc:  # harness-level failure
                problems = [f"harness error: {exc!r}"]
            if problems:
                failures.append({"name": case["name"],
                                 "args": case["args"],
                                 "problems": problems})
                print(f"FAIL {case['name']}: {problems[0]}", flush=True)
            else:
                passed += 1
            shutil.rmtree(case_root, ignore_errors=True)
            if (i + 1) % 100 == 0:
                print(f"[{i + 1}/{len(cases)}] {passed} ok, "
                      f"{len(failures)} failed", flush=True)

    print(f"blackbox: {passed}/{len(cases)} passed, "
          f"{len(failures)} failed", flush=True)
    if opts.json:
        Path(opts.json).write_text(json.dumps({
            "total": len(cases),
            "passed": passed,
            "failed": len(failures),
            "failures": failures[:50],
        }, indent=1))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
