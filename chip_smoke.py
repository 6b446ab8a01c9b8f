#!/usr/bin/env python3
"""Chip smoke test: the CLI's device engines on a GPU, byte-compared with
the host engines.

    python chip_smoke.py          # phases 1-7 on one GPU
    python chip_smoke.py --multi  # the sharded engines on four GPUs

Every run goes through bin/swarm (or the resident server) on corpora
from bench.gen_corpus with a fixed seed. The oracle is the same command
on the native host engines (SWARM_TPU_BACKEND=numpy,
SWARM_TPU_D2_ENGINE=native, SWARM_TPU_GRAFT=native) with JAX held to
the CPU; every output file, stdout and the exit code must be
byte-identical, and each device run must name the engines it was meant
to exercise (swarm_tpu/metrics.py). This process never imports JAX, so
exactly one process holds the card at any time.

One GPU:
  1  JAX sees a gpu device
  2  -d 1 -o -s -w, 1M amplicons ~150 nt           device sort-join
  3  -d 1 -f -o -s -i -u -w, 200k, GRAFT=sorted     device graft join
  4  -d 2 -o -s, 100k x ~150 nt                     int8 screen + diffs
  5  -d 2 -o -s, 20k x ~400 nt                      diff kernel, Lmax 448
  6  diff kernel against the XLA scan and the native diffs on the
     candidate pairs of phases 4 and 5, with timings; pytest -m gpu
  7  resident server: phases 2, 4 and 2 again through SWARM_TPU_SERVER
--multi (four GPUs, XLA_PYTHON_CLIENT_PREALLOCATE=false so that each
card's memory reads what it holds):
  d=1 at 1M over SWARM_TPU_BACKEND=jax_shard (sharded sort-join), and
  -d 1 -f at 200k with SWARM_TPU_GRAFT=sharded (sharded graft join).

The last line of stdout is {"ok": true, "device": {...}}; any failure
exits non-zero before it.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "smoke_work"
SEED = 20260816
THREADS = os.cpu_count() or 1

# name -> (amplicons, mean length)
CORPORA = {
    "d1_1m": (1_000_000, 150),
    "d1_200k": (200_000, 150),
    "d2_100k": (100_000, 150),
    "d2_long": (20_000, 400),
}
# the environment of a device run: JAX must take the GPU or fail
DEVICE_ENV = {"JAX_PLATFORMS": "cuda"}
ORACLE_ENV = {
    "JAX_PLATFORMS": "cpu",
    "SWARM_TPU_BACKEND": "numpy",
    "SWARM_TPU_D2_ENGINE": "native",
    "SWARM_TPU_GRAFT": "native",
}
# the engines each d=2 device run must name
D2_ENGINES = {"d2": "network", "d2_screen": "device",
              "d2_diffs": "device_kernel"}
# flag -> output file name
OUTPUTS = {"-o": "o.txt", "-s": "s.txt", "-w": "w.fa", "-u": "u.txt",
           "-i": "i.txt"}


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except OSError as exc:
        raise SmokeError(f"nvidia-smi: {exc}") from None
    if r.returncode != 0 or not r.stdout.strip():
        raise SmokeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return "; ".join(line.strip() for line in r.stdout.splitlines())


def _env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SWARM_TPU_") and k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(REPO)
    env.update(extra)
    return env


def device_info(env: dict) -> dict:
    """Phase 1: the platform, kind and count JAX reports, in a child."""
    code = (
        "import json, jax; d = jax.devices();"
        "print(json.dumps({'platform': d[0].platform,"
        " 'kind': d[0].device_kind, 'count': len(d)}))"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_env(env),
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise SmokeError(f"JAX found no GPU:\n{r.stderr[-2000:]}")
    info = json.loads(r.stdout.strip().splitlines()[-1])
    if info["platform"] != "gpu":
        raise SmokeError(f"JAX runs on {info['platform']}, not a GPU")
    return info


def corpus(name: str) -> Path:
    n, length = CORPORA[name]
    path = WORK / f"{name}_{n}_{length}.fasta"
    if not path.exists():
        sys.path.insert(0, str(REPO))
        import bench

        bench.gen_corpus(path, n, length, seed=SEED)
    return path


def run_cli(args, fasta: Path, outdir: Path, env: dict):
    """bin/swarm ARGS FASTA with output files in outdir.

    Returns (returncode, stdout, stderr, wall seconds, metrics)."""
    if outdir.exists():
        shutil.rmtree(outdir)
    outdir.mkdir(parents=True)
    argv = ["-t", str(THREADS)]
    for flag in args:
        argv.append(flag)
        if flag in OUTPUTS:
            argv.append(OUTPUTS[flag])
    argv.append(str(fasta))
    full_env = _env({**env, "SWARM_TPU_TIMING": "1",
                     "SWARM_TPU_METRICS": str(outdir / "metrics.json")})
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(REPO / "bin" / "swarm")] + argv,
                       cwd=outdir, env=full_env, capture_output=True)
    wall = time.perf_counter() - t0
    mpath = outdir / "metrics.json"
    metrics = json.loads(mpath.read_text()) if mpath.exists() else {}
    return r.returncode, r.stdout, r.stderr, wall, metrics


def differences(args, dir_a: Path, res_a, dir_b: Path, res_b) -> list:
    """What differs between two runs: exit code, stdout, output files."""
    out = []
    if res_a[0] != res_b[0]:
        out.append(f"exit code {res_a[0]} != {res_b[0]}")
    if res_a[1] != res_b[1]:
        out.append("stdout differs")
    for flag, name in OUTPUTS.items():
        if flag not in args:
            continue
        a, b = dir_a / name, dir_b / name
        if not a.exists() or not b.exists():
            out.append(f"{name} missing")
        elif a.read_bytes() != b.read_bytes():
            out.append(f"{name} differs")
    return out


def timing_lines(stderr: bytes) -> list:
    return [line for line in stderr.decode("latin-1").splitlines()
            if line.startswith("[timing]")]


def cli_phase(label, args, name, device_env, want_engines, extra_env,
              card_line):
    """One CLI run on the device and on the oracle, compared."""
    fasta = corpus(name)
    dev_dir = WORK / label / "device"
    ref_dir = WORK / label / "oracle"
    dev = run_cli(args, fasta, dev_dir, {**device_env, **extra_env})
    if dev[0] != 0:
        raise SmokeError(f"{label}: device run failed (rc {dev[0]}):\n"
                         + dev[2].decode("latin-1")[-4000:])
    ref = run_cli(args, fasta, ref_dir, ORACLE_ENV)
    diff = differences(args, dev_dir, dev, ref_dir, ref)
    if diff:
        raise SmokeError(f"{label}: device output != oracle: {diff}")
    engines = dev[4].get("engines", {})
    for stage, want in want_engines.items():
        if engines.get(stage) != want:
            raise SmokeError(f"{label}: {stage} ran {engines.get(stage)!r},"
                             f" expected {want!r} (engines: {engines})")
    for line in timing_lines(dev[2]):
        log(f"  {line} [{card_line}]")
    log(f"{label}: ok, byte-identical to the oracle; device wall "
        f"{dev[3]:.3f} s, oracle wall {ref[3]:.3f} s; engines {engines} "
        f"[{card_line}]")
    return dev_dir, dev


def diffs_check(fastas) -> None:
    """Phase 6 body (runs in a child on the card): the diff kernel
    against the XLA scan and the native diffs on each corpus's real
    d=2 candidate pairs, exact, with timings."""
    import io

    import numpy as np

    from swarm_tpu import _native
    from swarm_tpu.db import db_read
    from swarm_tpu.ops.d2_diffs_jax import DeviceDiffEngine, d2_diffs_program
    from swarm_tpu.ops.d2_diffs_kernel import d2_diffs_kernel
    from swarm_tpu.ops.d2_network import D2NetworkEngine
    from swarm_tpu.params import Parameters
    from swarm_tpu.progress import Progress

    d, mismatch, go, ge = 2, 4, 12, 4
    for fasta in map(Path, fastas):
        p = Parameters()
        p.input_filename = str(fasta)
        p.logfile = io.StringIO()
        db = db_read(p, Progress(io.StringIO(), True))
        pa, pb, _ = D2NetworkEngine(db, d).candidate_pairs()
        eng = DeviceDiffEngine(db, d)
        B = eng.band_for_exact(d * max(mismatch, go + ge), go, ge)
        args = eng.task_arrays(np.concatenate([pa, pb]),
                               np.concatenate([pb, pa]))
        kw = dict(B=B, Lmax=eng.Lmax, mismatch=mismatch, go=go, ge=ge, d=d)
        walls = {}
        outs = {}
        for name, fn in (("kernel", d2_diffs_kernel),
                         ("scan", d2_diffs_program)):
            outs[name] = np.asarray(fn(*args, **kw))  # compile + check
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                fn(*args, **kw).block_until_ready()
                best = min(best, time.perf_counter() - t0)
            walls[name] = best
        t0 = time.perf_counter()
        nab, nba = _native.d2_diffs_pairs(
            db.codes, db.offsets, db.lengths, db.abundances, pa, pb,
            d, mismatch, go, ge, True, nthreads=THREADS,
        )
        walls["native"] = time.perf_counter() - t0
        P = len(pa)
        if not np.array_equal(outs["kernel"], outs["scan"]):
            raise SmokeError(f"{fasta.name}: kernel != XLA scan")
        if not (np.array_equal(outs["kernel"][:P], nab)
                and np.array_equal(outs["kernel"][P:2 * P], nba)):
            raise SmokeError(f"{fasta.name}: kernel != native diffs")
        log(json.dumps({
            "corpus": fasta.name, "pairs": int(P), "tasks": int(2 * P),
            "Lmax": eng.Lmax, "B": B,
            "accepted": int((outs["kernel"] >= 0).sum()),
            "kernel_s": walls["kernel"], "scan_s": walls["scan"],
            "native_s": walls["native"],
        }))


def child_python(code: str, env: dict, label: str) -> str:
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_env(env), capture_output=True, text=True)
    if r.returncode != 0:
        raise SmokeError(f"{label} failed:\n{r.stdout[-3000:]}\n"
                         f"{r.stderr[-3000:]}")
    return r.stdout


def kernel_phase(device_env, card_line) -> None:
    fastas = [str(corpus("d2_100k")), str(corpus("d2_long"))]
    t0 = time.perf_counter()
    out = child_python(f"import chip_smoke; chip_smoke.diffs_check({fastas!r})",
                       device_env, "phase 6 kernel check")
    for line in out.splitlines():
        log(f"  {line} [{card_line}]")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/"],
        cwd=REPO, env=_env({**device_env,
                            "SWARM_TPU_TEST_PLATFORM": "cuda"}),
        capture_output=True, text=True,
    )
    tail = r.stdout.strip().splitlines()[-1:] or [""]
    if r.returncode != 0 or "skipped" in tail[0] or "passed" not in tail[0]:
        raise SmokeError(f"pytest -m gpu: {r.stdout[-3000:]}"
                         f"{r.stderr[-2000:]}")
    log(f"phase 6: ok, kernel == scan == native; pytest -m gpu: {tail[0]}; "
        f"{time.perf_counter() - t0:.3f} s [{card_line}]")


def server_phase(device_env, card_line, expected) -> None:
    """Phase 7: requests through bin/swarm with SWARM_TPU_SERVER,
    outputs byte-identical to the direct device runs. The server is the
    only process on the card; the client stays stdlib-only."""
    sock = WORK / "server.sock"
    metrics_path = WORK / "server_metrics.json"
    server_err = open(WORK / "server.stderr", "wb")
    server = subprocess.Popen(
        [sys.executable, "-m", "swarm_tpu.server", str(sock)], cwd=REPO,
        env=_env({**device_env, "SWARM_TPU_TIMING": "1",
                  "SWARM_TPU_METRICS": str(metrics_path)}),
        stdout=subprocess.DEVNULL, stderr=server_err,
    )
    try:
        deadline = time.time() + 120
        while True:
            if server.poll() is not None:
                raise SmokeError("server exited at start-up")
            try:
                with socket.socket(socket.AF_UNIX) as conn:
                    conn.connect(str(sock))
                    conn.sendall(b'{"op": "ping"}\n')
                    conn.recv(64)
                break
            except OSError:
                if time.time() > deadline:
                    raise SmokeError("server did not start")
                time.sleep(0.5)
        for i, (label, args, name, (direct_dir, direct)) in enumerate(
                expected):
            if metrics_path.exists():
                metrics_path.unlink()
            outdir = WORK / "server" / f"req{i}"
            res = run_cli(args, corpus(name), outdir,
                          {"SWARM_TPU_SERVER": str(sock)})
            if res[0] != 0:
                raise SmokeError(f"server request {i} failed: "
                                 + res[2].decode("latin-1")[-3000:])
            if not metrics_path.exists() or timing_lines(res[2]):
                raise SmokeError(f"request {i} did not run on the server")
            diff = differences(args, outdir, res, direct_dir, direct)
            if diff:
                raise SmokeError(f"server request {i} != {label}: {diff}")
            log(f"phase 7 request {i} ({label}): ok, byte-identical; "
                f"client wall {res[3]:.3f} s [{card_line}]")
    finally:
        if server.poll() is None:
            try:
                sys.path.insert(0, str(REPO))
                from swarm_tpu.server import shutdown

                shutdown(str(sock))
                server.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                server.kill()
                server.wait()
        server_err.close()


class MemorySampler:
    """Peak memory.used per card from nvidia-smi while a run lasts."""

    def __init__(self):
        self.peak = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            r = subprocess.run(
                ["nvidia-smi", "--query-gpu=index,memory.used",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True)
            for line in r.stdout.splitlines():
                idx, used = (x.strip() for x in line.split(","))
                self.peak[idx] = max(self.peak.get(idx, 0), int(used))
            self._stop.wait(0.5)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def main(argv) -> int:
    multi = "--multi" in argv
    if not (REPO / "swarm_tpu").is_dir() or not (REPO / "bin" / "swarm").exists():
        raise SmokeError("run chip_smoke.py from a checkout of the repository")
    card_line = card()
    log(f"card: {card_line}")
    info = device_info(DEVICE_ENV)
    want = 4 if multi else 1
    if info["count"] < want:
        raise SmokeError(f"needs {want} GPU(s), JAX sees {info['count']}")
    log(f"phase 1: ok, {info}")
    WORK.mkdir(parents=True, exist_ok=True)
    t_all = time.perf_counter()
    if multi:
        env = {**DEVICE_ENV, "XLA_PYTHON_CLIENT_PREALLOCATE": "false"}
        for label, args, name, extra, engines in (
            ("multi d1_1m", ["-d", "1", "-o", "-s", "-w"], "d1_1m",
             {"SWARM_TPU_BACKEND": "jax_shard"},
             {"d1_network": "sortjoin_sharded"}),
            ("multi d1_fastidious", ["-d", "1", "-f", "-o", "-s", "-i",
                                     "-u", "-w"], "d1_200k",
             {"SWARM_TPU_BACKEND": "jax_shard",
              "SWARM_TPU_GRAFT": "sharded"},
             {"d1_network": "sortjoin_sharded", "graft": "sharded"}),
        ):
            with MemorySampler() as mem:
                cli_phase(label, args, name, env, engines, extra, card_line)
            log(f"  peak memory.used per card (MiB): {mem.peak}")
    else:
        d1_run = cli_phase("phase 2 d1_1m", ["-d", "1", "-o", "-s", "-w"],
                           "d1_1m", DEVICE_ENV, {"d1_network": "sortjoin"},
                           {}, card_line)
        cli_phase("phase 3 d1_fastidious",
                  ["-d", "1", "-f", "-o", "-s", "-i", "-u", "-w"],
                  "d1_200k", DEVICE_ENV,
                  {"d1_network": "sortjoin", "graft": "sorted"},
                  {"SWARM_TPU_GRAFT": "sorted"}, card_line)
        d2_run = cli_phase("phase 4 d2_100k", ["-d", "2", "-o", "-s"],
                           "d2_100k", DEVICE_ENV, D2_ENGINES, {}, card_line)
        cli_phase("phase 5 d2_long", ["-d", "2", "-o", "-s"], "d2_long",
                  DEVICE_ENV, D2_ENGINES, {}, card_line)
        kernel_phase(DEVICE_ENV, card_line)
        server_phase(DEVICE_ENV, card_line, [
            ("phase 2", ["-d", "1", "-o", "-s", "-w"], "d1_1m", d1_run),
            ("phase 4", ["-d", "2", "-o", "-s"], "d2_100k", d2_run),
            ("phase 2", ["-d", "1", "-o", "-s", "-w"], "d1_1m", d1_run),
        ])
    log(f"all phases ok in {time.perf_counter() - t_all:.3f} s [{card_line}]")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeError as exc:
        sys.stderr.write(f"chip_smoke: FAILED: {exc}\n")
        sys.exit(1)
