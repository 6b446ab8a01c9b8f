#!/usr/bin/env python3
"""Benchmark: the BASELINE.md config matrix on the GPU.

Prints ONE JSON line whose headline metric is the north-star config
(1M amplicons, d=1) and whose "configs" object carries the full matrix:

  {"metric": "d1_cluster_amps_per_s", "value": N, "unit": "amplicons/s",
   "device": {"platform": "gpu", "kind": ..., "count": N},
   "card": "<nvidia-smi name, power.limit>", "configs": {...}}

Per config we report:
  warm_s           swarm_tpu in-process wall, best of 2 after a warm-up
                   run (XLA executables compiled/loaded once: the
                   serving model; the persistent compile cache gives
                   fresh CLI processes the same executables)
  comparisons_per_s candidate pairs examined per second (warm run; see
                   swarm_tpu/metrics.py for what counts)
  ref_s, vs_baseline, parity
                   only when SWARM_TPU_REF_BIN names a built reference
                   swarm binary: its wall (best of 3, all host cores via
                   -t), ref_s / warm_s, and byte parity of the outputs

The benchmark runs in one process, so only it holds the card; it fails
unless JAX runs on a GPU. Environment knobs: SWARM_TPU_BENCH_CONFIGS
(comma list; default all), SWARM_TPU_BENCH_N (override headline corpus
size), SWARM_TPU_BENCH_BACKEND (jax|jax_probe|jax_shard|numpy).
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / "bench_work"

HEADLINE = "d1_1m"

CONFIGS = {
    # BASELINE.json config 1: d=1 small with seeds output
    "d1_small": dict(n=10_000, length=150, flags=["-d", "1", "-w", "{seeds}"]),
    # config 2: d=1 full output set on 100k
    "d1_full_100k": dict(
        n=100_000, length=150,
        flags=["-d", "1", "-u", "{u}", "-i", "{i}", "-w", "{seeds}"],
    ),
    # config 3: the general path on long amplicons
    "d2_long": dict(n=20_000, length=400, flags=["-d", "2"]),
    # config 4: fastidious with memory-cap flags
    "d1_fastidious": dict(
        n=200_000, length=150, flags=["-d", "1", "-f", "-y", "12"],
    ),
    # config 5 (headline): the 1M corpus; multi-host streaming is
    # exercised separately by __graft_entry__.dryrun_multichip
    "d1_1m": dict(n=1_000_000, length=150, flags=["-d", "1"]),
    # config 6: the d>=2 network path (all-pairs qgram screen as int8
    # matmuls + exact diffs); shares config 2's corpus. Runs LAST: a
    # timeout here cannot cost earlier records.
    "d2_100k": dict(n=100_000, length=150, flags=["-d", "2"]),
}


def log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def reference_binary():
    ref = os.environ.get("SWARM_TPU_REF_BIN")
    return Path(ref) if ref else None


def gen_corpus(path: Path, n: int, length: int, seed: int = 20260816) -> int:
    """Deterministic dereplicated amplicon clouds; returns actual count."""
    rng = np.random.Generator(np.random.Philox(seed))
    cloud = 20
    n_centers = max(1, n // cloud)
    seen = set()
    records = []
    idx = 0
    for _ in range(n_centers):
        L = int(rng.integers(length - 8, length + 9))
        center = rng.integers(0, 4, size=L).astype(np.uint8)
        variants = [center]
        for _ in range(cloud - 1):
            v = variants[int(rng.integers(0, len(variants)))].copy()
            for _ in range(int(rng.integers(1, 3))):
                op = int(rng.integers(0, 3))
                p = int(rng.integers(0, len(v)))
                if op == 0:
                    v = v.copy()
                    v[p] = (v[p] + 1 + rng.integers(0, 3)) % 4
                elif op == 1 and len(v) > 10:
                    v = np.delete(v, p)
                else:
                    v = np.insert(v, p, rng.integers(0, 4))
            variants.append(v)
        for v in variants:
            key = v.tobytes()
            if key in seen:
                continue
            seen.add(key)
            ab = int(rng.integers(1, 1000))
            records.append(f">b{idx}_{ab}\n" + "".join("ACGT"[c] for c in v) + "\n")
            idx += 1
            if idx >= n:
                break
        if idx >= n:
            break
    order = rng.permutation(len(records))
    with open(path, "w") as fh:
        fh.writelines(records[i] for i in order)
    return idx


def corpus_for(name: str, cfg: dict) -> tuple:
    WORK.mkdir(parents=True, exist_ok=True)
    fasta = WORK / f"bench_{cfg['n']}_{cfg['length']}.fasta"
    count_file = WORK / f"{fasta.name}.count"
    if not fasta.exists() or not count_file.exists():
        log(f"[{name}] generating corpus n={cfg['n']} len~{cfg['length']} ...")
        n_actual = gen_corpus(fasta, cfg["n"], cfg["length"])
        count_file.write_text(str(n_actual))
    return fasta, int(count_file.read_text())


def build_args(cfg: dict, tag: str) -> list:
    sub = {
        "seeds": str(WORK / f"{tag}_w.fasta"),
        "u": str(WORK / f"{tag}_u.txt"),
        "i": str(WORK / f"{tag}_i.txt"),
    }
    args = [f.format(**sub) for f in cfg["flags"]]
    args += ["-o", str(WORK / f"{tag}_o.txt"), "-s", str(WORK / f"{tag}_s.txt")]
    return args


def output_files(cfg: dict, tag: str) -> list:
    files = [WORK / f"{tag}_o.txt", WORK / f"{tag}_s.txt"]
    for flag, key in (("-w", "w.fasta"), ("-u", "u.txt"), ("-i", "i.txt")):
        if flag in cfg["flags"]:
            files.append(WORK / f"{tag}_{key.split('.')[0]}.{key.split('.')[1]}")
    return files


def time_reference(ref_bin: Path, fasta: Path, cfg: dict, threads: int) -> float:
    args = [str(ref_bin), "-t", str(threads)] + build_args(cfg, "ref") + [str(fasta)]
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        r = subprocess.run(args, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        dt = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"reference run failed: {args}")
        best = min(best, dt)
    return best


def time_ours_warm(fasta: Path, cfg: dict, backend: str, reps: int = 2) -> tuple:
    os.environ["SWARM_TPU_BACKEND"] = backend
    sys.path.insert(0, str(REPO))
    from swarm_tpu.main import run
    from swarm_tpu import metrics

    argv = build_args(cfg, "ours") + [str(fasta)]
    devnull = open(os.devnull, "w")
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(devnull):
        rc = run(argv, "swarm")
    log(f"  warm-up done in {time.perf_counter() - t0:.1f}s (rc={rc})")
    if rc != 0:
        raise RuntimeError("swarm_tpu warmup failed")
    best = float("inf")
    comparisons = 0
    for _ in range(reps):
        metrics.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(devnull):
            rc = run(argv, "swarm")
        dt = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError("swarm_tpu run failed")
        if dt < best:
            best = dt
            comparisons = metrics.total_comparisons()
    devnull.close()
    return best, comparisons


def check_parity(cfg: dict) -> bool:
    ok = True
    for ref_f in output_files(cfg, "ref"):
        ours_f = WORK / ref_f.name.replace("ref_", "ours_")
        a = ref_f.read_bytes() if ref_f.exists() else None
        b = ours_f.read_bytes() if ours_f.exists() else None
        if a != b:
            log(f"  WARNING: {ref_f.name} differs from reference!")
            ok = False
    return ok


def emit(results: dict, device: dict, card: str) -> None:
    """Print the current record as one JSON line. Called after EVERY
    config so a timeout mid-matrix still leaves a parseable record on
    stdout (the last line printed wins)."""
    head = results.get(HEADLINE) or next(iter(results.values()))
    line = {
        "metric": "d1_cluster_amps_per_s",
        "value": head.get("amps_per_s"),
        "unit": "amplicons/s",
        "vs_baseline": head.get("vs_baseline"),
        "comparisons_per_s": head.get("comparisons_per_s"),
        "device": device,
        "card": card,
        "configs": results,
    }
    print(json.dumps(line), flush=True)


def device_and_card() -> tuple:
    """(platform/kind/count as JAX reports them, nvidia-smi's name and
    power limit); fails unless JAX runs on a GPU."""
    import jax

    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    if device["platform"] != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX runs on {device}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return device, card


def main() -> None:
    # "auto" is the product default: big corpora route to the device
    # engines, small ones to the latency-optimized native host path
    backend = os.environ.get("SWARM_TPU_BENCH_BACKEND", "auto")
    sys.path.insert(0, str(REPO))
    import swarm_tpu.ops.neighbors_jax  # noqa: F401  (compile cache)

    device, card = device_and_card()
    log(f"device {device}, card {card}")
    selected = os.environ.get("SWARM_TPU_BENCH_CONFIGS", "")
    names = [c.strip() for c in selected.split(",") if c.strip()] or list(CONFIGS)
    n_override = os.environ.get("SWARM_TPU_BENCH_N")
    if n_override:
        CONFIGS[HEADLINE]["n"] = int(n_override)

    # headline first: it must land in the record even if the time
    # budget expires on a later config
    if HEADLINE in names:
        names.remove(HEADLINE)
        names.insert(0, HEADLINE)

    threads = os.cpu_count() or 1
    ref_bin = reference_binary()
    results = {}
    for name in names:
        cfg = CONFIGS[name]
        try:
            fasta, n_actual = corpus_for(name, cfg)
            log(f"[{name}] corpus: {n_actual} amplicons")
            entry = {"n": n_actual}
            if ref_bin is not None:
                entry["ref_s"] = round(
                    time_reference(ref_bin, fasta, cfg, threads), 3)
                log(f"[{name}] reference: {entry['ref_s']}s")
            warm, comparisons = time_ours_warm(
                fasta, cfg, backend, reps=3 if name == HEADLINE else 2
            )
            entry["warm_s"] = round(warm, 3)
            entry["amps_per_s"] = round(n_actual / warm, 1)
            if comparisons:
                entry["comparisons_per_s"] = round(comparisons / warm, 1)
            log(f"[{name}] swarm_tpu warm: {entry['warm_s']}s"
                f" ({entry['amps_per_s']:.0f} amps/s)")
            if ref_bin is not None:
                entry["vs_baseline"] = round(entry["ref_s"] / warm, 3)
                entry["parity"] = check_parity(cfg)
            results[name] = entry
        except Exception as exc:  # record the failure, keep the matrix going
            log(f"[{name}] FAILED: {exc!r}")
            results[name] = {"error": repr(exc)}
        emit(results, device, card)


if __name__ == "__main__":
    main()
