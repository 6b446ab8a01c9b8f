"""Device forward-tracked diff kernel vs the native oracle.

The d2_diffs_jax kernel must reproduce _native.d2_diffs_pairs (the
16-lane AVX-512 banded DP + backtrack) exactly — same accepts, same
diff values — because the d>=2 engine's structure rows and attachment
order consume them. DNA's 4-letter alphabet makes cost ties dense, so
randomized corpora exercise every tie-break branch.
"""

import io

import numpy as np
import pytest

from swarm_tpu import _native
from swarm_tpu.db import db_read
from swarm_tpu.params import Parameters
from swarm_tpu.progress import Progress

pytestmark = pytest.mark.skipif(
    not _native.available(), reason="native kernels unavailable"
)


def _mkdb(tmp_path, records):
    path = tmp_path / "in.fasta"
    path.write_text("".join(records))
    p = Parameters()
    p.input_filename = str(path)
    p.logfile = io.StringIO()
    return db_read(p, Progress(io.StringIO(), True))


def _chain_corpus(seed, n, length, edits):
    rng = np.random.default_rng(seed)
    seqs = []
    seen = set()
    base = rng.integers(0, 4, size=length).astype(np.uint8)
    pool = [base]
    while len(seqs) < n:
        v = pool[int(rng.integers(0, len(pool)))].copy()
        for _ in range(int(rng.integers(1, edits + 1))):
            op = int(rng.integers(0, 3))
            pos = int(rng.integers(0, len(v)))
            if op == 0:
                v = v.copy()
                v[pos] = (v[pos] + 1 + rng.integers(0, 3)) % 4
            elif op == 1 and len(v) > 12:
                v = np.delete(v, pos)
            else:
                v = np.insert(v, pos, rng.integers(0, 4))
        key = v.tobytes()
        if key in seen:
            continue
        seen.add(key)
        pool.append(v)
        seqs.append(v)
    return [
        f">t{i}_{int(rng.integers(1, 500))}\n"
        + "".join("ACGT"[c] for c in s) + "\n"
        for i, s in enumerate(seqs)
    ]


@pytest.mark.parametrize(
    "seed,d,scores",
    [
        (1, 2, (4, 12, 4)),
        (2, 2, (4, 12, 4)),
        (3, 3, (4, 12, 4)),
        (4, 2, (2, 2, 2)),   # gap-open == extend: dense b4/b8 ties
        (5, 4, (1, 1, 1)),   # everything ties
        (6, 2, (9, 3, 1)),
    ],
)
def test_device_diffs_match_native(tmp_path, seed, d, scores):
    mismatch, go, ge = scores
    db = _mkdb(tmp_path, _chain_corpus(seed, 80, 60, d + 1))
    n = len(db)
    # all pairs within band reach: the kernel must agree on BOTH the
    # accept decision and the diff value for every candidate
    pa, pb = np.triu_indices(n, k=1)
    pa = pa.astype(np.int64)
    pb = pb.astype(np.int64)
    for no_break in (False, True):
        want_ab, want_ba = _native.d2_diffs_pairs(
            db.codes, db.offsets, db.lengths, db.abundances, pa, pb,
            d, mismatch, go, ge, no_break, nthreads=1,
        )
        from swarm_tpu.ops.d2_diffs_jax import DeviceDiffEngine

        eng = DeviceDiffEngine(db, d)
        got_ab, got_ba = eng.diffs_pairs(pa, pb, mismatch, go, ge, no_break)
        np.testing.assert_array_equal(got_ab, want_ab)
        np.testing.assert_array_equal(got_ba, want_ba)


@pytest.mark.parametrize(
    "length,lmax,d,scores",
    [
        (176, 192, 2, (4, 12, 4)),  # the d=2 benchmark width
        (424, 448, 2, (4, 12, 4)),  # the long-amplicon width
        (60, 64, 9, (3, 1, 2)),     # band B == MAX_BAND, the kernel's limit
    ],
)
def test_device_diffs_match_native_at_width(tmp_path, length, lmax, d,
                                            scores):
    from swarm_tpu.ops.d2_diffs_jax import DeviceDiffEngine
    from swarm_tpu.ops.d2_diffs_kernel import MAX_BAND

    mismatch, go, ge = scores
    db = _mkdb(tmp_path, _chain_corpus(length, 24, length, d + 1))
    eng = DeviceDiffEngine(db, d)
    assert eng.Lmax == lmax
    B = eng.band_for_exact(d * max(mismatch, go + ge), go, ge)
    assert B <= MAX_BAND and (d != 9 or B == MAX_BAND)
    pa, pb = np.triu_indices(len(db), k=1)
    pa = pa.astype(np.int64)
    pb = pb.astype(np.int64)
    want_ab, want_ba = _native.d2_diffs_pairs(
        db.codes, db.offsets, db.lengths, db.abundances, pa, pb,
        d, mismatch, go, ge, True, nthreads=1,
    )
    got_ab, got_ba = eng.diffs_pairs(pa, pb, mismatch, go, ge, True)
    assert (want_ab >= 0).any()
    np.testing.assert_array_equal(got_ab, want_ab)
    np.testing.assert_array_equal(got_ba, want_ba)


def test_engine_cli_parity_with_device_diffs(tmp_path, monkeypatch):
    """The network engine produces identical edges with either diff
    backend (device kernel forced on the CPU backend here)."""
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "64")
    db = _mkdb(tmp_path, _chain_corpus(11, 120, 70, 3))
    from swarm_tpu.ops.d2_network import D2NetworkEngine

    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "native")
    e1 = D2NetworkEngine(db, 2, threads=1)
    r1 = e1.build_adjacency(4, 12, 4, False)
    monkeypatch.setenv("SWARM_TPU_D2_DIFFS", "device")
    e2 = D2NetworkEngine(db, 2, threads=1)
    r2 = e2.build_adjacency(4, 12, 4, False)
    for a, b in zip(r1[:4], r2[:4]):
        np.testing.assert_array_equal(a, b)
