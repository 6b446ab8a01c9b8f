"""Parity of the d>=2 network engine (bulk int8 qgram join + graph
clustering replay) against the reference binary and the native engine.

The engine reformulates src/algo.cc's per-seed loop as edge discovery
(all pairs, sound lower-bound screens, exact diffs) + an
order-preserving graph replay (swarm_native.c: algo_cluster_graph);
these tests force it on (SWARM_TPU_D2_ENGINE=network) with a small
device tile so the multi-tile scan path runs on the CPU backend.
"""

import os

import numpy as np
import pytest

from genfasta import amplicon_cloud

ALL_OUTPUTS = [
    "-o", "out.txt",
    "-s", "stats.txt",
    "-u", "uclust.txt",
    "-i", "structure.txt",
    "-w", "seeds.fasta",
    "-l", "log.txt",
]


@pytest.fixture(autouse=True)
def _force_network_engine(monkeypatch):
    monkeypatch.setenv("SWARM_TPU_D2_ENGINE", "network")
    monkeypatch.setenv("SWARM_TPU_D2_TILE", "128")


@pytest.mark.parametrize("seed", [41, 42])
def test_network_d2_all_outputs(both, seed):
    fasta = amplicon_cloud(
        seed=seed, n_centers=6, cloud_size=20, length=70, max_edits=3
    )
    both.compare(["-d", "2"] + ALL_OUTPUTS, fasta)


def test_network_d3(both):
    fasta = amplicon_cloud(
        seed=43, n_centers=4, cloud_size=15, length=60, max_edits=4
    )
    both.compare(["-d", "3"] + ALL_OUTPUTS, fasta)


def test_network_no_otu_breaking(both):
    fasta = amplicon_cloud(
        seed=44, n_centers=4, cloud_size=12, length=50, max_edits=3
    )
    both.compare(["-d", "2", "-n"] + ALL_OUTPUTS, fasta)


def test_network_equal_abundances(both):
    # every abundance equal: both edge directions exist everywhere,
    # exercising the per-direction diff computation and tie ordering
    rng = np.random.default_rng(45)
    recs = []
    seqs = set()
    base = rng.integers(0, 4, size=50)
    for i in range(60):
        v = base.copy()
        for _ in range(rng.integers(1, 4)):
            v[rng.integers(0, len(v))] = rng.integers(0, 4)
        key = v.tobytes()
        if key in seqs:
            continue
        seqs.add(key)
        recs.append(f">s{i}_3\n" + "".join("ACGT"[c] for c in v) + "\n")
    both.compare(["-d", "2"] + ALL_OUTPUTS, "".join(recs))


def test_network_multi_tile(both):
    # > 3 tiles at the test tile size: the tile-pair scan, the
    # cross-tile upper-triangle masking, and the buffer accumulation
    fasta = amplicon_cloud(
        seed=46, n_centers=30, cloud_size=18, length=64, max_edits=3
    )
    both.compare(["-d", "2", "-o", "out.txt", "-s", "stats.txt",
                  "-l", "log.txt"], fasta)


def test_network_custom_scores(both):
    fasta = amplicon_cloud(
        seed=47, n_centers=4, cloud_size=10, length=50, max_edits=3
    )
    both.compare(
        ["-d", "2", "-m", "2", "-p", "3", "-g", "6", "-e", "2"] + ALL_OUTPUTS,
        fasta,
    )


def test_network_16bit_falls_back(both):
    # d high enough to force the 16-bit kernel: the network engine must
    # silently fall back to the native engine (the artifact's diffs are
    # schedule-dependent) and stay byte-identical
    fasta = amplicon_cloud(
        seed=48, n_centers=2, cloud_size=10, length=50, max_edits=8
    )
    both.compare(["-d", "30"] + ALL_OUTPUTS, fasta)


def _db_from_seqs(seqs):
    from swarm_tpu.db import Db

    n = len(seqs)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    codes = np.concatenate(seqs).astype(np.uint8) if n else np.zeros(0, np.uint8)
    db = Db()
    db.headers = [f"seq{i}_1".encode() for i in range(n)]
    db.codes = codes
    db.offsets = offsets
    db.lengths = lengths
    db.abundances = np.ones(n, dtype=np.int64)
    db.longest = int(lengths.max()) if n else 0
    db.nucleotides = int(lengths.sum()) if n else 0
    return db


def test_extract_pairs_high_step_no_int32_overflow():
    """Regression: survivor bits past global position 2^31 decode exactly.

    Round-4 bug (d2_network.py extract_pairs): the decode formed the
    global bit position pos = widx*32 + bit in int32, which wraps once
    step*T^2 exceeds 2^31 — at the serving tile (T=4096) that is ~61k
    amplicons, where wrapped positions decoded to garbage pairs
    (crash, or silently dropped true late-step edges). Plant bits in a
    late step so the old decode would wrap, and check exact (ga, gb).
    """
    import jax.numpy as jnp

    from swarm_tpu.ops.d2_network import extract_pairs

    T = 512
    W = T * T // 32  # 8192 words per step
    K = 8400  # step 8300: widx*32 ~ 2.18e9 > 2^31 under the old decode
    words = np.zeros((K, W), dtype=np.uint32)
    planted = [
        (3, 17, 5),  # early step (sanity: below the wrap point)
        (8300, 8000, 31),  # old pos = (8300*8192+8000)*32+31, wraps
        (8399, 8191, 31),  # the very last representable bit
    ]
    for k, w, b in planted:
        words[k, w] |= np.uint32(1) << np.uint32(b)
    tis = np.arange(K, dtype=np.int32) % 11
    tjs = np.arange(K, dtype=np.int32) % 13
    ga, gb, n_s, n_w, n_c = extract_pairs(
        jnp.asarray(words), jnp.asarray(tis), jnp.asarray(tjs),
        T=T, caps=16, capw=16, capc=16,
    )
    assert int(n_c) == len(planted)
    got = list(zip(
        np.asarray(ga)[: len(planted)].tolist(),
        np.asarray(gb)[: len(planted)].tolist(),
    ))
    want = []
    for k, w, b in planted:
        wt = w * 32 + b
        want.append((int(tis[k]) * T + wt // T, int(tjs[k]) * T + wt % T))
    assert got == want


def test_sharded_screen_matches_single_device():
    """candidate_pairs_sharded over the 8-device virtual mesh produces
    the same pairs, in the same order, as the single-device path."""
    import jax
    from jax.sharding import Mesh

    os.environ.setdefault("SWARM_TPU_D2_TILE", "128")
    from swarm_tpu.ops.d2_network import D2NetworkEngine

    rng = np.random.default_rng(50)
    seqs = []
    for _ in range(40):
        base = rng.integers(0, 4, size=64).astype(np.uint8)
        for _ in range(16):
            v = base.copy()
            for _ in range(int(rng.integers(0, 4))):
                v[rng.integers(0, len(v))] = rng.integers(0, 4)
            seqs.append(v)
    db = _db_from_seqs(seqs)
    eng = D2NetworkEngine(db, 2)
    pa1, pb1, tot1 = eng.candidate_pairs()

    mesh = Mesh(np.array(jax.devices()[:8]), ("amps",))
    pa2, pb2, tot2 = eng.candidate_pairs_sharded(mesh)
    assert tot1 == tot2
    assert np.array_equal(pa1, pa2)
    assert np.array_equal(pb1, pb2)


def test_sharded_engine_full_adjacency():
    """The full sharded build_adjacency equals the single-device CSR."""
    import jax
    from jax.sharding import Mesh

    os.environ.setdefault("SWARM_TPU_D2_TILE", "128")
    from swarm_tpu.ops.d2_network import D2NetworkEngine

    rng = np.random.default_rng(51)
    seqs = []
    for _ in range(20):
        base = rng.integers(0, 4, size=50).astype(np.uint8)
        for _ in range(14):
            v = base.copy()
            for _ in range(int(rng.integers(0, 3))):
                v[rng.integers(0, len(v))] = rng.integers(0, 4)
            seqs.append(v)
    db = _db_from_seqs(seqs)
    single = D2NetworkEngine(db, 2)
    a1 = single.build_adjacency(4, 12, 4, False)

    sharded = D2NetworkEngine(db, 2)
    sharded.mesh = Mesh(np.array(jax.devices()[:8]), ("amps",))
    a2 = sharded.build_adjacency(4, 12, 4, False)
    for x, y in zip(a1, a2):
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y)
        else:
            assert x == y


def test_qgram_join_matches_host_bound():
    """Device tile-pair survivors == host qgram+length screen."""
    os.environ.setdefault("SWARM_TPU_D2_TILE", "128")
    from swarm_tpu.ops.d2_network import D2NetworkEngine
    from swarm_tpu.ops.qgram import qgram_profiles
    from swarm_tpu.ops.neighbors import pad_codes

    rng = np.random.default_rng(49)
    seqs = []
    for _ in range(8):
        base = rng.integers(0, 4, size=60).astype(np.uint8)
        for _ in range(12):
            v = base.copy()
            for _ in range(int(rng.integers(0, 5))):
                v[rng.integers(0, len(v))] = rng.integers(0, 4)
            seqs.append(v)
    db = _db_from_seqs(seqs)
    d = 2
    eng = D2NetworkEngine(db, d)
    pa, pb, total = eng.candidate_pairs()
    got = set(zip(pa.tolist(), pb.tolist()))

    padded = pad_codes(db.codes, db.offsets, db.lengths, int(db.longest))
    profiles = qgram_profiles(padded, db.lengths)
    n = len(db)
    want = set()
    for i in range(n):
        x = profiles[i][None, :] ^ profiles[i + 1 :]
        diffs = np.bitwise_count(x).sum(axis=1)
        mind = (diffs + 9) // 10
        for rel in np.nonzero(
            (mind <= d)
            & (np.abs(db.lengths[i + 1 :] - db.lengths[i]) <= d)
        )[0]:
            want.add((i, i + 1 + int(rel)))
    assert got == want
