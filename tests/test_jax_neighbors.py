"""Cross-checks: the JAX device d=1 pipeline vs the numpy reference path.

Runs on the CPU backend (conftest forces JAX_PLATFORMS=cpu with 8 virtual
devices) — the same code compiles for the GPU unchanged.
"""

import numpy as np
import pytest

from swarm_tpu.ops.neighbors import NeighborIndex


def _random_db(n, min_len, max_len, seed, with_duplheaders=False):
    """Build a Db-like object directly (bypasses fasta parsing)."""
    from swarm_tpu.db import Db

    rng = np.random.Generator(np.random.PCG64(seed))
    lengths = rng.integers(min_len, max_len + 1, size=n)
    seqs = [rng.integers(0, 4, size=L).astype(np.uint8) for L in lengths]

    # plant guaranteed 1-edit neighbors: for ~1/3 of sequences append a
    # mutated copy of an earlier one
    for i in range(1, n, 3):
        src = seqs[rng.integers(0, i)]
        mutated = src.copy()
        kind = rng.integers(0, 3)
        if kind == 0 and len(mutated) > 1:  # substitution
            p = rng.integers(0, len(mutated))
            mutated[p] = (mutated[p] + 1 + rng.integers(0, 3)) % 4
        elif kind == 1 and len(mutated) > 2:  # deletion
            p = rng.integers(0, len(mutated))
            mutated = np.delete(mutated, p)
        else:  # insertion
            p = rng.integers(0, len(mutated) + 1)
            mutated = np.insert(mutated, p, rng.integers(0, 4))
        seqs[i] = mutated

    # dedupe exact duplicates (d=1 forbids them)
    seen = set()
    uniq = []
    for s in seqs:
        key = s.tobytes()
        if key not in seen:
            seen.add(key)
            uniq.append(s)
    seqs = uniq
    n = len(seqs)

    abundances = rng.integers(1, 100, size=n).astype(np.int64)
    order = np.argsort(-abundances, kind="stable")
    seqs = [seqs[i] for i in order]
    abundances = abundances[order]

    codes = np.concatenate(seqs) if seqs else np.zeros(0, dtype=np.uint8)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    if n:
        np.cumsum(lengths[:-1], out=offsets[1:])

    db = Db()
    db.headers = [f"seq{i}_{abundances[i]}".encode() for i in range(n)]
    db.codes = codes
    db.offsets = offsets
    db.lengths = lengths
    db.abundances = abundances
    db.longest = int(lengths.max()) if n else 0
    db.nucleotides = int(lengths.sum()) if n else 0
    return db


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("no_break", [False, True])
def test_device_network_matches_numpy(seed, no_break):
    db = _random_db(n=300, min_len=20, max_len=90, seed=seed)
    ab = db.abundances.astype(np.uint64)

    idx_np = NeighborIndex(db, backend="numpy")
    ef_np, et_np = idx_np.build_network(no_break, ab)

    from swarm_tpu.ops.neighbors_jax import DeviceNeighborEngine

    engine = DeviceNeighborEngine(db, chunk=64)
    ef_j, et_j = engine.build_network(no_break, ab)

    assert np.array_equal(ef_np, ef_j)
    assert np.array_equal(et_np, et_j)
    assert len(ef_np) > 0  # planted neighbors must be found


def test_device_network_tiny_and_empty():
    from swarm_tpu.ops.neighbors_jax import DeviceNeighborEngine

    db = _random_db(n=2, min_len=5, max_len=8, seed=42)
    ab = db.abundances.astype(np.uint64)
    idx_np = NeighborIndex(db, backend="numpy")
    ef_np, et_np = idx_np.build_network(False, ab)
    engine = DeviceNeighborEngine(db)
    ef_j, et_j = engine.build_network(False, ab)
    assert np.array_equal(ef_np, ef_j)
    assert np.array_equal(et_np, et_j)


def test_device_variant_hashes_distinct_per_variant():
    """Hash pairs of distinct variants of one sequence should differ
    (sanity: the 2x32 scheme has no systematic collisions)."""
    import jax.numpy as jnp

    from swarm_tpu.ops.neighbors_jax import (
        make_zobrist_pair,
        variant_hashes_device,
    )

    rng = np.random.Generator(np.random.PCG64(7))
    L = 64
    padded = rng.integers(0, 4, size=(4, L)).astype(np.uint8)
    lengths = np.full(4, L, dtype=np.int32)
    zob = jnp.asarray(make_zobrist_pair(L))
    _, hashes, valid = variant_hashes_device(
        jnp.asarray(padded), jnp.asarray(lengths), zob
    )
    hashes = np.asarray(hashes)
    valid = np.asarray(valid)
    for i in range(4):
        hs = hashes[i][valid[i]]
        combined = (hs[:, 0].astype(np.uint64) << np.uint64(32)) | hs[
            :, 1
        ].astype(np.uint64)
        assert len(np.unique(combined)) == len(combined)


def test_sharded_network_matches_numpy():
    """shard_map over the 8-device virtual CPU mesh == numpy network."""
    import jax

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    from swarm_tpu.parallel.mesh import ShardedNeighborEngine

    db = _random_db(n=500, min_len=30, max_len=70, seed=11)
    ab = db.abundances.astype(np.uint64)

    idx_np = NeighborIndex(db, backend="numpy")
    ef_np, et_np = idx_np.build_network(False, ab)

    engine = ShardedNeighborEngine(db, chunk=128)
    ef_s, et_s = engine.build_network(False, ab)

    assert np.array_equal(ef_np, ef_s)
    assert np.array_equal(et_np, et_s)
    assert len(ef_np) > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("no_break", [False, True])
def test_sortjoin_network_matches_numpy(seed, no_break):
    from swarm_tpu.ops.neighbors_sortjoin import SortJoinNeighborEngine

    db = _random_db(n=400, min_len=20, max_len=90, seed=seed)
    ab = db.abundances.astype(np.uint64)

    idx_np = NeighborIndex(db, backend="numpy")
    ef_np, et_np = idx_np.build_network(no_break, ab)

    engine = SortJoinNeighborEngine(db)
    ef_j, et_j = engine.build_network(no_break, ab)

    assert np.array_equal(ef_np, ef_j)
    assert np.array_equal(et_np, et_j)
    assert len(ef_np) > 0


def test_verify_dist1_cases():
    from swarm_tpu.ops.neighbors_sortjoin import verify_dist1

    #           0: base          1: sub @2        2: del @1       3: ins @3
    seqs = [
        [0, 1, 2, 3, 0, 1],
        [0, 1, 3, 3, 0, 1],
        [0, 2, 3, 0, 1],
        [0, 1, 2, 2, 3, 0, 1],
        [0, 1, 2, 3, 0, 1],  # 4: dup of 0 (dist 0)
        [3, 2, 1, 0, 3, 2],  # 5: far away
        [0, 1, 2, 3],        # 6: prefix of 0 (dist 2)
        [0, 1, 2, 3, 0],     # 7: 0 minus last base (dist 1, del at end)
    ]
    width = 8
    padded = np.zeros((len(seqs), width), dtype=np.uint8)
    lengths = np.zeros(len(seqs), dtype=np.int64)
    for i, s in enumerate(seqs):
        padded[i, : len(s)] = s
        lengths[i] = len(s)

    a = np.array([0, 0, 0, 0, 0, 0])
    b = np.array([1, 2, 3, 5, 6, 7])
    got = verify_dist1(padded, lengths, a, b)
    assert got.tolist() == [True, True, True, False, False, True]


@pytest.mark.parametrize("seed", [0, 3])
def test_device_graft_matches_numpy(seed):
    """Device fastidious graft join == host _graft_join."""
    from swarm_tpu.models.d1 import _graft_join
    from swarm_tpu.ops.fastidious_jax import GraftEngine
    from swarm_tpu.ops.neighbors import NeighborIndex, pad_codes
    from swarm_tpu.ops.neighbors_jax import _round_up, make_zobrist_pair

    db = _random_db(n=250, min_len=20, max_len=60, seed=seed)
    n = len(db)
    rng = np.random.Generator(np.random.PCG64(seed + 99))
    light_mask = rng.random(n) < 0.4
    light_amps = np.nonzero(light_mask)[0]
    heavy_amps = np.nonzero(~light_mask)[0]

    index = NeighborIndex(db, backend="numpy")
    count_np, cand_np = _graft_join(db, index, heavy_amps, light_amps)

    width = _round_up(index.max_len, 64)
    padded_w = pad_codes(db.codes, db.offsets, db.lengths, width)
    eng = GraftEngine(
        padded_w, db.lengths.astype(np.int32), make_zobrist_pair(width)
    )
    count_dev, cand_dev = eng.graft_candidates(heavy_amps, light_amps)

    assert count_dev == count_np
    assert np.array_equal(cand_np, cand_dev)
    assert count_np > 0  # the planted clouds must produce grafts


def test_distributed_sortjoin_matches_numpy():
    """all_to_all range-partitioned sort-join on the 8-device CPU mesh
    == numpy network."""
    import jax

    assert len(jax.devices()) == 8
    from swarm_tpu.parallel.mesh import SortJoinShardedEngine

    db = _random_db(n=600, min_len=25, max_len=80, seed=21)
    ab = db.abundances.astype(np.uint64)

    ef_np, et_np = NeighborIndex(db, backend="numpy").build_network(False, ab)

    engine = SortJoinShardedEngine(db)
    ef_s, et_s = engine.build_network(False, ab)

    assert np.array_equal(ef_np, ef_s)
    assert np.array_equal(et_np, et_s)
    assert len(ef_np) > 0


def test_device_graft_strips_match_single_pass():
    """Strip-processing a large light side gives identical results."""
    from swarm_tpu.ops.fastidious_jax import GraftEngine
    from swarm_tpu.ops.neighbors import pad_codes
    from swarm_tpu.ops.neighbors_jax import _round_up, make_zobrist_pair

    db = _random_db(n=300, min_len=20, max_len=50, seed=5)
    n = len(db)
    rng = np.random.Generator(np.random.PCG64(55))
    light_mask = rng.random(n) < 0.5
    light_amps = np.nonzero(light_mask)[0]
    heavy_amps = np.nonzero(~light_mask)[0]

    from swarm_tpu.ops.neighbors import NeighborIndex

    index = NeighborIndex(db, backend="numpy")
    width = _round_up(index.max_len, 64)
    padded_w = pad_codes(db.codes, db.offsets, db.lengths, width)
    eng = GraftEngine(
        padded_w, db.lengths.astype(np.int32), make_zobrist_pair(width)
    )
    c1, g1 = eng.graft_candidates(heavy_amps, light_amps)
    eng.MAX_LIGHT_KEYS = 1  # force many strips (floor = CHUNK amps)
    eng.CHUNK = 64
    c2, g2 = eng.graft_candidates(heavy_amps, light_amps)
    assert c1 == c2
    assert np.array_equal(g1, g2)
    assert c1 > 0


def test_sortjoin_window_retry_long_runs():
    """>window sequences sharing one deletion string must still pair
    (the run-length overflow check escalates the window)."""
    from swarm_tpu.db import Db
    from swarm_tpu.ops.neighbors import NeighborIndex
    from swarm_tpu.ops.neighbors_sortjoin import SortJoinNeighborEngine

    rng = np.random.Generator(np.random.PCG64(77))
    base = rng.integers(0, 4, size=40).astype(np.uint8)
    seqs = [base]
    # 30 distinct single-insertions of base: all share key hash(base)
    seen = {base.tobytes()}
    while len(seqs) < 31:
        p = int(rng.integers(0, len(base) + 1))
        b = int(rng.integers(0, 4))
        v = np.insert(base, p, b)
        if v.tobytes() not in seen:
            seen.add(v.tobytes())
            seqs.append(v)

    n = len(seqs)
    db = Db()
    db.headers = [f"s{i}_{n - i}".encode() for i in range(n)]
    db.codes = np.concatenate(seqs)
    db.lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    db.offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(db.lengths[:-1], out=db.offsets[1:])
    db.abundances = np.arange(n, 0, -1).astype(np.int64)
    db.longest = int(db.lengths.max())
    db.nucleotides = int(db.lengths.sum())

    ab = db.abundances.astype(np.uint64)
    ef_np, et_np = NeighborIndex(db, backend="numpy").build_network(False, ab)
    eng = SortJoinNeighborEngine(db)
    ef_j, et_j = eng.build_network(False, ab)
    assert np.array_equal(ef_np, ef_j)
    assert np.array_equal(et_np, et_j)
    # all insertions are dist-1 from base: the run is 31 long
    assert len(ef_np) >= 30


def test_distributed_sortjoin_single_device():
    """The sharded engine degenerates correctly to one device (the
    single-chip hardware case)."""
    import jax
    from jax.sharding import Mesh

    from swarm_tpu.parallel.mesh import SortJoinShardedEngine

    db = _random_db(n=200, min_len=20, max_len=60, seed=31)
    ab = db.abundances.astype(np.uint64)
    ef_np, et_np = NeighborIndex(db, backend="numpy").build_network(False, ab)

    mesh = Mesh(np.array(jax.devices()[:1]), ("amps",))
    engine = SortJoinShardedEngine(db, mesh=mesh)
    ef_s, et_s = engine.build_network(False, ab)
    assert np.array_equal(ef_np, ef_s)
    assert np.array_equal(et_np, et_s)


def test_bucketed_join_matches_single():
    """Width-bucketed multi-table join == single-table join on a
    mixed-length corpus with planted cross-bucket 1-edit pairs."""
    import numpy as np

    from swarm_tpu.ops.neighbors_sortjoin import (
        BucketedSortJoinEngine,
        SortJoinNeighborEngine,
    )

    rng = np.random.default_rng(71)
    seqs = []
    # short cloud (bucket 64)
    base = rng.integers(0, 4, size=50).astype(np.uint8)
    for _ in range(40):
        v = base.copy()
        for _ in range(int(rng.integers(0, 2))):
            v[rng.integers(0, len(v))] = rng.integers(0, 4)
        seqs.append(v)
    # boundary pair: length 64 (bucket 64) and its 65-nt insertion
    # (bucket 256) — the cross-bucket case
    b = rng.integers(0, 4, size=64).astype(np.uint8)
    seqs.append(b)
    seqs.append(np.insert(b, 30, 2).astype(np.uint8))
    # long reads (bucket 1024) with a 1-sub pair
    L = rng.integers(0, 4, size=900).astype(np.uint8)
    L2 = L.copy()
    L2[500] = (L2[500] + 1) % 4
    seqs.extend([L, L2])
    # dedupe
    uniq, seen = [], set()
    for s in seqs:
        if s.tobytes() not in seen:
            seen.add(s.tobytes())
            uniq.append(s)
    seqs = uniq

    from swarm_tpu.db import Db

    db = Db()
    n = len(seqs)
    db.headers = [f"q{i}_1".encode() for i in range(n)]
    db.codes = np.concatenate(seqs)
    db.lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    db.offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(db.lengths[:-1], out=db.offsets[1:])
    db.abundances = rng.integers(1, 9, size=n).astype(np.int64)
    db.longest = int(db.lengths.max())
    db.nucleotides = int(db.lengths.sum())

    assert BucketedSortJoinEngine.worthwhile(db.lengths)
    ab = db.abundances
    want = SortJoinNeighborEngine(db).build_network(False, ab)
    got = BucketedSortJoinEngine(db).build_network(False, ab)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the planted cross-bucket pair must be present
    i64, i65 = n - 4, n - 3
    pairs = set(zip(want[0].tolist(), want[1].tolist()))
    assert (i64, i65) in pairs or (i65, i64) in pairs


def test_verify_dist1_packed_matches_oracle():
    """The packed-word verifier == the numpy byte oracle on randomized
    pairs covering every relation class and word-boundary lengths."""
    import jax.numpy as jnp
    from swarm_tpu.ops.neighbors_sortjoin import (
        _verify_dist1_packed,
        pack2bit,
        verify_dist1,
    )

    rng = np.random.default_rng(11)
    rows, lens = [], []

    def add(seq):
        rows.append(list(seq))
        lens.append(len(seq))
        return len(rows) - 1

    pairs = []
    # lengths crossing uint32-word boundaries (16 bases/word)
    for L in [1, 2, 5, 15, 16, 17, 31, 32, 33, 47, 48, 90]:
        base = rng.integers(0, 4, size=L).tolist()
        i0 = add(base)
        # substitution at a random position (incl. first/last)
        for p in {0, L - 1, int(rng.integers(0, L))}:
            s = list(base)
            s[p] = (s[p] + 1 + int(rng.integers(0, 3))) % 4
            pairs.append((i0, add(s), True))
        # deletion at a random position and at both ends
        if L > 1:
            for p in {0, L - 1, int(rng.integers(0, L))}:
                s = base[:p] + base[p + 1 :]
                pairs.append((i0, add(s), True))
        # insertion at both ends and middle
        for p in {0, L, L // 2}:
            s = base[:p] + [int(rng.integers(0, 4))] + base[p:]
            pairs.append((i0, add(s), True))
        # dist-2: two substitutions
        if L >= 2:
            s = list(base)
            s[0] = (s[0] + 1) % 4
            s[L - 1] = (s[L - 1] + 1) % 4
            pairs.append((i0, add(s), False))
        # identical (dist 0) -> False
        pairs.append((i0, add(base), False))
        # length diff 2 (prefix) -> False
        if L > 2:
            pairs.append((i0, add(base[: L - 2]), False))
        # same length, one del + one ins elsewhere (dist 2, same len)
        if L >= 4:
            s = base[1:] + [(base[0] + 2) % 4]
            pairs.append((i0, add(s), None))  # oracle decides

    width = ((max(lens) + 15) // 16) * 16
    padded = np.zeros((len(rows), width), dtype=np.uint8)
    lengths = np.zeros(len(rows), dtype=np.int64)
    for i, s in enumerate(rows):
        padded[i, : len(s)] = s
        lengths[i] = len(s)

    a = np.array([p[0] for p in pairs])
    b = np.array([p[1] for p in pairs])
    want = verify_dist1(padded, lengths, a, b)
    for (_, _, expect), w in zip(pairs, want):
        if expect is not None:
            assert bool(w) == expect

    packed = jnp.asarray(pack2bit(padded))
    got = np.asarray(
        _verify_dist1_packed(
            packed[a], packed[b],
            jnp.asarray(lengths[a], jnp.int32),
            jnp.asarray(lengths[b], jnp.int32),
        )
    )
    assert got.tolist() == want.tolist()
