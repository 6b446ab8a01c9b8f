"""d=1 neighbor discovery: batched microvariant hashing + sorted hash join.

The reference enumerates, for each amplicon, all canonical 1-edit
microvariants as incrementally-updated Zobrist hashes and probes a hash
table (src/variants.cc:184-249, src/algod1.cc:558-627). Here the same
mathematics is expressed as dense batched array ops — three gathers into
a Zobrist table, XOR prefix/suffix scans, and a binary-search join
against the sorted amplicon hash array — the array formulation (runs
under jit on device; numpy fallback for small inputs).

Canonical variant set of a length-L sequence s (identical to the
reference's enumeration, which guarantees each 1-edit *sequence* is
produced exactly once):
  - substitutions: position p, base b != s[p]                 (3L)
  - deletions: position 0, plus each p>0 with s[p] != s[p-1]  (runs R)
  - insertions: before position 0 any base (4), after each p
    any base b != s[p]                                        (3L + 4)

Because every hash match is verified exactly against the candidate
sequence, hash randomness never affects output (reference SURVEY §3.5).
"""

from typing import Tuple

import os

import numpy as np

_RNG_SEED = 0x5EED5EED


def make_zobrist(max_len: int, seed: int = _RNG_SEED) -> np.ndarray:
    """Zobrist table Z[pos, base] of random uint64, pos in [0, max_len+2)."""
    rng = np.random.Generator(np.random.Philox(seed))
    return rng.integers(0, 1 << 64, size=(max_len + 2, 4), dtype=np.uint64)


def pad_codes(codes: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
              max_len: int) -> np.ndarray:
    """[n, max_len] uint8 matrix of nucleotide codes, zero padded."""
    from .. import _native

    n = len(lengths)
    if _native.available() and n:
        return _native.pad_rows(codes, offsets, lengths, max_len)
    out = np.zeros((n, max_len), dtype=np.uint8)
    for i in range(n):
        out[i, : lengths[i]] = codes[offsets[i] : offsets[i] + lengths[i]]
    return out


def sequence_hashes(padded: np.ndarray, lengths: np.ndarray, zob: np.ndarray) -> np.ndarray:
    """Zobrist hash of each sequence: XOR_p Z[p, s_p]."""
    n, max_len = padded.shape
    pos = np.arange(max_len)
    mask = pos[None, :] < lengths[:, None]
    gathered = zob[pos[None, :], padded]  # [n, L]
    gathered = np.where(mask, gathered, np.uint64(0))
    return np.bitwise_xor.reduce(gathered, axis=1)


def variant_hashes(
    padded: np.ndarray, lengths: np.ndarray, zob: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All canonical 1-edit variant hashes for each sequence.

    Returns (seqhash [n], hashes [n, 7*max_len+4], valid mask).
    Layout (kind-major — fixed, independent of the reference's
    enumeration order, which never affects output; chosen so the device
    kernel builds it from [n, L] segments with no small trailing axes):
      slot = k*L + p for k in [0, 7), p in [0, max_len):
        k in [0, 3): substitution at p with the k-th base != s_p
                     (ascending base order)          — always valid in-range
        k == 3:      deletion at p                   — valid iff run start
        k in [4, 7): insertion after p (new position p+1) with the
                     (k-4)-th base != s_p            — always valid in-range
      slot in [7L, 7L+4): insertion before position 0 with base slot-7L.
    """
    n, max_len = padded.shape
    zero = np.uint64(0)
    pos = np.arange(max_len)
    mask = pos[None, :] < lengths[:, None]  # [n, L]

    g0 = np.where(mask, zob[pos[None, :], padded], zero)  # Z[p, s_p]
    gm1 = np.zeros_like(g0)  # Z[p-1, s_p] for p >= 1
    if max_len > 1:
        gm1[:, 1:] = zob[pos[1:] - 1, padded[:, 1:]]
    gm1 = np.where(mask, gm1, zero)
    gp1 = np.where(mask, zob[(pos + 1)[None, :], padded], zero)  # Z[p+1, s_p]

    seqhash = np.bitwise_xor.reduce(g0, axis=1)  # [n]

    # exclusive prefix XOR of g0: prefix[:, p] = XOR_{q<p} Z[q, s_q]
    prefix = np.zeros((n, max_len), dtype=np.uint64)
    if max_len > 1:
        np.bitwise_xor.accumulate(g0[:, :-1], axis=1, out=prefix[:, 1:])

    # inclusive suffix XOR of gm1: sufdel[:, p] = XOR_{q>=p} Z[q-1, s_q]
    sufdel = np.bitwise_xor.accumulate(gm1[:, ::-1], axis=1)[:, ::-1]
    sufdel = np.concatenate([sufdel, np.zeros((n, 1), dtype=np.uint64)], axis=1)

    # inclusive suffix XOR of gp1: sufins[:, p] = XOR_{q>=p} Z[q+1, s_q]
    sufins = np.bitwise_xor.accumulate(gp1[:, ::-1], axis=1)[:, ::-1]
    sufins = np.concatenate([sufins, np.zeros((n, 1), dtype=np.uint64)], axis=1)

    other3 = _three_of_four(padded)  # [n, L, 3] bases != s_p, ascending

    segs = []
    segs_valid = []

    # substitutions (k = 0..2): h = seqhash ^ Z[p, s_p] ^ Z[p, other3_k]
    for k in range(3):
        zsub = zob[pos[None, :], other3[:, :, k]]
        segs.append(seqhash[:, None] ^ g0 ^ np.where(mask, zsub, zero))
        segs_valid.append(mask)

    # deletion at p (k = 3): prefix[p] ^ sufdel[p+1]; valid iff run start
    dele = prefix ^ sufdel[:, 1:]
    run_start = np.ones((n, max_len), dtype=bool)
    if max_len > 1:
        run_start[:, 1:] = padded[:, 1:] != padded[:, :-1]
    segs.append(dele)
    segs_valid.append(mask & run_start)

    # insertions after p (k = 4..6): incl_prefix[p] ^ Z[p+1, b] ^ sufins[p+1]
    prefix_incl = prefix ^ g0
    for k in range(3):
        zins = zob[(pos + 1)[None, :], other3[:, :, k]]
        segs.append(
            prefix_incl ^ np.where(mask, zins, zero) ^ sufins[:, 1:]
        )
        segs_valid.append(mask)

    # insertions before position 0, any base (4 tail slots)
    bases = np.arange(4, dtype=np.uint8)
    ins0 = zob[0, bases][None, :] ^ sufins[:, 0:1]
    ins0_valid = np.broadcast_to((lengths[:, None] > 0), (n, 4))

    hashes = np.concatenate(segs + [ins0], axis=1)
    valid = np.concatenate(segs_valid + [ins0_valid], axis=1)
    return seqhash, hashes, valid


def _three_of_four(padded: np.ndarray) -> np.ndarray:
    """Indices of the 3 bases != s_p, shape [n, L, 3]."""
    # for s in 0..3, the other three bases in ascending order
    table = np.array(
        [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64
    )
    return table[padded]


def decode_slot(slot: np.ndarray, max_len: int, padded: np.ndarray, amp: np.ndarray):
    """Decode kind-major variant slot ids into (type, pos, base).

    type: 0=substitution, 1=deletion, 2=insertion
    For insertion, pos is the insertion position in the *new* sequence.
    """
    tail = slot >= 7 * max_len
    kind = np.where(tail, 0, slot // max_len)  # 0..6
    p = np.where(tail, 0, slot % max_len)

    var_type = np.where(
        tail, 2, np.where(kind < 3, 0, np.where(kind == 3, 1, 2))
    )
    s_p = padded[amp, p]
    table = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64)
    j = np.where(kind < 3, kind, np.clip(kind - 4, 0, 2))
    other_base = table[s_p, j]

    pos = np.where(tail, 0, np.where(kind < 4, p, p + 1))
    base = np.where(
        tail,
        slot - 7 * max_len,
        np.where(kind == 3, 0, other_base),
    )
    return var_type, pos, base


def verify_candidates(
    padded: np.ndarray,
    lengths: np.ndarray,
    amp: np.ndarray,
    slot: np.ndarray,
    target: np.ndarray,
) -> np.ndarray:
    """Exact check: does variant `slot` of `amp` equal sequence `target`?

    Vectorized equivalent of check_variant (reference src/variants.cc:118-165):
    reconstructs the variant row by index arithmetic and compares.
    """
    if len(amp) == 0:
        return np.zeros(0, dtype=bool)
    n, max_len = padded.shape
    var_type, pos, base = decode_slot(slot, max_len, padded, amp)

    src_len = lengths[amp]
    dst_len = lengths[target]
    expected_len = src_len + np.where(var_type == 1, -1, np.where(var_type == 2, 1, 0))
    ok_len = dst_len == expected_len

    idx = np.arange(max_len)[None, :]
    pos_col = pos[:, None]
    # source index in amp's sequence for each output position
    src_idx = np.where(
        var_type[:, None] == 1,
        idx + (idx >= pos_col),  # deletion: skip pos
        np.where(
            var_type[:, None] == 2,
            idx - (idx > pos_col),  # insertion: shift right after pos
            idx,
        ),
    )
    src_idx = np.clip(src_idx, 0, max_len - 1)
    variant_row = np.take_along_axis(padded[amp], src_idx, axis=1)
    # substitution/insertion: place the new base at pos
    place_base = (var_type != 1)[:, None] & (idx == pos_col)
    variant_row = np.where(place_base, base[:, None].astype(np.uint8), variant_row)

    same = variant_row == padded[target]
    within = idx < dst_len[:, None]
    ok_seq = np.all(same | ~within, axis=1)
    return ok_len & ok_seq


class NeighborIndex:
    """Precomputed padded codes + Zobrist machinery for a database.

    backend selects where the network build runs:
      - "numpy": host arrays (best for small inputs / no device);
      - "jax": the chunked device pipeline (ops/neighbors_jax.py);
      - "auto": jax when the problem is big enough to amortize
        compilation, else numpy. SWARM_TPU_BACKEND overrides.
    """

    # below this much variant-hash work the device path cannot amortize
    # its compile + transfer cost (not yet measured on the GPU)
    AUTO_DEVICE_THRESHOLD = 20_000_000
    #: auto backend: the native host builder owns n below this, the
    #: device join above it (override SWARM_TPU_D1_NATIVE_MAX); the
    #: crossover is not yet measured on the GPU
    NATIVE_MAX = 65_536

    def __init__(self, db, backend: str = "auto", threads: int = 1):
        import os

        self.db = db
        n = len(db)
        self.max_len = max(int(db.longest), 1)
        self.lengths = db.lengths.astype(np.int64)
        self.backend = os.environ.get("SWARM_TPU_BACKEND", backend)
        self.threads = max(int(threads), 1)
        self._engine = None
        self._padded = None
        self._zob = None

    # the numpy fallback / fastidious machinery needs these; the device
    # engines build their own — keep them lazy so the fast path skips
    # the host-side construction entirely
    @property
    def padded(self) -> np.ndarray:
        if self._padded is None:
            db = self.db
            self._padded = pad_codes(
                db.codes, db.offsets, db.lengths, self.max_len
            )
        return self._padded

    @property
    def zob(self) -> np.ndarray:
        if self._zob is None:
            self._zob = make_zobrist(self.max_len)
        return self._zob

    def seq_hashes(self) -> np.ndarray:
        return sequence_hashes(self.padded, self.lengths, self.zob)

    def prefetch(self) -> None:
        """Start the (async) device upload early so it overlaps the
        host phases that run before the network build."""
        import os as _os

        from .. import _native

        requested = _os.environ.get("SWARM_TPU_BACKEND", "auto")
        native_max = int(
            _os.environ.get("SWARM_TPU_D1_NATIVE_MAX", str(self.NATIVE_MAX))
        )
        if (
            _native.available()
            and requested == "auto"
            and len(self.lengths) < native_max
        ):
            return  # the host path will run: skip the device upload
        if self._resolve_backend() == "jax":
            from .neighbors_sortjoin import SortJoinNeighborEngine

            self._engine = SortJoinNeighborEngine(self.db)
            self._engine._device_arrays()  # device_put is async

    def start_network(self) -> None:
        """Dispatch the device join BEFORE the hashing phase: the sort
        runs on the device while the host does the duplicate-sequence
        check, so the two costs overlap instead of adding. Only the
        single-table jax sort-join path dispatches; everything else is
        a no-op (the host engines have no async story, and a fatal in
        the hashing phase just abandons the speculative work with no
        output-stream difference)."""
        import os as _os

        from .. import _native

        requested = _os.environ.get("SWARM_TPU_BACKEND", "auto")
        native_max = int(
            _os.environ.get("SWARM_TPU_D1_NATIVE_MAX", str(self.NATIVE_MAX))
        )
        if _native.available() and (
            requested == "auto" and len(self.lengths) < native_max
        ):
            return  # the native host builder will run
        if self._resolve_backend() != "jax":
            return
        from .neighbors_sortjoin import BucketedSortJoinEngine

        bucket_env = _os.environ.get("SWARM_TPU_D1_BUCKETS", "")
        if bucket_env == "1" or (
            bucket_env != "0"
            and BucketedSortJoinEngine.worthwhile(self.lengths)
        ):
            return  # bucketed path: no pre-dispatch (rare shape)
        from .neighbors_sortjoin import SortJoinNeighborEngine

        if self._engine is None:
            self._engine = SortJoinNeighborEngine(self.db)
        self._engine.start()

    def _resolve_backend(self) -> str:
        if self.backend in ("numpy", "jax", "jax_probe", "jax_shard"):
            return self.backend
        n = len(self.lengths)
        work = n * (7 * self.max_len + 4)
        if work >= self.AUTO_DEVICE_THRESHOLD:
            from ..device import use_device_engines

            if use_device_engines():
                return "jax"
            # CPU-only jax: the native host engines beat CPU-XLA
        return "numpy"

    def build_network(self, no_break: bool, abundances: np.ndarray):
        """Return (edges_from, edges_to): all pairs dist(a,b)==1 with the
        abundance rule applied (ab[a] >= ab[b] unless no_break), a != b.

        Edge lists are returned sorted by (from, to).
        """
        n = len(self.lengths)
        if n == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        backend = self._resolve_backend()
        from .. import _native, metrics

        requested = os.environ.get("SWARM_TPU_BACKEND", "auto")
        native_max = int(
            os.environ.get("SWARM_TPU_D1_NATIVE_MAX", str(self.NATIVE_MAX))
        )
        if _native.available() and (
            backend == "numpy"
            or (requested == "auto" and n < native_max)
        ):
            # latency-optimized host path (same edge contract)
            ef, et = _native.d1_network(
                self.db.codes, self.db.offsets, self.db.lengths,
                np.asarray(abundances, dtype=np.int64), no_break,
                nthreads=self.threads,
            )
            metrics.record(d1_join_comparisons=int(len(ef)))
            metrics.engine(d1_network="native")
            return ef, et
        if backend == "jax":
            from .neighbors_sortjoin import (
                BucketedSortJoinEngine,
                SentinelCollision,
                SortJoinNeighborEngine,
            )

            bucket_env = os.environ.get("SWARM_TPU_D1_BUCKETS", "")
            use_buckets = (
                bucket_env == "1"
                or (
                    bucket_env != "0"
                    and BucketedSortJoinEngine.worthwhile(self.lengths)
                )
            )
            try:
                if use_buckets:
                    # mixed-length corpus: per-width-bucket keygen keeps
                    # device memory at sum(n_k * W_k) instead of
                    # n * roundup(longest)
                    engine = BucketedSortJoinEngine(self.db)
                    name = "sortjoin_bucketed"
                else:
                    engine = self._engine or SortJoinNeighborEngine(self.db)
                    name = "sortjoin"
                edges = engine.build_network(no_break, abundances)
                metrics.engine(d1_network=name)
                return edges
            except SentinelCollision:
                pass  # astronomically rare: fall through to host path
        if backend == "jax_probe":
            from .neighbors_jax import DeviceNeighborEngine

            engine = DeviceNeighborEngine(self.db)
            metrics.engine(d1_network="probe")
            return engine.build_network(no_break, abundances)
        if backend == "jax_shard":
            from .neighbors_sortjoin import SentinelCollision
            from ..parallel.mesh import SortJoinShardedEngine

            try:
                engine = SortJoinShardedEngine(self.db)
                edges = engine.build_network(no_break, abundances)
                metrics.engine(d1_network="sortjoin_sharded")
                return edges
            except SentinelCollision:
                pass  # astronomically rare: fall through to host path
        metrics.engine(d1_network="python")
        seqhash, hashes, valid = variant_hashes(self.padded, self.lengths, self.zob)

        order = np.argsort(seqhash, kind="stable")
        sorted_hashes = seqhash[order]

        amp_ids, slot_ids, tgt_ids = _join(hashes, valid, sorted_hashes, order)

        ok = verify_candidates(self.padded, self.lengths, amp_ids, slot_ids, tgt_ids)
        amp_ids, tgt_ids = amp_ids[ok], tgt_ids[ok]

        keep = amp_ids != tgt_ids
        if not no_break:
            keep &= abundances[amp_ids] >= abundances[tgt_ids]
        amp_ids, tgt_ids = amp_ids[keep], tgt_ids[keep]

        edge_order = np.lexsort((tgt_ids, amp_ids))
        return amp_ids[edge_order], tgt_ids[edge_order]


def _join(hashes, valid, sorted_hashes, order):
    """Join variant hashes against the sorted amplicon hash array.

    Returns candidate (amp, slot, target) triples (hash-equal, unverified).
    Handles runs of equal hash values in the table (collisions)."""
    n, n_slots = hashes.shape
    m = len(sorted_hashes)
    flat = hashes.reshape(-1)
    flat_valid = valid.reshape(-1)

    lo = np.searchsorted(sorted_hashes, flat, side="left")
    hi = np.searchsorted(sorted_hashes, flat, side="right")
    counts = np.where(flat_valid, hi - lo, 0)

    total = int(counts.sum())
    if total == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty, empty

    flat_idx = np.repeat(np.arange(n * n_slots), counts)
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    table_pos = np.repeat(lo, counts) + within

    amp = flat_idx // n_slots
    slot = flat_idx % n_slots
    target = order[table_pos]
    return amp, slot, target
