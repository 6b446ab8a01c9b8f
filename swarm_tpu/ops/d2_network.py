"""Bulk d>=2 candidate discovery as int8 matrix products on the device.

The reference screens candidates per (sub)seed with a qgram popcount
loop (src/qgram.cc:104-236 + src/algo.cc:423-432): a latency-bound
sequential scan over the remaining pool, repeated for every subseed.
On the device the same mathematics — Hamming distance between
1024-bit 5-mer parity profiles — is a dense int8 matmul: mapping
profile bits to {+1, -1} lanes gives

    hamming(a, b) = (1024 - dot(a_pm1, b_pm1)) / 2

so ALL n^2/2 candidate screens become tiled [T, 1024] x [1024, T]
integer contractions, with the edit-distance bound
mindiff = ceil(hamming / 10) <= d  <=>  dot >= 1024 - 20d
(src/qgram.cc:247-252) plus the length bound |len_i - len_j| <= d
(both sound lower bounds: survivors are a superset of the true
edge set, and the exact aligner rejects the rest — output-identical
to the reference by SURVEY.md section 3.5).

Two jitted programs split the work: qgram_screen_words scans tile
pairs (I <= J) and stores each step's survivor mask as packed u32
words (device-resident), and extract_pairs compacts every step at
once with one hierarchical supergroup/word/bit pass whose sorts scale
with the survivors, not the n^2/2 screen space; only O(survivors)
bytes are copied to the host. Exact per-pair diffs run on the device
(ops/d2_diffs_jax.py) or in native code (swarm_native.c:
d2_diffs_pairs); the order-preserving clustering replay runs in
native code (algo_cluster_graph).
"""

import os
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .neighbors_jax import _round_up  # noqa: F401  (configures jax cache)

PROFILE_BYTES = 128  # 1024-bit qgram parity vector
PROFILE_BITS = 1024


def _unpack_pm1(tile_bytes):
    """[T, 128] uint8 -> [T, 1024] int8 in {+1, -1} (bit set -> -1)."""
    T = tile_bytes.shape[0]
    shifts = jnp.arange(8, dtype=jnp.uint8)[None, None, :]
    bits = (tile_bytes[:, :, None] >> shifts) & jnp.uint8(1)
    return (1 - 2 * bits.astype(jnp.int8)).reshape(T, PROFILE_BITS)


def _screen_words_body(prof_bytes, lengths, tis, tjs, valid, T, n, d):
    """Phase A of the all-pairs screen: survivor masks as packed words.

    The scan writes each step's survivor mask (unpack + [T,1024] x
    [1024,T] int8 matmul + the bound masks) bit-packed into u32 words
    ([K, T*T/32], device-resident), and extract_pairs() compacts ALL
    steps with one hierarchical pass: a per-step compaction would run
    one device sort per tile pair.

    tis/tjs: [K] tile indices (I <= J); valid: [K] bool (False for
    padding steps when K is rounded up to a fixed chunk size).
    """
    dot_min = jnp.int32(PROFILE_BITS - 20 * d)
    powers = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]

    def step(carry, xs):
        ti, tj, ok = xs
        a_bytes = jax.lax.dynamic_slice(prof_bytes, (ti * T, 0),
                                        (T, PROFILE_BYTES))
        b_bytes = jax.lax.dynamic_slice(prof_bytes, (tj * T, 0),
                                        (T, PROFILE_BYTES))
        a_pm1 = _unpack_pm1(a_bytes)
        b_pm1 = _unpack_pm1(b_bytes)
        dot = jax.lax.dot_general(
            a_pm1, b_pm1,
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # [T, T]

        rows = jax.lax.broadcasted_iota(jnp.int32, (T, T), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (T, T), 1)
        gi = ti * T + rows
        gj = tj * T + cols
        la = jax.lax.dynamic_slice(lengths, (ti * T,), (T,))
        lb = jax.lax.dynamic_slice(lengths, (tj * T,), (T,))
        ldiff = jnp.abs(la[:, None] - lb[None, :])

        mask = (dot >= dot_min) & (gi < gj) & (gj < n) & (ldiff <= d) & ok
        words = jnp.sum(
            mask.reshape(-1, 32).astype(jnp.uint32) * powers,
            axis=1, dtype=jnp.uint32,
        )
        return carry, words

    _, words = jax.lax.scan(step, 0, (tis, tjs, valid))
    return words  # [K, T*T/32] uint32


qgram_screen_words = jax.jit(
    _screen_words_body, static_argnames=("T", "n", "d")
)


def _extract_pairs_body(words, tis, tjs, T, caps, capw, capc):
    """Phase B: one hierarchical compaction over every step's words.

    Three levels — 32-word supergroups, then words, then bits — so each
    jnp.nonzero sorts an array proportional to the SURVIVORS (plus one
    K*T^2/1024-element flag pass), not to the n^2/2 screen space.
    Selection indices ascend at every level, so pairs come out in the
    same (step, flat-position) order the one-pass program produced.
    Returns (ga, gb, n_s, n_w, n_c); grow the cap whose count overflows
    and re-run only this (cheap) program — `words` stays device-resident.
    """
    W = words.shape[1]  # T*T/32 words per step
    flat = words.reshape(-1)  # [K*W]
    G = 32
    pad = (-flat.shape[0]) % G  # small shards (tiny tiles / few steps)
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros(pad, dtype=flat.dtype)])
    sflag = jnp.any((flat.reshape(-1, G) != 0), axis=1)
    n_s = jnp.sum(sflag, dtype=jnp.int32)
    (ssel,) = jnp.nonzero(sflag, size=caps, fill_value=0)
    spicked = jnp.arange(caps, dtype=jnp.int32) < n_s
    gw = flat[ssel[:, None] * G + jnp.arange(G, dtype=jnp.int32)[None, :]]
    gw = jnp.where(spicked[:, None], gw, jnp.uint32(0))  # [caps, G]

    wflag = (gw != 0).reshape(-1)  # [caps*G]
    n_w = jnp.sum(wflag, dtype=jnp.int32)
    (wsel,) = jnp.nonzero(wflag, size=capw, fill_value=0)
    wpicked = jnp.arange(capw, dtype=jnp.int32) < n_w
    widx = ssel[wsel // G] * G + (wsel % G)  # global word index
    wvals = jnp.where(wpicked, gw.reshape(-1)[wsel], jnp.uint32(0))

    bits = (
        (wvals[:, None] >> jnp.arange(32, dtype=jnp.uint32)[None, :])
        & jnp.uint32(1)
    ).astype(bool)
    bflat = bits.reshape(-1)  # [capw*32]
    n_c = jnp.sum(bflat, dtype=jnp.int32)
    (bsel,) = jnp.nonzero(bflat, size=capc, fill_value=0)
    cpicked = jnp.arange(capc, dtype=jnp.int32) < n_c
    # Decode per-step WITHOUT forming the global bit position
    # widx*32 + bit: that product peaks at K*T^2 (~5.4e9 at 100k
    # amplicons, T=4096, K=325) and wraps int32 — wrapped positions
    # decoded to garbage (k, wt) pairs, crashing or silently dropping
    # true late-step edges above ~61k amplicons (round-4 regression).
    # Every term below stays < 2^31: widx < K*W <= 512 * T^2/32
    # (2.68e8 at T=4096), and wt < T^2 (1.68e7).
    wg = widx[bsel // 32]  # global word index
    k = wg // W  # step
    wt = (wg % W) * 32 + (bsel % 32)  # bit position within the step's tile
    ga = tis[k] * T + (wt // T).astype(jnp.int32)
    gb = tjs[k] * T + (wt % T).astype(jnp.int32)
    ga = jnp.where(cpicked, ga, -1)
    gb = jnp.where(cpicked, gb, -1)
    return ga, gb, n_s, n_w, n_c


extract_pairs = jax.jit(
    _extract_pairs_body, static_argnames=("T", "caps", "capw", "capc")
)


# per-(mesh, statics) cache of the compiled sharded screen+extract
_SHARDED_PROGRAMS = {}


def sharded_screen_extract(mesh, T, n, d, caps, capw, capc):
    """shard_map program: tile-pair steps sharded over the mesh's first
    axis, qgram profiles replicated (128 B/amplicon), per-device
    hierarchical extraction. The reference parallelizes its qgram scan
    over threads the same way — a static partition of the candidate
    list (src/qgram.cc:293-335); here each device owns a contiguous
    range of steps, so concatenating shard outputs preserves ascending
    global step order (the determinism argument of SURVEY.md §3.5).

    Returns a jitted fn(prof, lengths, tis, tjs, valid) ->
    (ga [D, capc], gb [D, capc], counts [D, 3]).
    """
    key = (id(mesh), T, n, d, caps, capw, capc)
    hit = _SHARDED_PROGRAMS.get(key)
    if hit is not None:
        return hit
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]

    def local(prof, lengths, tis, tjs, valid):
        words = _screen_words_body(prof, lengths, tis, tjs, valid, T, n, d)
        ga, gb, n_s, n_w, n_c = _extract_pairs_body(
            words, tis, tjs, T, caps, capw, capc
        )
        counts = jnp.stack([n_s, n_w, n_c])
        return ga[None], gb[None], counts[None]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    compiled = jax.jit(fn)
    _SHARDED_PROGRAMS[key] = compiled
    return compiled


# last successful extraction caps per (n_pad, d, schema) — avoids undersized
# first attempts on repeat runs within a process, persisted next to
# the XLA compile cache (a fresh process that starts at different caps
# compiles a program the cache does not hold)
_LAST_GOOD = {}


def _params_path():
    from .neighbors_jax import compile_cache_dir

    cache = compile_cache_dir()
    if not cache:
        return None
    return os.path.join(cache, "d2_screen_params.json")


def _load_good():
    path = _params_path()
    if path is None:
        return
    try:
        import json

        with open(path) as fh:
            for k, v in json.load(fh).items():
                _LAST_GOOD.setdefault(
                    tuple(int(x) for x in k.split(",")), tuple(v)
                )
    except (OSError, ValueError):
        pass


def _save_good():
    path = _params_path()
    if path is None:
        return
    try:
        import json

        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(
                {",".join(map(str, k)): v for k, v in _LAST_GOOD.items()}, fh
            )
        os.replace(tmp, path)
    except OSError:
        pass


_load_good()


class D2NetworkEngine:
    """Device qgram join -> native exact diffs -> directed CSR edges."""

    TILE = 4096

    def __init__(self, db, d: int, threads: int = 1):
        from .. import _native

        self.db = db
        self.d = int(d)
        self.threads = max(int(threads), 1)
        self.mesh = None  # set to a jax Mesh to shard the screen
        self.n = len(db)
        # tests shrink the tile to exercise the multi-tile scan cheaply
        self.TILE = int(os.environ.get("SWARM_TPU_D2_TILE", self.TILE))
        T = self.TILE
        self.n_pad = max(T, -(-self.n // T) * T)
        # bit-packed qgram profiles, viewed as bytes for the device
        prof_u64 = _native.qgram_profiles_arena(
            db.codes, db.offsets, db.lengths
        )
        prof_u8 = np.zeros((self.n_pad, PROFILE_BYTES), dtype=np.uint8)
        prof_u8[: self.n] = prof_u64.view(np.uint8).reshape(
            self.n, PROFILE_BYTES
        )
        lengths = np.zeros(self.n_pad, dtype=np.int32)
        lengths[: self.n] = db.lengths
        self.prof_dev = jnp.asarray(prof_u8)
        self.len_dev = jnp.asarray(lengths)
        self.profiles_u64 = prof_u64

    def candidate_pairs(self):
        """(pa, pb, n_screened) — unordered candidate pairs (a < b).

        Tile-pair steps run in fixed-size chunks (one compile each for
        phase A and phase B per chunk shape); each chunk's packed
        survivor words stay device-resident between the phases, and a
        cap overflow re-runs only the cheap extraction program."""
        T = self.TILE
        n_tiles = self.n_pad // T
        all_ti, all_tj = [], []
        for i in range(n_tiles):
            for j in range(i, n_tiles):
                all_ti.append(i)
                all_tj.append(j)
        K = len(all_ti)
        # chunk size bounds the [C, T*T/32] words buffer (u32): 512
        # steps at T=4096 is 1 GB of device memory
        chunk = int(os.environ.get("SWARM_TPU_D2_CHUNK", "512"))
        C = min(chunk, K)
        # extract_pairs decodes global word indices in int32: keep
        # C * words-per-step < 2^31 even under env overrides
        max_chunk = (1 << 31) // (T * T // 32 or 1)
        if C > max_chunk:
            C = max(int(max_chunk), 1)

        key = (self.n_pad, self.d, 2)  # 2 = words-schema version
        caps, capw, capc = _LAST_GOOD.get(key, (1 << 15, 1 << 16, 1 << 18))
        pa_parts, pb_parts = [], []
        total = 0
        for c0 in range(0, K, C):
            cstep = min(C, K - c0)
            tis = np.zeros(C, dtype=np.int32)
            tjs = np.zeros(C, dtype=np.int32)
            valid = np.zeros(C, dtype=bool)
            tis[:cstep] = all_ti[c0:c0 + cstep]
            tjs[:cstep] = all_tj[c0:c0 + cstep]
            valid[:cstep] = True
            tis = jnp.asarray(tis)
            tjs = jnp.asarray(tjs)
            words = qgram_screen_words(
                self.prof_dev, self.len_dev, tis, tjs, jnp.asarray(valid),
                T=T, n=self.n, d=self.d,
            )
            while True:
                ga, gb, n_s, n_w, n_c = extract_pairs(
                    words, tis, tjs, T=T, caps=caps, capw=capw, capc=capc,
                )
                n_s, n_w, n_c = int(n_s), int(n_w), int(n_c)
                if n_s > caps:
                    caps = 1 << (n_s - 1).bit_length()
                    continue
                if n_w > capw:
                    capw = 1 << (n_w - 1).bit_length()
                    continue
                if n_c > capc:
                    capc = 1 << (n_c - 1).bit_length()
                    continue
                break
            if n_c:
                pa_parts.append(np.asarray(ga[:n_c]).astype(np.int64))
                pb_parts.append(np.asarray(gb[:n_c]).astype(np.int64))
            total += n_c
        if _LAST_GOOD.get(key) != (caps, capw, capc):
            _LAST_GOOD[key] = (caps, capw, capc)
            _save_good()
        if pa_parts:
            pa = np.concatenate(pa_parts)
            pb = np.concatenate(pb_parts)
        else:
            pa = np.zeros(0, dtype=np.int64)
            pb = np.zeros(0, dtype=np.int64)
        return pa, pb, total

    def candidate_pairs_sharded(self, mesh):
        """(pa, pb, n_screened) over a jax.sharding.Mesh: the tile-pair
        step list is split contiguously across the mesh's first axis
        (profiles replicated), each device screens and extracts its own
        steps, and shard outputs concatenate in ascending global step
        order — the same pair order candidate_pairs produces, so the
        two paths are interchangeable downstream."""
        T = self.TILE
        n_tiles = self.n_pad // T
        all_ti, all_tj = [], []
        for i in range(n_tiles):
            for j in range(i, n_tiles):
                all_ti.append(i)
                all_tj.append(j)
        K = len(all_ti)
        D = mesh.devices.size
        K_pad = -(-K // D) * D
        tis = np.zeros(K_pad, dtype=np.int32)
        tjs = np.zeros(K_pad, dtype=np.int32)
        valid = np.zeros(K_pad, dtype=bool)
        tis[:K] = all_ti
        tjs[:K] = all_tj
        valid[:K] = True

        key = (self.n_pad, self.d, 3)  # 3 = sharded schema
        caps, capw, capc = _LAST_GOOD.get(key, (1 << 13, 1 << 14, 1 << 16))
        while True:
            fn = sharded_screen_extract(
                mesh, T, self.n, self.d, caps, capw, capc
            )
            ga, gb, counts = fn(
                self.prof_dev, self.len_dev,
                jnp.asarray(tis), jnp.asarray(tjs), jnp.asarray(valid),
            )
            counts = np.asarray(counts)  # [D, 3]
            if counts[:, 0].max() > caps:
                caps = 1 << int(counts[:, 0].max() - 1).bit_length()
                continue
            if counts[:, 1].max() > capw:
                capw = 1 << int(counts[:, 1].max() - 1).bit_length()
                continue
            if counts[:, 2].max() > capc:
                capc = 1 << int(counts[:, 2].max() - 1).bit_length()
                continue
            break
        if _LAST_GOOD.get(key) != (caps, capw, capc):
            _LAST_GOOD[key] = (caps, capw, capc)
            _save_good()
        ga = np.asarray(ga)
        gb = np.asarray(gb)
        pa_parts, pb_parts = [], []
        total = 0
        for dev in range(ga.shape[0]):
            n_c = int(counts[dev, 2])
            if n_c:
                pa_parts.append(ga[dev, :n_c].astype(np.int64))
                pb_parts.append(gb[dev, :n_c].astype(np.int64))
            total += n_c
        if pa_parts:
            return np.concatenate(pa_parts), np.concatenate(pb_parts), total
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64),
                total)

    def build_adjacency(self, mismatch, gapopen, gapextend, no_break):
        """Directed CSR adjacency (adj_start, adj_count, adj_to,
        adj_diff) of exact accepted edges, targets ascending, plus the
        screened-candidate count for the comparison metrics."""
        from .. import _native

        db = self.db
        from .. import metrics

        if self.mesh is not None and self.mesh.devices.size > 1:
            pa, pb, n_screened = self.candidate_pairs_sharded(self.mesh)
            metrics.engine(d2_screen="device_sharded")
        else:
            pa, pb, n_screened = self.candidate_pairs()
            metrics.engine(d2_screen="device")
        if len(pa):
            # loud invariant: a decode bug (e.g. the round-4 int32
            # wrap) must fail here, not corrupt clusters downstream
            hi = max(int(pa.max()), int(pb.max()))
            lo = min(int(pa.min()), int(pb.min()))
            if hi >= self.n or lo < 0:
                raise AssertionError(
                    f"d2 screen produced out-of-range pair index "
                    f"(min={lo}, max={hi}, n={self.n})"
                )
        # exact diffs: the device forward-tracked DP when the pair
        # count amortizes its dispatch (the 8192 crossover against the
        # native 16-lane kernel is not yet measured on the GPU);
        # SWARM_TPU_D2_DIFFS=native|device overrides
        mode = os.environ.get("SWARM_TPU_D2_DIFFS", "auto")
        use_device = mode == "device"
        if mode == "auto" and len(pa) >= 8192:
            from ..device import device_platform

            use_device = device_platform() != "cpu"
        if use_device:
            from .d2_diffs_jax import DeviceDiffEngine

            if not hasattr(self, "_diff_engine"):
                self._diff_engine = DeviceDiffEngine(db, self.d)
            diff_ab, diff_ba = self._diff_engine.diffs_pairs(
                pa, pb, mismatch, gapopen, gapextend, no_break,
            )
        else:
            metrics.engine(d2_diffs="native")
            diff_ab, diff_ba = _native.d2_diffs_pairs(
                db.codes, db.offsets, db.lengths, db.abundances, pa, pb,
                self.d, mismatch, gapopen, gapextend, no_break,
                nthreads=self.threads,
            )
        keep_ab = diff_ab >= 0
        keep_ba = diff_ba >= 0
        ef = np.concatenate([pa[keep_ab], pb[keep_ba]])
        et = np.concatenate([pb[keep_ab], pa[keep_ba]])
        ediff = np.concatenate([diff_ab[keep_ab], diff_ba[keep_ba]])
        order = np.lexsort((et, ef))
        ef, et, ediff = ef[order], et[order], ediff[order]
        n = self.n
        adj_count = np.bincount(ef, minlength=n).astype(np.int64) if n else \
            np.zeros(0, dtype=np.int64)
        adj_start = np.zeros(n, dtype=np.int64)
        if n:
            np.cumsum(adj_count[:-1], out=adj_start[1:])
        return adj_start, adj_count, et, ediff, n_screened, len(pa)
