"""Device path for d=1 neighbor discovery (jit/XLA).

The reference enumerates ~7L+4 microvariant hashes per amplicon and
probes a host hash table (src/variants.cc:184-249, src/algod1.cc:558-627).
Here the same mathematics runs on device as dense batched array ops:

  1. Zobrist hashing with a **uint32 pair** (hi, lo) per position/base —
     a 2x32 hash keeps the whole pipeline in 32-bit integer ops (no
     jax_enable_x64) while retaining 64-bit collision resistance. Every hash match is verified exactly afterwards, so
     hash randomness never affects output (SURVEY.md section 3.5).
  2. Variant hashes via three gathers into the Zobrist table plus XOR
     prefix/suffix scans (jax.lax.associative_scan — log depth).
  3. A sort-based hash join: the per-amplicon sequence hashes form a
     (hi, lo)-sorted table; variant hashes binary-search it
     (jnp.searchsorted on hi, then a K-slot probe window comparing the
     full pair). K covers the longest run of equal hi values, so the
     join is exact.
  4. Static-shape compaction (jnp.nonzero with a fixed capacity) of the
     candidate matches; overflow is detected via the returned count and
     retried with a doubled capacity (rare, recompiles once).

Amplicons are processed in fixed-size chunks so shapes stay static and
device memory is bounded: a chunk of C amplicons of padded length L
materializes [C, 7L+4, 2] uint32 hashes (~92 MB at C=4096, L=400).

Exact verification of the compacted candidates (collision rejection)
runs on host over the few survivors; the edge list it yields is
byte-identical to the numpy path's.
"""

import os

from typing import Tuple

import numpy as np

import logging

# the CLI's stderr is part of the byte-parity surface; keep backend
# chatter (experimental-platform warnings, XLA AOT-loader machine
# feature complaints) out of it
logging.getLogger("jax._src.xla_bridge").setLevel(logging.ERROR)
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax

# persistent compilation cache: CLI invocations are short-lived
# processes, so steady-state serving depends on XLA executables being
# reused across runs. JAX_COMPILATION_CACHE_DIR, when set, is JAX's own
# setting and is used as it is; otherwise the cache lives at a fixed
# directory of the checkout. CPU-pinned runs (JAX_PLATFORMS=cpu) get no
# default cache: CPU compiles are fast and XLA's CPU AOT reload logs
# machine-feature warnings to stderr (a byte-parity surface).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR") and (
    os.environ.get("JAX_PLATFORMS", "") != "cpu"
):
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def compile_cache_dir():
    """The persistent compile cache directory in use, or None."""
    return jax.config.jax_compilation_cache_dir or None


import jax.numpy as jnp

_RNG_SEED = 0x5EED5EED


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_zobrist_pair(max_len: int, seed: int = _RNG_SEED) -> np.ndarray:
    """Zobrist table [max_len + 2, 4, 2] of random uint32 (hi, lo)."""
    rng = np.random.Generator(np.random.Philox(seed))
    return rng.integers(0, 1 << 32, size=(max_len + 2, 4, 2), dtype=np.uint32)


def variant_hashes_device(
    padded: jnp.ndarray, lengths: jnp.ndarray, zob: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """All canonical 1-edit variant hashes for a chunk of sequences.

    padded: [C, L] uint8 codes; lengths: [C] int32; zob: [L+2, 4, 2] u32.
    Returns (seqhash [C, 2], hashes [C, 7L+4, 2], valid [C, 7L+4]).
    Slot layout is identical to swarm_tpu.ops.neighbors.variant_hashes
    so the host-side decode/verify machinery is shared.

    The (hi, lo) hash halves are computed as independent arrays and only
    stacked on the trailing axis at the end for the host-facing API —
    device-side consumers should use variant_hash_halves to avoid
    trailing-2 arrays.
    """
    (h_hi, h_lo), (s_hi, s_lo), valid = variant_hash_halves(
        padded, lengths, zob
    )
    seqhash = jnp.stack([s_hi, s_lo], axis=-1)
    hashes = jnp.stack([h_hi, h_lo], axis=-1)
    return seqhash, hashes, valid


def _zrow_select(z_rows: jnp.ndarray, pidx: jnp.ndarray) -> jnp.ndarray:
    """g[c, p] = z_rows[p, s_cp] without a gather: 4-way masked XOR.

    A 4-way masked accumulation is ~8 full-width elementwise ops that
    fuse into the surrounding program.
    """
    acc = jnp.where(pidx == 0, z_rows[None, :, 0], jnp.uint32(0))
    for b in range(1, 4):
        acc = acc ^ jnp.where(pidx == b, z_rows[None, :, b], jnp.uint32(0))
    return acc


def variant_hash_halves(
    padded: jnp.ndarray, lengths: jnp.ndarray, zob: jnp.ndarray
):
    """((hash_hi [C, 7L+4], hash_lo), (seq_hi [C], seq_lo), valid).

    Kind-major slot layout (identical to the numpy oracle in
    ops/neighbors.py:variant_hashes): slot k*L+p for kinds
    k = 0..2 substitution / 3 deletion / 4..6 insertion, tail slots
    7L..7L+3 for insertions before position 0. Every intermediate is a
    [C, L] array — no small trailing axes.

    Gather-free: every Zobrist lookup is either a position-indexed row
    broadcast (the table is position-major) or a 4-way masked select on
    the base index.
    """
    C, L = padded.shape
    pos = jnp.arange(L, dtype=jnp.int32)
    mask = pos[None, :] < lengths[:, None]  # [C, L]
    pidx = padded.astype(jnp.int32)
    zero = jnp.zeros((), dtype=jnp.uint32)
    bases = jnp.arange(4, dtype=jnp.int32)

    run_start = jnp.concatenate(
        [jnp.ones((C, 1), dtype=bool), padded[:, 1:] != padded[:, :-1]],
        axis=1,
    )

    hash_halves = []
    seq_halves = []
    for h in range(2):
        z = zob[..., h]  # [L+2, 4]
        zL = z[:L]  # rows p = 0..L-1
        zL1 = z[1 : L + 1]  # rows p+1
        zLm1 = jnp.concatenate([z[:1], z[: L - 1]])  # rows p-1 (p=0 masked)
        g0 = jnp.where(mask, _zrow_select(zL, pidx), zero)  # Z[p, s_p]
        gm1 = jnp.where(
            mask & (pos[None, :] >= 1), _zrow_select(zLm1, pidx), zero
        )  # Z[p-1, s_p]
        gp1 = jnp.where(mask, _zrow_select(zL1, pidx), zero)  # Z[p+1, s_p]

        incl = jax.lax.associative_scan(jnp.bitwise_xor, g0, axis=1)
        seqhash = incl[:, -1]  # [C]
        prefix = jnp.concatenate(
            [jnp.zeros_like(g0[:, :1]), incl[:, :-1]], axis=1
        )  # exclusive prefix of g0

        sufdel = jax.lax.associative_scan(
            jnp.bitwise_xor, gm1, axis=1, reverse=True
        )
        sufdel_next = jnp.concatenate(
            [sufdel[:, 1:], jnp.zeros_like(sufdel[:, :1])], axis=1
        )
        sufins = jax.lax.associative_scan(
            jnp.bitwise_xor, gp1, axis=1, reverse=True
        )
        sufins_next = jnp.concatenate(
            [sufins[:, 1:], jnp.zeros_like(sufins[:, :1])], axis=1
        )

        segs = []
        # substitutions (k = 0..2): seqhash ^ Z[p, s_p] ^ Z[p, o_k]
        # where o_k = k-th base != s_p ascending = k + (k >= s_p)
        base_part = seqhash[:, None] ^ g0
        for k in range(3):
            o_k = k + (pidx <= k).astype(jnp.int32)  # [C, L]
            zsub = jnp.where(mask, _zrow_select(zL, o_k), zero)
            segs.append(base_part ^ zsub)

        # deletion at p (k = 3): prefix[p] ^ sufdel[p+1]
        segs.append(prefix ^ sufdel_next)

        # insertions after p (k = 4..6):
        # incl_prefix[p] ^ Z[p+1, o_k] ^ sufins[p+1]
        ins_part = prefix ^ g0 ^ sufins_next
        for k in range(3):
            o_k = k + (pidx <= k).astype(jnp.int32)
            zins = jnp.where(mask, _zrow_select(zL1, o_k), zero)
            segs.append(ins_part ^ zins)

        # insertions before position 0, any base (4 tail slots)
        ins0 = z[0, bases][None, :] ^ sufins[:, 0:1]  # [C, 4]

        hash_halves.append(jnp.concatenate(segs + [ins0], axis=1))
        seq_halves.append(seqhash)

    valid = jnp.concatenate(
        [mask, mask, mask, mask & run_start, mask, mask, mask,
         jnp.broadcast_to(lengths[:, None] > 0, (C, 4))],
        axis=1,
    )
    return tuple(hash_halves), tuple(seq_halves), valid


def candidates_body(
    padded_chunk: jnp.ndarray,  # [C, L] uint8
    lengths_chunk: jnp.ndarray,  # [C] int32
    base_ids: jnp.ndarray,  # [C] int32 global amplicon ids (pad rows: any)
    zob: jnp.ndarray,  # [L+2, 4, 2] uint32
    table_hi: jnp.ndarray,  # [n] uint32 sorted by (hi, lo)
    table_lo: jnp.ndarray,  # [n] uint32
    table_ids: jnp.ndarray,  # [n] int32 amplicon id per table row
    ab_rank: jnp.ndarray,  # [n] int32 dense abundance rank (desc values)
    cap: int,
    probes: int,
    no_break: bool,
):
    """Candidate 1-edit matches of one amplicon chunk against the table.

    Returns (amp [cap], slot [cap], tgt [cap], count). Entries beyond
    count are filler. Candidates are hash-equal and pass the abundance
    rule; exact sequence verification happens afterwards. Pure function
    of its array arguments — safe under jit and shard_map alike.
    """
    n_table = table_hi.shape[0]
    C, L = padded_chunk.shape
    (var_hi, var_lo), _, valid = variant_hash_halves(
        padded_chunk, lengths_chunk, zob
    )
    S = var_hi.shape[1]

    idx = jnp.searchsorted(table_hi, var_hi.reshape(-1), side="left").reshape(
        C, S
    )

    amp_col = base_ids[:, None]  # [C, 1]
    my_rank = ab_rank[jnp.clip(amp_col, 0, ab_rank.shape[0] - 1)]

    flags = []
    tgts = []
    for k in range(probes):
        raw = idx + k
        in_range = raw < n_table
        p_k = jnp.clip(raw, 0, n_table - 1)
        t_hi = table_hi[p_k]
        t_lo = table_lo[p_k]
        tgt = table_ids[p_k]
        eq = valid & in_range & (t_hi == var_hi) & (t_lo == var_lo)
        # Within a run of equal hi, lo is sorted: once t_lo > var_lo the
        # match cannot appear later, but the probe window is tiny so a
        # plain equality test per slot is cheapest.
        ok = eq & (tgt != amp_col)
        if not no_break:
            tgt_rank = ab_rank[jnp.clip(tgt, 0, ab_rank.shape[0] - 1)]
            ok = ok & (my_rank <= tgt_rank)
        flags.append(ok)
        tgts.append(tgt)

    flags = jnp.stack(flags, axis=-1)  # [C, S, K]
    tgts = jnp.stack(tgts, axis=-1)  # [C, S, K]

    flat = flags.reshape(-1)
    count = jnp.sum(flat, dtype=jnp.int32)
    (sel,) = jnp.nonzero(flat, size=cap, fill_value=0)
    # nonzero returns ascending indices padded with fill_value, so the
    # real selections are exactly the first `count` slots (guarding via
    # flat[sel] would alias a true flag at index 0 into every filler)
    picked = jnp.arange(cap, dtype=jnp.int32) < count

    sk = S * probes
    amp_sel = jnp.where(picked, base_ids[sel // sk], -1)
    slot_sel = jnp.where(picked, (sel // probes) % S, -1)
    tgt_sel = jnp.where(picked, tgts.reshape(-1)[sel], -1)
    return amp_sel, slot_sel, tgt_sel, count


chunk_candidates = jax.jit(
    candidates_body, static_argnames=("cap", "probes", "no_break")
)


def sequence_hashes_device(
    padded_chunk: jnp.ndarray, lengths_chunk: jnp.ndarray, zob: jnp.ndarray
) -> jnp.ndarray:
    """[C, 2] uint32 sequence hashes (hi/lo halves computed separately)."""
    C, L = padded_chunk.shape
    pos = jnp.arange(L, dtype=jnp.int32)
    mask = pos[None, :] < lengths_chunk[:, None]
    pidx = padded_chunk.astype(jnp.int32)
    halves = []
    for h in range(2):
        z = zob[..., h]
        g0 = jnp.where(mask, z[pos[None, :], pidx], jnp.uint32(0))
        incl = jax.lax.associative_scan(jnp.bitwise_xor, g0, axis=1)
        halves.append(incl[:, -1])
    return jnp.stack(halves, axis=-1)


_seq_hashes_jit = jax.jit(sequence_hashes_device)


class DeviceNeighborEngine:
    """Chunked device pipeline producing the exact d=1 edge network.

    Mirrors NeighborIndex.build_network (swarm_tpu/ops/neighbors.py) but
    runs hash generation + join on the JAX default device. Exact
    verification of hash-equal candidates runs on host over the few
    survivors (numpy), so the resulting edge list is identical.
    """

    def __init__(self, db, chunk: int = 0, devices=None):
        n = len(db)
        self.n = n
        max_len = max(int(db.longest), 1)
        # pad length to a lane-friendly multiple to limit recompiles
        self.width = _round_up(max_len, 64)
        from .neighbors import pad_codes

        self.padded_np = pad_codes(db.codes, db.offsets, db.lengths, self.width)
        self.lengths_np = db.lengths.astype(np.int32)
        self.zob_np = make_zobrist_pair(self.width)
        if chunk <= 0:
            chunk = int(os.environ.get("SWARM_TPU_CHUNK", "2048"))
        self.chunk = max(64, min(chunk, _round_up(n, 64)))

        # dense abundance rank: ab[a] >= ab[b]  <=>  rank[a] <= rank[b]
        ab = db.abundances
        order_vals = np.unique(ab)[::-1]
        self.ab_rank_np = np.searchsorted(-order_vals, -ab).astype(np.int32)

        self.zob = jnp.asarray(self.zob_np)
        self.ab_rank = jnp.asarray(self.ab_rank_np)

        # --- build the sorted hash table (device hash, host sort) ---
        seq_hi = np.empty(n, dtype=np.uint32)
        seq_lo = np.empty(n, dtype=np.uint32)
        for start in range(0, n, self.chunk):
            stop = min(start + self.chunk, n)
            pc, lc = self._pad_chunk(start, stop)
            h = np.asarray(_seq_hashes_jit(pc, lc, self.zob))
            seq_hi[start:stop] = h[: stop - start, 0]
            seq_lo[start:stop] = h[: stop - start, 1]
        combined = (seq_hi.astype(np.uint64) << np.uint64(32)) | seq_lo.astype(
            np.uint64
        )
        order = np.argsort(combined, kind="stable")
        self.table_hi = jnp.asarray(seq_hi[order])
        self.table_lo = jnp.asarray(seq_lo[order])
        self.table_ids = jnp.asarray(order.astype(np.int32))

        # probe window: longest run of equal hi in the sorted table + 1
        sorted_hi = seq_hi[order]
        if n > 1:
            change = np.nonzero(np.diff(sorted_hi))[0]
            seg_bounds = np.concatenate([[-1], change, [n - 1]])
            max_run = int(np.max(np.diff(seg_bounds)))
        else:
            max_run = 1
        self.probes = max(2, max_run)

    def _run_chunk(self, pc, lc, ids_j, cap: int, no_break: bool):
        return chunk_candidates(
            pc,
            lc,
            ids_j,
            self.zob,
            self.table_hi,
            self.table_lo,
            self.table_ids,
            self.ab_rank,
            cap=cap,
            probes=self.probes,
            no_break=no_break,
        )

    def _pad_chunk(self, start: int, stop: int):
        C = self.chunk
        pc = np.zeros((C, self.width), dtype=np.uint8)
        lc = np.zeros(C, dtype=np.int32)
        pc[: stop - start] = self.padded_np[start:stop]
        lc[: stop - start] = self.lengths_np[start:stop]
        return jnp.asarray(pc), jnp.asarray(lc)

    def build_network(self, no_break: bool, abundances: np.ndarray):
        """Return (edges_from, edges_to) sorted by (from, to) — the same
        contract as NeighborIndex.build_network."""
        from .neighbors import verify_candidates

        n = self.n
        if n == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)

        base_cap = max(4096, 4 * self.chunk)
        all_amp, all_slot, all_tgt = [], [], []
        n_probe_work = 0
        for start in range(0, n, self.chunk):
            stop = min(start + self.chunk, n)
            pc, lc = self._pad_chunk(start, stop)
            ids = np.full(self.chunk, -1, dtype=np.int32)
            ids[: stop - start] = np.arange(start, stop, dtype=np.int32)
            ids_j = jnp.asarray(ids)
            cap = base_cap
            while True:
                amp, slot, tgt, cnt = self._run_chunk(
                    pc, lc, ids_j, cap, bool(no_break)
                )
                cnt = int(cnt)
                if cnt <= cap:
                    break
                cap *= 2
            n_probe_work += (stop - start) * (7 * self.width + 4)
            if cnt:
                # arrays may be larger than cap (sharded engine returns
                # n_dev * cap_local entries); filler rows are -1
                amp = np.asarray(amp)
                slot = np.asarray(slot)
                tgt = np.asarray(tgt)
                keep = amp >= 0
                all_amp.append(amp[keep].astype(np.int64))
                all_slot.append(slot[keep].astype(np.int64))
                all_tgt.append(tgt[keep].astype(np.int64))
        self.probe_work = n_probe_work

        if not all_amp:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        amp = np.concatenate(all_amp)
        slot = np.concatenate(all_slot)
        tgt = np.concatenate(all_tgt)

        ok = verify_candidates(self.padded_np, self.lengths_np.astype(np.int64), amp, slot, tgt)
        amp, tgt = amp[ok], tgt[ok]
        edge_order = np.lexsort((tgt, amp))
        return amp[edge_order], tgt[edge_order]
