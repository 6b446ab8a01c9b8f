"""Device path for the fastidious graft join (reference src/algod1.cc:211-555).

A light amplicon l grafts onto the smallest heavy amplicon h with
dist(h, l) <= 2, discovered through a shared *microvariant midpoint* m
with dist(h, m) = dist(m, l) = 1. The reference realizes this as a
Bloom filter of light microvariant hashes probed by heavy gen-1/gen-2
variants (src/algod1.cc:374-552). The device pipeline keeps exactly that
asymmetry, in array form:

  1. the SMALLER of the two sides is tabled: its variant-hash keys are
     sorted once ((hi, lo) uint32 pairs) and summarized into a
     membership bitset (the reference's Bloom-filter role — one device
     word gather per probe instead of a binary search);
  2. the bigger side streams through in chunks: variant hashes ->
     bitset probe -> two-level compaction of the ~1/8 false-positive +
     true-hit survivors -> searchsorted into the sorted table with a
     K-probe window (K escalates if a hash run is longer) -> exact
     midpoint verification by reconstructing both variant sequences.

Counting semantics match models/d1.py:_graft_join (one verified triple
per distinct midpoint), which feeds the "Got N graft candidates" log
line. Hash collisions are rejected by the sequence comparison; missed
matches cannot happen (bitset has no false negatives; window overflow
is detected on device and retried).
"""

import os
import sys
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .neighbors_jax import variant_hash_halves

_MIX = jnp.uint32(0x9E3779B1)  # odd multiplier: (hi ^ lo * MIX) spreads pairs


def _t(tag, t0):
    """SWARM_TPU_TIMING phase-wall helper shared by both graft engines."""
    if os.environ.get("SWARM_TPU_TIMING"):
        sys.__stderr__.write(f"[graft] {tag} {time.perf_counter()-t0:8.3f}s\n")
    return time.perf_counter()


def _decode_slots(slot, W, padded_rows, slot_w=None):
    """(var_type, pos, base) for variant slots (device mirror of
    swarm_tpu.ops.neighbors.decode_slot).

    var_type: 0 substitution, 1 deletion, 2 insertion; `pos` is the edit
    position in the NEW sequence; padded_rows: [P, W] owner code rows.
    """
    if slot_w is None:
        slot_w = W
    tail = slot >= 7 * slot_w
    kind = jnp.where(tail, 0, slot // slot_w)  # 0..6
    p = jnp.where(tail, 0, slot % slot_w)

    var_type = jnp.where(
        tail, 2, jnp.where(kind < 3, 0, jnp.where(kind == 3, 1, 2))
    )
    p_c = jnp.minimum(p, W - 1)
    s_p = jnp.take_along_axis(padded_rows, p_c[:, None], axis=1)[:, 0]
    # j-th base != s_p ascending, computed arithmetically: j + (j >= s_p)
    j = jnp.where(kind < 3, kind, jnp.clip(kind - 4, 0, 2))
    other_base = j + (j >= s_p.astype(jnp.int32)).astype(jnp.int32)
    pos = jnp.where(tail, 0, jnp.where(kind < 4, p, p + 1))
    base = jnp.where(
        tail,
        slot - 7 * slot_w,
        jnp.where(kind == 3, 0, other_base),
    )
    return var_type, pos, base


def _variant_rows(padded, lengths, amp, slot, W, slot_w=None):
    """Reconstruct variant sequences ([P, W+1] rows, [P] lengths)."""
    rows = padded[amp]  # [P, W]
    var_type, pos, base = _decode_slots(slot, W, rows, slot_w)
    src_len = lengths[amp]
    out_len = src_len + jnp.where(var_type == 1, -1, jnp.where(var_type == 2, 1, 0))

    idx = jnp.arange(W + 1, dtype=jnp.int32)[None, :]
    pos_col = pos[:, None]
    src_idx = jnp.where(
        var_type[:, None] == 1,
        idx + (idx >= pos_col),  # deletion: skip pos
        jnp.where(var_type[:, None] == 2, idx - (idx > pos_col), idx),
    )
    src_idx = jnp.clip(src_idx, 0, W - 1)
    out = jnp.take_along_axis(rows, src_idx, axis=1)
    place = (var_type != 1)[:, None] & (idx == pos_col)
    out = jnp.where(place, base[:, None].astype(jnp.uint8), out)
    out = jnp.where(idx < out_len[:, None], out, jnp.uint8(0))
    return out, out_len


@partial(jax.jit, static_argnames=("chunk_rows",))
def variant_keys_chunk(padded, lengths, zob, ids, chunk_rows):
    """Variant-hash key arrays for a chunk of amplicons.

    ids: [chunk_rows] global amplicon ids (-1 pad). Returns flattened
    (hi, lo, owner, slot) of length chunk_rows * S.
    """
    rows = padded[jnp.maximum(ids, 0)]
    lens = jnp.where(ids >= 0, lengths[jnp.maximum(ids, 0)], 0)
    (h_hi, h_lo), _, valid = variant_hash_halves(rows, lens, zob)
    S = h_hi.shape[1]
    owner = jnp.where(valid & (ids[:, None] >= 0), ids[:, None], -1)
    slot = jnp.broadcast_to(
        jnp.arange(S, dtype=jnp.int32)[None, :], owner.shape
    )
    return (
        h_hi.reshape(-1), h_lo.reshape(-1),
        owner.reshape(-1), slot.reshape(-1),
    )


@partial(jax.jit, static_argnames=("bits",))
def build_graft_table(t_hi, t_lo, t_own, t_slot, bits):
    """Sort the table keys and build the membership bitset.

    Returns (s_hi, s_lo, s_own, s_slot, byteset [2^bits+1 u8],
    sentinel_hits). Invalid keys (owner < 0) carry the all-ones
    sentinel, sort last and never enter the bitset.
    """
    invalid = t_own < 0
    sent = jnp.uint32(0xFFFFFFFF)
    sentinel_hits = jnp.sum(
        (~invalid) & (t_hi == sent) & (t_lo == sent), dtype=jnp.int32
    )
    hi = jnp.where(invalid, sent, t_hi)
    lo = jnp.where(invalid, sent, t_lo)
    s_hi, s_lo, s_own, s_slot = jax.lax.sort(
        (hi, lo, t_own, t_slot), num_keys=2, is_stable=False
    )

    # membership BYTE-set: one u8 per hashed slot, built with a plain
    # scatter-max (duplicate indices are harmless — no read-modify-write
    # races, no segmented scan; 8x the memory of a bitset but compiles
    # robustly at any size)
    n_bytes = 1 << bits
    idx = (s_hi ^ (s_lo * _MIX)) & jnp.uint32(n_bytes - 1)
    dst = jnp.where(s_own >= 0, idx.astype(jnp.int32), n_bytes)
    byteset = jnp.zeros(n_bytes + 1, dtype=jnp.uint8).at[dst].max(
        jnp.uint8(1)
    )
    return s_hi, s_lo, s_own, s_slot, byteset, sentinel_hits


def _graft_probe_body(
    padded, lengths, zob, ids,
    s_hi, s_lo, s_own, s_slot, bitset,
    chunk_rows, bits, cap3, cap, probes, chunk_is_heavy,
):
    """One streamed chunk: variant hashes -> bitset -> table probes ->
    verified (heavy, light) pairs.

    Returns (h_amp [cap], l_amp [cap], good [cap], n_survivors,
    n_pairs, window_overflow).
    """
    M_t = s_hi.shape[0]
    W = padded.shape[1]
    rows = padded[jnp.maximum(ids, 0)]
    lens = jnp.where(ids >= 0, lengths[jnp.maximum(ids, 0)], 0)
    (c_hi, c_lo), _, valid = variant_hash_halves(rows, lens, zob)
    S = c_hi.shape[1]
    valid = valid & (ids[:, None] >= 0)

    idx = (c_hi ^ (c_lo * _MIX)) & jnp.uint32((1 << bits) - 1)
    hit = valid & (bitset[idx.astype(jnp.int32)] != 0)

    # two-level compaction of survivors
    flat = hit.reshape(-1)
    M = flat.shape[0]
    n_surv = jnp.sum(flat, dtype=jnp.int32)
    M32 = -(-M // 32) * 32
    af = jnp.concatenate([flat, jnp.zeros(M32 - M, dtype=bool)]).reshape(-1, 32)
    wflag = jnp.any(af, axis=1)
    n_words_f = jnp.sum(wflag, dtype=jnp.int32)
    (wsel,) = jnp.nonzero(wflag, size=cap3, fill_value=0)
    w_picked = jnp.arange(cap3, dtype=jnp.int32) < n_words_f
    bits32 = af[wsel] & w_picked[:, None]
    flat_idx = wsel[:, None] * 32 + jnp.arange(32, dtype=jnp.int32)[None, :]
    cand = jnp.where(bits32, flat_idx, M32).reshape(-1)
    (sel2,) = jnp.nonzero(cand < M32, size=cap3, fill_value=0)
    sel = jnp.minimum(cand[sel2], M - 1)
    picked3 = jnp.arange(cap3, dtype=jnp.int32) < n_surv

    surv_hi = c_hi.reshape(-1)[sel]
    surv_lo = c_lo.reshape(-1)[sel]
    surv_amp = ids[sel // S]
    surv_slot = (sel % S).astype(jnp.int32)

    # probe the sorted table: left edge of the hi-run, K-slot window
    pos = jnp.searchsorted(s_hi, surv_hi, side="left").astype(jnp.int32)
    pair_flags = []
    pair_tpos = []
    over = jnp.zeros((), dtype=jnp.int32)
    for k in range(probes + 1):
        raw = pos + k
        in_range = raw < M_t
        p_k = jnp.clip(raw, 0, M_t - 1)
        m = (
            picked3 & in_range
            & (s_hi[p_k] == surv_hi) & (s_lo[p_k] == surv_lo)
            & (s_own[p_k] >= 0)
        )
        if k == probes:
            # matches can only lie further right if the hi-run is still
            # alive at the window edge with lo not yet past the target
            # (lo ascends within a hi-run) => escalate
            maybe_beyond = (
                picked3 & in_range
                & (s_hi[p_k] == surv_hi) & (s_lo[p_k] <= surv_lo)
            )
            over = jnp.sum(maybe_beyond, dtype=jnp.int32)
        else:
            pair_flags.append(m)
            pair_tpos.append(p_k)

    pflags = jnp.stack(pair_flags, axis=1).reshape(-1)  # [cap3 * probes]
    ptpos = jnp.stack(pair_tpos, axis=1).reshape(-1)
    n_pairs = jnp.sum(pflags, dtype=jnp.int32)
    (psel,) = jnp.nonzero(pflags, size=cap, fill_value=0)
    picked = jnp.arange(cap, dtype=jnp.int32) < n_pairs

    surv_i = psel // probes
    t_i = ptpos[psel]
    c_amp = jnp.where(picked, surv_amp[surv_i], 0)
    c_slot = jnp.where(picked, surv_slot[surv_i], 0)
    t_amp = jnp.where(picked, s_own[t_i], 0)
    t_slot = jnp.where(picked, s_slot[t_i], 0)

    rows_c, len_c = _variant_rows(padded, lengths, c_amp, c_slot, W)
    rows_t, len_t = _variant_rows(padded, lengths, t_amp, t_slot, W)
    good = picked & (len_c == len_t) & jnp.all(rows_c == rows_t, axis=1)

    if chunk_is_heavy:
        h_amp, l_amp = c_amp, t_amp
    else:
        h_amp, l_amp = t_amp, c_amp
    return h_amp, l_amp, good, n_surv, n_pairs, over


@partial(
    jax.jit,
    static_argnames=("chunk_rows", "bits", "cap3", "cap", "probes",
                     "chunk_is_heavy"),
)
def graft_probe_all(
    padded, lengths, zob, ids_2d,
    s_hi, s_lo, s_own, s_slot, bitset,
    chunk_rows, bits, cap3, cap, probes, chunk_is_heavy,
):
    """The whole big side in ONE dispatch: lax.map over row chunks of
    the probe body. A per-chunk loop pays 3 synchronous scalar
    readbacks per 4096-row chunk; mapping the chunks inside one
    program leaves a single status readback for the entire side. Returns ([K, cap] h_amp / l_amp / good,
    status int32[3] = [max n_surv, max n_pairs, sum over])."""

    def one(ids):
        return _graft_probe_body(
            padded, lengths, zob, ids,
            s_hi, s_lo, s_own, s_slot, bitset,
            chunk_rows, bits, cap3, cap, probes, chunk_is_heavy,
        )

    h_amp, l_amp, good, n_surv, n_pairs, over = jax.lax.map(one, ids_2d)
    status = jnp.stack(
        [jnp.max(n_surv), jnp.max(n_pairs), jnp.sum(over)]
    )
    return h_amp, l_amp, good, status


class GraftEngine:
    """Device-side graft-candidate discovery for the fastidious pass."""

    CHUNK = 4096
    #: device-resident table-side key budget (keys ~12 bytes plus the
    #: one-off sort's double buffer); sized for a 16 GB accelerator and
    #: not yet re-derived for the GPU's 80 GB
    MAX_TABLE_KEYS = 250_000_000

    def __init__(self, padded_np, lengths_np, zob_pair_np):
        self.width = padded_np.shape[1]
        self.padded = jnp.asarray(padded_np)
        self.lengths = jnp.asarray(lengths_np.astype(np.int32))
        self.zob = jnp.asarray(zob_pair_np)
        self.n = padded_np.shape[0]

    #: keygen rows per dispatch for the sort-join path: few big
    #: dispatches, each with its own host round trip; the chunked probe
    #: keeps CHUNK=4096
    KEYGEN_CHUNK = 32768

    def _side_keys(self, amps: np.ndarray, chunk: int = None):
        his, los, owners, slots = [], [], [], []
        C = chunk or self.CHUNK
        for start in range(0, len(amps), C):
            ids = np.full(C, -1, dtype=np.int32)
            sel = amps[start : start + C]
            ids[: len(sel)] = sel
            hi, lo, owner, slot = variant_keys_chunk(
                self.padded, self.lengths, self.zob, jnp.asarray(ids),
                chunk_rows=C,
            )
            his.append(hi)
            los.append(lo)
            owners.append(owner)
            slots.append(slot)
        return (
            jnp.concatenate(his), jnp.concatenate(los),
            jnp.concatenate(owners), jnp.concatenate(slots),
        )

    #: device key budget for the one-shot sort-join (keys are 16 bytes
    #: across four sort operands; the sort roughly doubles residency);
    #: sized for a 16 GB accelerator and not yet re-derived for the
    #: GPU's 80 GB
    MAX_JOIN_KEYS = 192_000_000

    #: below this many SMALL-side keys the asymmetric probe engine wins:
    #: the whole-stream sort pays sort((n_big + n_small) * S) to find
    #: matches a (tiny) sorted table + bitset answers with one linear
    #: pass over the big side's keys — the reference's own asymmetry
    #: (light variants in a Bloom filter, heavy variants probing it,
    #: src/algod1.cc:374-552)
    ASYM_TABLE_KEYS = 8_000_000

    def graft_candidates(self, heavy_amps: np.ndarray, light_amps: np.ndarray):
        """(count, graft_cand[n]) — same contract as models/d1.py:_graft_join.

        Engine selection: when one side is tiny (its variant keys fit
        ASYM_TABLE_KEYS) the bitset/searchsorted probe engine tables it
        and streams the big side — the asymmetric formulation. Balanced
        sides use the whole-join sort (both sides' variant keys in ONE
        lax.sort, cross-side pairs from windowed runs). When the key
        volume exceeds MAX_JOIN_KEYS, the bigger side streams in fixed
        strips (the smaller side's keys ride along in every strip; each
        pair has exactly one big-side entry, so strip totals add and
        per-light minima merge). SWARM_TPU_GRAFT=chunked forces the
        probe engine, =sorted forces the sort engine.
        """
        import os

        if os.environ.get("SWARM_TPU_GRAFT") == "chunked":
            return self._graft_candidates_chunked(heavy_amps, light_amps)
        if len(heavy_amps) == 0 or len(light_amps) == 0:
            return 0, np.full(self.n, -1, dtype=np.int64)
        if os.environ.get("SWARM_TPU_GRAFT") != "sorted":
            n_small = min(len(heavy_amps), len(light_amps))
            if n_small * (7 * self.width + 4) <= self.ASYM_TABLE_KEYS:
                return self._graft_candidates_chunked(heavy_amps, light_amps)

        C = self.KEYGEN_CHUNK
        # slot layout truncated to the corpus's real length cap
        lcap = int(-(-int(np.max(np.asarray(self.lengths))) // 16) * 16)
        lcap = min(lcap, self.width)
        s_slots = 7 * lcap + 4

        def padded_rows(n_amps):
            return -(-n_amps // C) * C

        small_is_heavy = len(heavy_amps) <= len(light_amps)
        small = heavy_amps if small_is_heavy else light_amps
        big = light_amps if small_is_heavy else heavy_amps
        m_small = padded_rows(len(small)) * s_slots
        strip_rows = (
            (self.MAX_JOIN_KEYS - m_small) // s_slots // C
        ) * C
        if strip_rows < C:
            return self._graft_candidates_chunked(heavy_amps, light_amps)
        strip_rows = min(strip_rows, padded_rows(len(big)))

        import numpy as _np

        def side_keys(amps, rows_total):
            ids_np = np.full(rows_total, -1, dtype=np.int32)
            ids_np[: len(amps)] = amps
            his, los = [], []
            sent_total = 0
            for startr in range(0, rows_total, C):
                ids_j = jnp.asarray(ids_np[startr : startr + C])
                hi, lo, sent = variant_keys_hilo(
                    self.padded, self.lengths, self.zob, ids_j,
                    chunk_rows=C, lcap=lcap,
                )
                sent_total += int(sent[0])
                his.append(hi)
                los.append(lo)
            if sent_total > 0:
                raise RuntimeError("sentinel collision in graft join")
            return (
                jnp.concatenate(his) if len(his) > 1 else his[0],
                jnp.concatenate(los) if len(los) > 1 else los[0],
                jnp.asarray(ids_np),
            )

        fused = os.environ.get("SWARM_TPU_GRAFT", "split") == "fused"
        t0 = time.perf_counter()
        rows_small = padded_rows(len(small))
        if fused:
            ids_small_np = np.full(rows_small, -1, dtype=np.int32)
            ids_small_np[: len(small)] = small
            ids_small = jnp.asarray(ids_small_np)
        else:
            s_hi, s_lo, ids_small = side_keys(small, rows_small)
            _ = _np.asarray(s_hi[:1])
            t0 = _t("small-side keys", t0)

        total = 0
        graft_cand = np.full(self.n, -1, dtype=np.int64)
        all_h, all_l = [], []
        window = 8
        cap3 = 1 << 17
        cap = 1 << 17
        for start in range(0, len(big), strip_rows):
            sel = big[start : start + strip_rows]
            if fused:
                ids_big_np = np.full(strip_rows, -1, dtype=np.int32)
                ids_big_np[: len(sel)] = sel
                srt_hi, srt_lo, srt_idx, sent = graft_keys_sorted_fused(
                    self.padded, self.lengths, self.zob,
                    jnp.asarray(ids_small_np.reshape(-1, C)),
                    jnp.asarray(ids_big_np.reshape(-1, C)),
                    chunk_rows=C, n_small=rows_small, n_big=strip_rows,
                    lcap=lcap,
                )
                ids_big = jnp.asarray(ids_big_np)
                if int(sent) > 0:
                    raise RuntimeError("sentinel collision in graft join")
            else:
                b_hi, b_lo, ids_big = side_keys(sel, strip_rows)
                srt_hi, srt_lo, srt_idx = graft_sort3(s_hi, s_lo, b_hi, b_lo)
                del b_hi, b_lo
            t0 = _t("strip keygen+sort", t0)
            while True:
                h_amp, l_amp, good, n_flagged, n_pairs, over = graft_pairs3(
                    srt_hi, srt_lo, srt_idx, ids_small, ids_big,
                    self.padded, self.lengths,
                    window=window, cap3=cap3, cap=cap,
                    m_small=m_small, s_slots=s_slots, lcap=lcap,
                    small_is_heavy=small_is_heavy,
                )
                if int(over) > 0:
                    window *= 2
                    continue
                if int(n_flagged) > cap3:
                    cap3 *= 2
                    continue
                if int(n_pairs) > cap:
                    cap *= 2
                    continue
                break
            del srt_hi, srt_lo, srt_idx
            t0 = _t("join program(s)", t0)
            good_np = np.asarray(good)
            t0 = _t("good D2H", t0)
            if good_np.any():
                all_h.append(np.asarray(h_amp)[good_np].astype(np.int64))
                all_l.append(np.asarray(l_amp)[good_np].astype(np.int64))
                total += int(good_np.sum())

        if total:
            h = np.concatenate(all_h)
            l = np.concatenate(all_l)
            order = np.lexsort((h, l))
            l_sorted, h_sorted = l[order], h[order]
            first = np.ones(len(l_sorted), dtype=bool)
            first[1:] = l_sorted[1:] != l_sorted[:-1]
            graft_cand[l_sorted[first]] = h_sorted[first]
        return total, graft_cand

    def _graft_candidates_chunked(self, heavy_amps, light_amps):
        """The round-1 probe engine (bitset + searchsorted), retained
        as the fallback and differential oracle."""
        keys_per_amp = 7 * self.width + 4
        max_table = max(self.CHUNK, self.MAX_TABLE_KEYS // keys_per_amp)
        table_is_heavy = len(heavy_amps) < len(light_amps)
        table_amps = heavy_amps if table_is_heavy else light_amps
        if len(table_amps) > max_table:
            total = 0
            graft_cand = np.full(self.n, -1, dtype=np.int64)
            for start in range(0, len(table_amps), max_table):
                strip = table_amps[start : start + max_table]
                if table_is_heavy:
                    cnt, cand = self._graft_strip(strip, light_amps)
                else:
                    cnt, cand = self._graft_strip(heavy_amps, strip)
                total += cnt
                both = (graft_cand >= 0) & (cand >= 0)
                graft_cand = np.where(
                    both,
                    np.minimum(graft_cand, cand),
                    np.where(cand >= 0, cand, graft_cand),
                )
            return total, graft_cand
        return self._graft_strip(heavy_amps, light_amps)

    def _graft_strip(self, heavy_amps: np.ndarray, light_amps: np.ndarray):
        graft_cand = np.full(self.n, -1, dtype=np.int64)
        if len(heavy_amps) == 0 or len(light_amps) == 0:
            return 0, graft_cand

        if len(heavy_amps) < len(light_amps):
            table_amps, chunk_amps, chunk_is_heavy = heavy_amps, light_amps, False
        else:
            table_amps, chunk_amps, chunk_is_heavy = light_amps, heavy_amps, True

        t_hi, t_lo, t_own, t_slot = self._side_keys(table_amps)
        m_table = int(t_hi.shape[0])
        # byte-set sized for ~1/8 false-positive rate, clamped to 256 MB
        bits = min(max(20, (m_table * 8 - 1).bit_length()), 28)
        s_hi, s_lo, s_own, s_slot, bitset, sentinel = build_graft_table(
            t_hi, t_lo, t_own, t_slot, bits=bits
        )
        if int(sentinel) > 0:
            raise RuntimeError("sentinel collision in graft table")

        C = self.CHUNK
        cap3 = 1 << 17
        cap = 1 << 13
        probes = 8
        t0 = time.perf_counter()
        K = -(-len(chunk_amps) // C)
        ids_np = np.full(K * C, -1, dtype=np.int32)
        ids_np[: len(chunk_amps)] = chunk_amps
        ids_2d = jnp.asarray(ids_np.reshape(K, C))
        while True:
            h_amp, l_amp, good, status = graft_probe_all(
                self.padded, self.lengths, self.zob, ids_2d,
                s_hi, s_lo, s_own, s_slot, bitset,
                chunk_rows=C, bits=bits, cap3=cap3, cap=cap,
                probes=probes, chunk_is_heavy=chunk_is_heavy,
            )
            n_surv, n_pairs, over = (int(x) for x in np.asarray(status))
            if over > 0:
                probes *= 2
                continue
            if n_surv > cap3:
                cap3 *= 2
                continue
            if n_pairs > cap:
                cap *= 2
                continue
            break

        t0 = _t("join program(s)", t0)
        good_np = np.asarray(good).reshape(-1)
        t0 = _t("good D2H", t0)
        total = int(good_np.sum())
        if total:
            h = np.asarray(h_amp).reshape(-1)[good_np].astype(np.int64)
            l = np.asarray(l_amp).reshape(-1)[good_np].astype(np.int64)
            order = np.lexsort((h, l))
            l_sorted, h_sorted = l[order], h[order]
            first = np.ones(len(l_sorted), dtype=bool)
            first[1:] = l_sorted[1:] != l_sorted[:-1]
            graft_cand[l_sorted[first]] = h_sorted[first]
        return total, graft_cand


# buffer donation is a device-memory-peak optimization; on backends that cannot
# donate (CPU tests) jax warns on stderr, which would break byte
# parity of the log stream
import warnings as _warnings

_warnings.filterwarnings(
    "ignore", message="Some donated buffers were not usable"
)

_SENT32 = jnp.uint32(0xFFFFFFFF)


@partial(jax.jit, static_argnames=("chunk_rows", "lcap"))
def variant_keys_hilo(padded, lengths, zob, ids, chunk_rows, lcap):
    """(hi [C*(7*lcap+4)], lo, sentinel_hits[1]) — invalid slots carry
    the all-ones sentinel."""
    W = padded.shape[1]
    rows = padded[jnp.maximum(ids, 0)]
    lens = jnp.where(ids >= 0, lengths[jnp.maximum(ids, 0)], 0)
    (h_hi, h_lo), _, valid = variant_hash_halves(rows, lens, zob)
    C = h_hi.shape[0]

    def trunc(x):
        # kind-major: drop positions >= lcap within each of the 7 kinds
        return jnp.concatenate(
            [
                x[:, : 7 * W].reshape(C, 7, W)[:, :, :lcap].reshape(
                    C, 7 * lcap
                ),
                x[:, 7 * W :],
            ],
            axis=1,
        )

    h_hi, h_lo, valid = trunc(h_hi), trunc(h_lo), trunc(valid)
    valid = valid & (ids[:, None] >= 0)
    sentinel_hits = jnp.sum(
        valid & (h_hi == _SENT32) & (h_lo == _SENT32), dtype=jnp.int32
    )
    hi = jnp.where(valid, h_hi, _SENT32)
    lo = jnp.where(valid, h_lo, _SENT32)
    return hi.reshape(-1), lo.reshape(-1), sentinel_hits[None]


@partial(jax.jit, donate_argnums=(2, 3))
def graft_sort3(t_hi, t_lo, b_hi, b_lo):
    k_hi = jnp.concatenate([t_hi, b_hi])
    k_lo = jnp.concatenate([t_lo, b_lo])
    idx = jax.lax.iota(jnp.int32, k_hi.shape[0])
    return jax.lax.sort((k_hi, k_lo, idx), num_keys=2, is_stable=False)


@partial(
    jax.jit,
    static_argnames=("window", "cap3", "cap", "m_small", "s_slots", "lcap",
                     "small_is_heavy"),
)
def graft_pairs3(
    s_hi, s_lo, s_idx, ids_small, ids_big, padded, lengths,
    window, cap3, cap, m_small, s_slots, lcap, small_is_heavy,
):
    """Cross-side pairs from windowed runs of the sorted key stream +
    midpoint verification. Returns (h_amp, l_amp, good, n_flagged,
    n_pairs, overflow_run)."""
    M = s_hi.shape[0]
    W = padded.shape[1]
    val = ~((s_hi == _SENT32) & (s_lo == _SENT32))
    side_small = s_idx < m_small

    def shifted(j, cross):
        eq = (s_hi[j:] == s_hi[:-j]) & (s_lo[j:] == s_lo[:-j])
        eq = eq & val[j:] & val[:-j]
        if cross:
            eq = eq & (side_small[j:] != side_small[:-j])
        return jnp.concatenate([jnp.zeros(j, dtype=bool), eq])

    eqs = [shifted(j, True) for j in range(1, window + 1)]
    anyflag = eqs[0]
    for e in eqs[1:]:
        anyflag = anyflag | e
    over = (
        shifted(window + 1, False)
        if M > window + 1
        else jnp.zeros(M, dtype=bool)
    )
    overflow_run = jnp.sum(over, dtype=jnp.int32)

    n_flagged = jnp.sum(anyflag, dtype=jnp.int32)
    M32 = -(-M // 32) * 32
    af = jnp.concatenate(
        [anyflag, jnp.zeros(M32 - M, dtype=bool)]
    ).reshape(-1, 32)
    wflag = jnp.any(af, axis=1)
    n_words = jnp.sum(wflag, dtype=jnp.int32)
    (wsel,) = jnp.nonzero(wflag, size=cap3, fill_value=0)
    w_picked = jnp.arange(cap3, dtype=jnp.int32) < n_words
    bits = af[wsel] & w_picked[:, None]
    flat_idx = wsel[:, None] * 32 + jnp.arange(32, dtype=jnp.int32)[None, :]
    cand = jnp.where(bits, flat_idx, M32).reshape(-1)
    (sel2,) = jnp.nonzero(cand < M32, size=cap3, fill_value=0)
    sel = jnp.minimum(cand[sel2], M - 1)
    picked = jnp.arange(cap3, dtype=jnp.int32) < n_flagged

    okflat = jnp.stack(
        [picked & eqs[j - 1][sel] for j in range(1, window + 1)], axis=1
    ).reshape(-1)
    a_pos_f = jnp.repeat(sel, window)
    b_pos_f = jnp.stack(
        [jnp.clip(sel - j, 0, M - 1) for j in range(1, window + 1)], axis=1
    ).reshape(-1)

    n_pairs = jnp.sum(okflat, dtype=jnp.int32)
    (psel,) = jnp.nonzero(okflat, size=cap, fill_value=0)
    picked2 = jnp.arange(cap, dtype=jnp.int32) < n_pairs

    def decode(positions):
        idx = s_idx[positions]
        is_small = idx < m_small
        row_s = jnp.clip(idx, 0, m_small - 1) // s_slots
        slot_s = jnp.clip(idx, 0, m_small - 1) % s_slots
        bidx = jnp.maximum(idx - m_small, 0)
        row_b = bidx // s_slots
        slot_b = bidx % s_slots
        amp = jnp.where(
            is_small,
            ids_small[jnp.clip(row_s, 0, ids_small.shape[0] - 1)],
            ids_big[jnp.clip(row_b, 0, ids_big.shape[0] - 1)],
        )
        slot = jnp.where(is_small, slot_s, slot_b)
        return amp, slot.astype(jnp.int32), is_small

    a_amp, a_slot, a_small = decode(jnp.where(picked2, a_pos_f[psel], 0))
    b_amp, b_slot, _ = decode(jnp.where(picked2, b_pos_f[psel], 0))
    a_amp = jnp.where(picked2, a_amp, 0)
    b_amp = jnp.where(picked2, b_amp, 0)

    rows_a, len_a = _variant_rows(padded, lengths, a_amp, a_slot, W, lcap)
    rows_b, len_b = _variant_rows(padded, lengths, b_amp, b_slot, W, lcap)
    good = picked2 & (len_a == len_b) & jnp.all(rows_a == rows_b, axis=1)

    a_is_heavy = a_small == small_is_heavy
    h_amp = jnp.where(a_is_heavy, a_amp, b_amp)
    l_amp = jnp.where(a_is_heavy, b_amp, a_amp)
    return h_amp, l_amp, good, n_flagged, n_pairs, overflow_run


@partial(
    jax.jit,
    static_argnames=("chunk_rows", "n_small", "n_big", "lcap"),
)
def graft_keys_sorted_fused(
    padded, lengths, zob, ids_small_2d, ids_big_2d,
    chunk_rows, n_small, n_big, lcap,
):
    """ONE dispatch for a whole strip: variant keygen for both sides
    (lax.map over row chunks bounds the [C, 7*lcap+4] intermediates)
    fused with the global sort. Returns (s_hi, s_lo, s_idx,
    sentinel_hits) — the exact inputs graft_pairs3 takes — so the
    per-dispatch host round trip is paid once per strip instead of
    once per 32k-row chunk.
    ids_*_2d: [K, chunk_rows] int32 (-1 pad)."""
    W = padded.shape[1]
    S = 7 * lcap + 4

    def keys_of(ids):
        rows = padded[jnp.maximum(ids, 0)]
        lens = jnp.where(ids >= 0, lengths[jnp.maximum(ids, 0)], 0)
        (h_hi, h_lo), _, valid = variant_hash_halves(rows, lens, zob)
        C = h_hi.shape[0]

        def trunc(x):
            return jnp.concatenate(
                [
                    x[:, : 7 * W].reshape(C, 7, W)[:, :, :lcap].reshape(
                        C, 7 * lcap
                    ),
                    x[:, 7 * W :],
                ],
                axis=1,
            )

        h_hi, h_lo, valid = trunc(h_hi), trunc(h_lo), trunc(valid)
        valid = valid & (ids[:, None] >= 0)
        sent = jnp.sum(
            valid & (h_hi == _SENT32) & (h_lo == _SENT32), dtype=jnp.int32
        )
        hi = jnp.where(valid, h_hi, _SENT32)
        lo = jnp.where(valid, h_lo, _SENT32)
        return hi.reshape(-1), lo.reshape(-1), sent

    s_hi, s_lo, s_sent = jax.lax.map(keys_of, ids_small_2d)
    b_hi, b_lo, b_sent = jax.lax.map(keys_of, ids_big_2d)
    k_hi = jnp.concatenate([s_hi.reshape(-1), b_hi.reshape(-1)])
    k_lo = jnp.concatenate([s_lo.reshape(-1), b_lo.reshape(-1)])
    idx = jax.lax.iota(jnp.int32, n_small * S + n_big * S)
    o_hi, o_lo, o_idx = jax.lax.sort(
        (k_hi, k_lo, idx), num_keys=2, is_stable=False
    )
    return o_hi, o_lo, o_idx, jnp.sum(s_sent) + jnp.sum(b_sent)
