"""Sharded d=1 network construction over a jax.sharding.Mesh.

Parallel decomposition (mirrors the reference's per-amplicon work
stealing, src/algod1.cc:641-669, recast as SPMD):

  - mesh axis "amps": the amplicon chunk axis is sharded — every device
    generates variant hashes and joins them against the table for its
    own slice of the chunk (data parallelism);
  - the sorted sequence-hash table, Zobrist table and abundance ranks
    are replicated (they are small: O(n) u32 words);
  - each device compacts its own candidate list (static per-device
    capacity); per-device counts are returned sharded for overflow
    detection and psum-merged into a replicated total.

Edge merging happens on host: per-device candidate lists concatenate in
device order, and the final (from, to) lexsort makes the edge network
canonical regardless of shard count (SURVEY.md section 7 "multi-host
determinism").
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.neighbors_jax import DeviceNeighborEngine, candidates_body


def make_mesh(n_devices: int = 0) -> Mesh:
    """1-D device mesh over the amplicon axis."""
    devices = jax.devices()
    if n_devices:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=("amps",))


def _sharded_body(
    padded, lengths, base_ids, zob, t_hi, t_lo, t_ids, ab_rank,
    cap_local, probes, no_break,
):
    amp, slot, tgt, count = candidates_body(
        padded, lengths, base_ids, zob, t_hi, t_lo, t_ids, ab_rank,
        cap=cap_local, probes=probes, no_break=no_break,
    )
    total = jax.lax.psum(count, "amps")
    return amp, slot, tgt, count[None], total


class ShardedNeighborEngine(DeviceNeighborEngine):
    """DeviceNeighborEngine with the chunk axis sharded over a mesh."""

    def __init__(self, db, chunk: int = 0, mesh: Mesh = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_dev = self.mesh.devices.size
        super().__init__(db, chunk=chunk)
        # chunk must split evenly across devices
        per_dev = max(64, -(-self.chunk // self.n_dev))
        self.chunk = per_dev * self.n_dev
        self._fns = {}

    def _shard_fn(self, cap_local: int, no_break: bool):
        key = (cap_local, self.probes, no_break)
        fn = self._fns.get(key)
        if fn is None:
            body = partial(
                _sharded_body,
                cap_local=cap_local,
                probes=self.probes,
                no_break=no_break,
            )
            mapped = jax.shard_map(
                body,
                mesh=self.mesh,
                in_specs=(
                    P("amps"), P("amps"), P("amps"),
                    P(), P(), P(), P(), P(),
                ),
                out_specs=(P("amps"), P("amps"), P("amps"), P("amps"), P()),
            )
            fn = jax.jit(mapped)
            self._fns[key] = fn
        return fn

    def _run_chunk(self, pc, lc, ids_j, cap: int, no_break: bool):
        cap_local = max(256, -(-cap // self.n_dev))
        fn = self._shard_fn(cap_local, no_break)
        amp, slot, tgt, counts, total = fn(
            pc, lc, ids_j, self.zob,
            self.table_hi, self.table_lo, self.table_ids, self.ab_rank,
        )
        # a single shard overflowing its local capacity must trigger the
        # retry even when the global total fits
        max_local = int(jnp.max(counts))
        if max_local > cap_local:
            return amp, slot, tgt, jnp.asarray(2 * cap + 1)
        return amp, slot, tgt, total


# ---------------------------------------------------------------------
# distributed sort-join (the flagship d=1 path, sharded)
# ---------------------------------------------------------------------

from ..ops.neighbors_sortjoin import (  # noqa: E402
    SentinelCollision,
    _row_bucket,
    deletion_keys_device,
    join_pairs,
    pack2bit,
    unpack2bit_device,
    _verify_dist1_packed,
)
from ..ops.neighbors_jax import make_zobrist_pair  # noqa: E402


def _sharded_join_body(
    packed_shard, lengths_shard, packed_full, lengths_full, zob,
    width, n_total, rows_per_shard, cap_block, cap, cap2, window, log2d,
):
    """Per-device: local deletion keys -> route by hash range via
    all_to_all -> local join within the range -> local verification
    against the replicated code table."""
    D = 1 << log2d
    dev = jax.lax.axis_index("amps")

    padded_shard = unpack2bit_device(packed_shard, width)
    (k_hi, k_lo), valid = deletion_keys_device(padded_shard, lengths_shard, zob)
    base = dev * rows_per_shard
    owner = jnp.where(
        valid,
        base + jnp.arange(rows_per_shard, dtype=jnp.int32)[:, None],
        -1,
    )
    hi = k_hi.reshape(-1)
    lo = k_lo.reshape(-1)
    own = owner.reshape(-1)

    # stage keys into fixed-size per-destination blocks (dest = top
    # log2d bits of hi; invalid keys are dropped here — they carry no
    # information and would flood block 2^32-range otherwise)
    sent = jnp.uint32(0xFFFFFFFF)
    hi_r = jnp.where(own < 0, sent, hi)
    if log2d == 0:
        route = jnp.zeros(hi_r.shape, dtype=jnp.int32)
    else:
        route = (hi_r >> jnp.uint32(32 - log2d)).astype(jnp.int32)
    route = jnp.where(own < 0, D, route)  # invalid -> dropped bucket

    order = jnp.argsort(route)  # stable; groups destinations
    hi_s = hi_r[order]
    lo_s = lo[order]
    own_s = own[order]
    route_s = route[order]

    seg_start = jnp.concatenate(
        [jnp.zeros(1, bool), route_s[1:] != route_s[:-1]]
    )
    # position within destination segment
    idx = jnp.arange(route_s.shape[0], dtype=jnp.int32)
    seg_first = jnp.where(seg_start | (idx == 0), idx, 0)
    seg_first = jax.lax.associative_scan(jnp.maximum, seg_first)
    within = idx - seg_first
    counts = jnp.zeros((D,), jnp.int32).at[jnp.minimum(route_s, D - 1)].add(
        jnp.where(route_s < D, 1, 0)
    )
    block_over = jnp.max(counts)

    dst = jnp.where(
        (route_s < D) & (within < cap_block),
        route_s * cap_block + within,
        D * cap_block,  # spill slot (dropped; caught via block_over)
    )
    stage_hi = jnp.full((D * cap_block + 1,), sent, jnp.uint32).at[dst].set(hi_s)[:-1]
    stage_lo = jnp.zeros((D * cap_block + 1,), jnp.uint32).at[dst].set(lo_s)[:-1]
    stage_own = jnp.full((D * cap_block + 1,), -1, jnp.int32).at[dst].set(own_s)[:-1]

    r_hi = jax.lax.all_to_all(
        stage_hi.reshape(D, cap_block), "amps", 0, 0, tiled=False
    ).reshape(-1)
    r_lo = jax.lax.all_to_all(
        stage_lo.reshape(D, cap_block), "amps", 0, 0, tiled=False
    ).reshape(-1)
    r_own = jax.lax.all_to_all(
        stage_own.reshape(D, cap_block), "amps", 0, 0, tiled=False
    ).reshape(-1)

    pa, pb, n_flagged, n_pairs, over, _n_deep, _nw, _ns = join_pairs(
        r_hi, r_lo, r_own, n_total, cap=cap, cap2=cap2, window=window
    )

    ok = pa >= 0
    pa_c = jnp.maximum(pa, 0)
    pb_c = jnp.maximum(pb, 0)
    good = ok & _verify_dist1_packed(
        packed_full[pa_c], packed_full[pb_c],
        lengths_full[pa_c], lengths_full[pb_c],
    )

    stats = jnp.stack(
        [
            jax.lax.pmax(block_over, "amps"),
            jax.lax.pmax(n_flagged, "amps"),
            jax.lax.pmax(n_pairs, "amps"),
            jax.lax.pmax(over, "amps"),
            jnp.zeros((), jnp.int32),  # sentinel slot (impossible now)
        ]
    )
    return pa[None], pb[None], good[None], stats


class SortJoinShardedEngine:
    """Distributed d=1 sort-join over a device mesh.

    Decomposition: amplicon shards generate deletion keys in parallel;
    keys travel to their hash-range owner (all_to_all);
    each device joins + verifies its range against the replicated
    2-bit code table; the host concatenates the per-range verified
    pairs (ranges are disjoint, so the union is exact).
    """

    def __init__(self, db, mesh: Mesh = None):
        devices = jax.devices()
        if mesh is None:
            d_pow2 = 1 << (len(devices).bit_length() - 1)
            mesh = Mesh(np.array(devices[:d_pow2]), ("amps",))
        self.mesh = mesh
        self.D = mesh.devices.size
        assert self.D & (self.D - 1) == 0, "device count must be a power of 2"
        self.log2d = self.D.bit_length() - 1

        from ..ops.neighbors import pad_codes
        from ..ops.neighbors_jax import _round_up

        n = len(db)
        self.n = n
        max_len = max(int(db.longest), 1)
        self.width = _round_up(max_len, 64)
        rows = _row_bucket(max(n, 1))
        rows = -(-rows // self.D) * self.D
        self.n_pad = rows
        padded = np.zeros((rows, self.width), dtype=np.uint8)
        padded[:n] = pad_codes(db.codes, db.offsets, db.lengths, self.width)
        self.padded_np = padded
        lengths = np.zeros(rows, dtype=np.int32)
        lengths[:n] = db.lengths
        self.lengths_np = lengths
        self.zob_np = np.asarray(make_zobrist_pair(self.width))
        self.packed_np = pack2bit(padded)
        self._fns = {}
        # multi-process (jax.distributed) meshes need explicitly global
        # arrays; single-process meshes take plain device arrays
        self.multiprocess = jax.process_count() > 1

    def _put(self, arr, spec):
        """Place a host-side array for the mesh: plain transfer on one
        process, global-array construction across processes (each host
        provides the shards its devices own)."""
        if not self.multiprocess:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding

        sharding = NamedSharding(self.mesh, spec)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    def _gather(self, garr):
        """Bring a P('amps')-sharded output back to every host."""
        if not self.multiprocess:
            return np.asarray(garr)
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(garr, tiled=True))

    def _fn(self, cap_block, cap, cap2, window):
        key = (cap_block, cap, cap2, window)
        fn = self._fns.get(key)
        if fn is None:
            rows_per_shard = self.n_pad // self.D
            body = partial(
                _sharded_join_body,
                width=self.width, n_total=self.n_pad,
                rows_per_shard=rows_per_shard, cap_block=cap_block,
                cap=cap, cap2=cap2, window=window, log2d=self.log2d,
            )
            mapped = jax.shard_map(
                body,
                mesh=self.mesh,
                in_specs=(P("amps"), P("amps"), P(), P(), P()),
                out_specs=(P("amps"), P("amps"), P("amps"), P()),
            )
            fn = jax.jit(mapped)
            self._fns[key] = fn
        return fn

    def build_network(self, no_break: bool, abundances: np.ndarray):
        n = self.n
        if n == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)

        packed_sh = self._put(self.packed_np, P("amps"))
        lengths_sh = self._put(self.lengths_np, P("amps"))
        packed_rep = self._put(self.packed_np, P())
        lengths_rep = self._put(self.lengths_np, P())
        zob = self._put(self.zob_np, P())

        keys_per_shard = (self.n_pad // self.D) * (self.width + 1)
        cap_block = max(1024, int(keys_per_shard / self.D * 1.5))
        cap = 1 << max(12, (2 * n // self.D - 1).bit_length())
        cap2 = cap
        window = 8
        while True:
            fn = self._fn(cap_block, cap, cap2, window)
            pa, pb, good, stats = fn(
                packed_sh, lengths_sh, packed_rep, lengths_rep, zob
            )
            block_over, f_max, p_max, over, sentinel = (
                int(x) for x in np.asarray(stats)
            )
            if sentinel > 0:
                raise SentinelCollision("sentinel key collision")
            if block_over > cap_block:
                cap_block = int(block_over * 1.25)
                continue
            if over > 0:
                window *= 2
                continue
            if f_max > cap:
                cap *= 2
                cap2 = max(cap2, cap)
                continue
            if p_max > cap2:
                cap2 *= 2
                continue
            break

        good_np = self._gather(good).reshape(-1)
        pa_np = self._gather(pa).reshape(-1)[good_np].astype(np.int64)
        pb_np = self._gather(pb).reshape(-1)[good_np].astype(np.int64)

        packed_pairs = np.unique(pa_np * np.int64(self.n_pad) + pb_np)
        pa_np = packed_pairs // self.n_pad
        pb_np = packed_pairs % self.n_pad

        ef = np.concatenate([pa_np, pb_np])
        et = np.concatenate([pb_np, pa_np])
        if not no_break:
            keep = abundances[ef] >= abundances[et]
            ef, et = ef[keep], et[keep]
        order = np.lexsort((et, ef))
        return ef[order], et[order]


# ---------------------------------------------------------------------
# distributed fastidious graft join (SURVEY.md section 5.8; the
# single-device engine is ops/fastidious_jax.py)
# ---------------------------------------------------------------------

from ..ops.fastidious_jax import _SENT32, _variant_rows  # noqa: E402
from ..ops.neighbors_jax import variant_hash_halves  # noqa: E402


def _shard_variant_keys(ids, padded_full, lengths_full, zob, lcap):
    """Variant-hash keys for one side's shard of amplicon ids.

    Returns flattened (hi, lo, amp, slot, valid) with the kind-major
    slot layout truncated to lcap (ops/fastidious_jax.variant_keys_hilo
    semantics, re-derived here because shard_map bodies must stay
    jit-inline)."""
    W = padded_full.shape[1]
    rows = padded_full[jnp.maximum(ids, 0)]
    lens = jnp.where(ids >= 0, lengths_full[jnp.maximum(ids, 0)], 0)
    (h_hi, h_lo), _, valid = variant_hash_halves(rows, lens, zob)
    C = h_hi.shape[0]

    def trunc(x):
        return jnp.concatenate(
            [
                x[:, : 7 * W].reshape(C, 7, W)[:, :, :lcap].reshape(C, 7 * lcap),
                x[:, 7 * W:],
            ],
            axis=1,
        )

    h_hi, h_lo, valid = trunc(h_hi), trunc(h_lo), trunc(valid)
    valid = valid & (ids[:, None] >= 0)
    S = 7 * lcap + 4
    amp = jnp.broadcast_to(ids[:, None], (C, S))
    slot = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, :], (C, S))
    return (
        h_hi.reshape(-1), h_lo.reshape(-1),
        amp.reshape(-1), slot.reshape(-1), valid.reshape(-1),
    )


def _route_blocks(hi, lo, amp, meta, valid, log2d, cap_block):
    """Stage keys into fixed per-destination blocks (dest = top log2d
    bits of hi) and exchange them (all_to_all). Returns the received
    (hi, lo, amp, meta) streams plus the largest block fill (overflow
    detection)."""
    D = 1 << log2d
    sent = _SENT32
    hi_r = jnp.where(valid, hi, sent)
    if log2d == 0:
        # a full-width shift (32 - 0) is undefined; one device owns the
        # whole hash range
        route = jnp.zeros(hi_r.shape, dtype=jnp.int32)
    else:
        route = (hi_r >> jnp.uint32(32 - log2d)).astype(jnp.int32)
    route = jnp.where(valid, route, D)

    order = jnp.argsort(route)
    hi_s = hi_r[order]
    lo_s = lo[order]
    amp_s = amp[order]
    meta_s = meta[order]
    route_s = route[order]

    seg_start = jnp.concatenate(
        [jnp.zeros(1, bool), route_s[1:] != route_s[:-1]]
    )
    idx = jnp.arange(route_s.shape[0], dtype=jnp.int32)
    seg_first = jnp.where(seg_start | (idx == 0), idx, 0)
    seg_first = jax.lax.associative_scan(jnp.maximum, seg_first)
    within = idx - seg_first
    counts = jnp.zeros((D,), jnp.int32).at[jnp.minimum(route_s, D - 1)].add(
        jnp.where(route_s < D, 1, 0)
    )
    block_over = jnp.max(counts)

    dst = jnp.where(
        (route_s < D) & (within < cap_block),
        route_s * cap_block + within,
        D * cap_block,
    )

    def stage(vals, fill):
        buf = jnp.full((D * cap_block + 1,), fill, vals.dtype)
        return buf.at[dst].set(vals)[:-1].reshape(D, cap_block)

    r = [
        jax.lax.all_to_all(stage(v, f), "amps", 0, 0, tiled=False).reshape(-1)
        for v, f in (
            (hi_s, sent), (lo_s, jnp.uint32(0)),
            (amp_s, jnp.int32(-1)), (meta_s, jnp.int32(0)),
        )
    ]
    return r[0], r[1], r[2], r[3], block_over


def _sharded_graft_body(
    ids_small, ids_big, packed_full, lengths_full, zob,
    width, lcap, cap_block, cap3, cap, window, log2d, small_is_heavy,
):
    """Per-device: variant keys for both sides' shards -> hash-range
    all_to_all -> local sort-join with cross-side windowed runs ->
    midpoint verification against the replicated code table."""
    padded_full = unpack2bit_device(packed_full, width)

    s_hi, s_lo, s_amp, s_slot, s_val = _shard_variant_keys(
        ids_small, padded_full, lengths_full, zob, lcap
    )
    b_hi, b_lo, b_amp, b_slot, b_val = _shard_variant_keys(
        ids_big, padded_full, lengths_full, zob, lcap
    )
    # meta carries (slot | side << 16); slots are < 7*lcap+4 <= 65535
    hi = jnp.concatenate([s_hi, b_hi])
    lo = jnp.concatenate([s_lo, b_lo])
    amp = jnp.concatenate([s_amp, b_amp])
    meta = jnp.concatenate([s_slot, b_slot | jnp.int32(1 << 16)])
    valid = jnp.concatenate([s_val, b_val])

    r_hi, r_lo, r_amp, r_meta, block_over = _route_blocks(
        hi, lo, amp, meta, valid, log2d, cap_block
    )

    k_hi, k_lo, k_amp, k_meta = jax.lax.sort(
        (r_hi, r_lo, r_amp, r_meta), num_keys=2, is_stable=False
    )
    M = k_hi.shape[0]
    val = (k_amp >= 0) & ~((k_hi == _SENT32) & (k_lo == _SENT32))
    side_big = (k_meta >> 16) != 0

    def shifted(j, cross):
        eq = (k_hi[j:] == k_hi[:-j]) & (k_lo[j:] == k_lo[:-j])
        eq = eq & val[j:] & val[:-j]
        if cross:
            eq = eq & (side_big[j:] != side_big[:-j])
        return jnp.concatenate([jnp.zeros(j, dtype=bool), eq])

    eqs = [shifted(j, True) for j in range(1, window + 1)]
    anyflag = eqs[0]
    for e in eqs[1:]:
        anyflag = anyflag | e
    over = (
        shifted(window + 1, False) if M > window + 1
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

    a_pos = jnp.where(picked2, a_pos_f[psel], 0)
    b_pos = jnp.where(picked2, b_pos_f[psel], 0)
    a_amp = jnp.where(picked2, k_amp[a_pos], 0)
    b_amp = jnp.where(picked2, k_amp[b_pos], 0)
    a_slot = k_meta[a_pos] & jnp.int32(0xFFFF)
    b_slot = k_meta[b_pos] & jnp.int32(0xFFFF)
    a_big = (k_meta[a_pos] >> 16) != 0

    rows_a, len_a = _variant_rows(
        padded_full, lengths_full, a_amp, a_slot, width, lcap
    )
    rows_b, len_b = _variant_rows(
        padded_full, lengths_full, b_amp, b_slot, width, lcap
    )
    good = picked2 & (len_a == len_b) & jnp.all(rows_a == rows_b, axis=1)

    a_is_heavy = (~a_big) == small_is_heavy
    h_amp = jnp.where(a_is_heavy, a_amp, b_amp)
    l_amp = jnp.where(a_is_heavy, b_amp, a_amp)

    stats = jnp.stack(
        [
            jax.lax.pmax(block_over, "amps"),
            jax.lax.pmax(n_flagged, "amps"),
            jax.lax.pmax(n_pairs, "amps"),
            jax.lax.pmax(overflow_run, "amps"),
        ]
    )
    return h_amp[None], l_amp[None], good[None], stats


class ShardedGraftEngine:
    """Distributed graft-candidate discovery: both sides' variant keys
    are generated shard-parallel, routed to hash-range owners over the
    device interconnect, joined and midpoint-verified per range. Same contract as
    ops/fastidious_jax.GraftEngine.graft_candidates (count semantics:
    one verified triple per distinct midpoint instance)."""

    def __init__(self, padded_np, lengths_np, zob_pair_np, mesh: Mesh = None):
        devices = jax.devices()
        if mesh is None:
            d_pow2 = 1 << (len(devices).bit_length() - 1)
            mesh = Mesh(np.array(devices[:d_pow2]), ("amps",))
        self.mesh = mesh
        self.D = mesh.devices.size
        assert self.D & (self.D - 1) == 0
        self.log2d = self.D.bit_length() - 1

        self.width = padded_np.shape[1]
        self.n = padded_np.shape[0]
        from ..ops.neighbors_sortjoin import pack2bit

        self.packed = jnp.asarray(pack2bit(padded_np))
        self.lengths = jnp.asarray(lengths_np.astype(np.int32))
        self.zob = jnp.asarray(zob_pair_np)
        lcap = int(-(-int(lengths_np.max() if len(lengths_np) else 1) // 16) * 16)
        self.lcap = max(16, min(lcap, self.width))
        assert 7 * self.lcap + 4 < (1 << 16)
        self._fns = {}

    def _fn(self, rows_side, cap_block, cap3, cap, window, small_is_heavy):
        key = (rows_side, cap_block, cap3, cap, window, small_is_heavy)
        fn = self._fns.get(key)
        if fn is None:
            body = partial(
                _sharded_graft_body,
                width=self.width, lcap=self.lcap, cap_block=cap_block,
                cap3=cap3, cap=cap, window=window, log2d=self.log2d,
                small_is_heavy=small_is_heavy,
            )
            mapped = jax.shard_map(
                body,
                mesh=self.mesh,
                in_specs=(P("amps"), P("amps"), P(), P(), P()),
                out_specs=(P("amps"), P("amps"), P("amps"), P()),
            )
            fn = jax.jit(mapped)
            self._fns[key] = fn
        return fn

    def graft_candidates(self, heavy_amps: np.ndarray, light_amps: np.ndarray):
        if len(heavy_amps) == 0 or len(light_amps) == 0:
            return 0, np.full(self.n, -1, dtype=np.int64)

        small_is_heavy = len(heavy_amps) <= len(light_amps)
        small = heavy_amps if small_is_heavy else light_amps
        big = light_amps if small_is_heavy else heavy_amps

        def pad_ids(amps, rows):
            ids = np.full(rows, -1, dtype=np.int32)
            ids[: len(amps)] = amps
            return jnp.asarray(ids)

        def side_rows(n_amps):
            per_dev = max(64, -(-n_amps // self.D))
            return per_dev * self.D

        rows_small = side_rows(len(small))
        rows_big = side_rows(len(big))
        rows_side = (rows_small, rows_big)
        ids_small = pad_ids(small, rows_small)
        ids_big = pad_ids(big, rows_big)

        S = 7 * self.lcap + 4
        keys_per_dev = (rows_small + rows_big) // self.D * S
        cap_block = max(1024, int(keys_per_dev / self.D * 1.5))
        cap3 = 1 << 15
        cap = 1 << 15
        window = 8
        while True:
            fn = self._fn(rows_side, cap_block, cap3, cap, window,
                          small_is_heavy)
            h_amp, l_amp, good, stats = fn(
                ids_small, ids_big, self.packed, self.lengths, self.zob
            )
            block_over, f_max, p_max, over = (
                int(x) for x in np.asarray(stats)
            )
            if block_over > cap_block:
                cap_block = int(block_over * 1.25)
                continue
            if over > 0:
                window *= 2
                continue
            if f_max > cap3:
                cap3 *= 2
                continue
            if p_max > cap:
                cap *= 2
                continue
            break

        good_np = np.asarray(good).reshape(-1)
        h = np.asarray(h_amp).reshape(-1)[good_np].astype(np.int64)
        l = np.asarray(l_amp).reshape(-1)[good_np].astype(np.int64)
        total = int(good_np.sum())
        graft_cand = np.full(self.n, -1, dtype=np.int64)
        if total:
            order = np.lexsort((h, l))
            l_sorted, h_sorted = l[order], h[order]
            first = np.ones(len(l_sorted), dtype=bool)
            first[1:] = l_sorted[1:] != l_sorted[:-1]
            graft_cand[l_sorted[first]] = h_sorted[first]
        return total, graft_cand
