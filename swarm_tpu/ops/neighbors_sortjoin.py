"""Sort-join d=1 network builder — the device fast path.

Algorithm (symmetric-delete join): two distinct sequences are at edit
distance 1 iff they share a key in

    keys(x) = {hash(x)} UNION {hash(del_p(x)) : p a run start}

(substitution at p: both lose the differing base under del_p; deletion/
insertion: the shorter sequence IS a deletion of the longer; restricting
to run starts is lossless because del_p(x) == del_{run_start(p)}(x)).
This needs ~R+1 <= L+1 keys per sequence versus the reference's 7L+4
enumerated microvariants (src/variants.cc:184-249) — and it turns the
per-variant hash-table probe (pointer chasing, src/algod1.cc:558-627)
into ONE global sort, which XLA executes far better than the
binary-search gathers of a probe join.

Two jitted programs, shapes bucketed so the persistent compile cache
hits across datasets:

  prepare(packed, lengths, zob):
      2-bit-packed codes (H2D is 4x smaller than byte codes)
      -> device unpack -> deletion-key hashes (uint32 pairs, XOR
      prefix/suffix scans) -> (padded codes, key arrays)

  edges(hi, lo, owner, padded, lengths):
      lax.sort((invalid, hi, lo, owner)) -> windowed run detection
      (key[i] == key[i-j], j <= window) -> compaction -> canonical
      pair dedup (second sort) -> exact dist<=1 verification via
      device gathers -> verified unique pairs.

The host applies the abundance rule in both directions and the final
canonical (from, to) lexsort. False positives (shared deletion key but
distance 2, or hash collision) are removed by the exact verifier; false
negatives cannot occur for window >= max key-run length, which is
enforced by a device-side check with doubling retry.
"""

import os
from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .neighbors_jax import _round_up, make_zobrist_pair

BASES_PER_WORD = 16  # 2-bit codes per uint32


def pack2bit(padded: np.ndarray) -> np.ndarray:
    """[n, W] uint8 codes (0..3) -> [n, W/16] uint32, little-endian bases."""
    n, W = padded.shape
    assert W % BASES_PER_WORD == 0
    from .. import _native

    if _native.available() and n:
        return _native.pack_rows(padded)
    words = padded.astype(np.uint32).reshape(n, W // BASES_PER_WORD, BASES_PER_WORD)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, None, :]
    return np.bitwise_or.reduce(words << shifts, axis=2)


def unpack2bit_device(packed: jnp.ndarray, width: int) -> jnp.ndarray:
    """[n, W/16] uint32 -> [n, W] uint8 codes (shift + reshape, no gather)."""
    n, words = packed.shape
    shifts = (2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32))[None, None, :]
    codes = ((packed[:, :, None] >> shifts) & 3).astype(jnp.uint8)
    return codes.reshape(n, words * BASES_PER_WORD)


def _ztable_select(z_row: jnp.ndarray, pidx: jnp.ndarray) -> jnp.ndarray:
    """g[c, p] = z_row[p, s_cp] without a gather: 4-way select-sum.

    z_row: [L, 4] uint32 (position-indexed table); pidx: [C, L] int32.
    A 4-way masked sum is ~8 full-width elementwise ops that fuse into
    the surrounding program; whether a gather is faster on the GPU is
    not yet measured.
    """
    acc = jnp.where(pidx == 0, z_row[None, :, 0], jnp.uint32(0))
    for b in range(1, 4):
        acc = acc ^ jnp.where(pidx == b, z_row[None, :, b], jnp.uint32(0))
    return acc


def deletion_keys_device(
    padded: jnp.ndarray, lengths: jnp.ndarray, zob: jnp.ndarray
) -> Tuple[list, jnp.ndarray]:
    """Keys ([C, L+1] hi, [C, L+1] lo) (slot 0 = sequence hash, slot p+1
    = del at p) and validity [C, L+1].

    The (hi, lo) hash halves are computed as fully independent arrays
    (a trailing axis of size 2 would make every access strided).
    """
    C, L = padded.shape
    pos = jnp.arange(L, dtype=jnp.int32)
    mask = pos[None, :] < lengths[:, None]  # [C, L]
    pidx = padded.astype(jnp.int32)
    zero = jnp.zeros((), dtype=jnp.uint32)

    halves = []
    for h in range(2):
        z = zob[..., h]  # [L+2, 4]
        g0 = jnp.where(mask, _ztable_select(z[:L], pidx), zero)  # Z[p, s_p]
        gm1 = jnp.where(
            mask & (pos[None, :] >= 1),
            _ztable_select(
                jnp.concatenate([z[:1], z[: L - 1]]), pidx
            ),
            zero,
        )  # Z[p-1, s_p] (row p of the shifted table; p=0 is masked off)

        incl = jax.lax.associative_scan(jnp.bitwise_xor, g0, axis=1)
        seqhash = incl[:, -1:]  # [C, 1]
        prefix = jnp.concatenate(
            [jnp.zeros_like(g0[:, :1]), incl[:, :-1]], axis=1
        )
        sufdel = jax.lax.associative_scan(
            jnp.bitwise_xor, gm1, axis=1, reverse=True
        )
        sufdel_next = jnp.concatenate(
            [sufdel[:, 1:], jnp.zeros_like(sufdel[:, :1])], axis=1
        )
        dele = prefix ^ sufdel_next  # [C, L]; hash of del_p(x)
        halves.append(jnp.concatenate([seqhash, dele], axis=1))  # [C, L+1]

    run_start = jnp.concatenate(
        [jnp.ones((C, 1), dtype=bool), padded[:, 1:] != padded[:, :-1]], axis=1
    )
    valid = jnp.concatenate([lengths[:, None] > 0, mask & run_start], axis=1)
    return halves, valid


# two independent odd multipliers; their mod-2^32 inverses reweight the
# suffix terms after a deletion (r * rinv == 1 mod 2^32)
_POLY_R = (0x9E3779B1, 0x85EBCA77)
_POLY_RINV = tuple(pow(r, -1, 1 << 32) for r in _POLY_R)


def deletion_keys_poly(padded: jnp.ndarray, lengths: jnp.ndarray):
    """Polynomial-rolling-hash deletion keys — same contract as
    deletion_keys_device, ~half the scan traffic.

    h(x) = sum_q (s_q + 1) * r^q mod 2^32. Deleting position p shifts
    the suffix weights down one power:

        h(del_p(x)) = pre[p] + rinv * (tot - pre[p] - (s_p+1) r^p)

    so each half needs ONE additive prefix scan (the Zobrist pair
    needs two XOR scans plus a second shifted-table select per half).
    Equal underlying strings hash equal by construction, so the join
    loses no true pairs; mod-2^32 polynomial hashes have weak LOW bits,
    but join_pairs compares hi on full-width equality (any extra
    collisions only add flagged slots for the exact verifier) and takes
    the SECOND half's strong TOP bits for the k2 prefix.
    """
    C, L = padded.shape
    pos = jnp.arange(L, dtype=jnp.int32)
    mask = pos[None, :] < lengths[:, None]
    s = padded.astype(jnp.uint32) + jnp.uint32(1)

    halves = []
    for r, rinv in zip(_POLY_R, _POLY_RINV):
        rp = np.empty(L, dtype=np.uint32)
        acc = 1
        for q in range(L):
            rp[q] = acc
            acc = (acc * r) & 0xFFFFFFFF
        term = jnp.where(mask, s * jnp.asarray(rp)[None, :], jnp.uint32(0))
        incl = jax.lax.associative_scan(jnp.add, term, axis=1)
        tot = incl[:, -1:]
        pre = jnp.concatenate(
            [jnp.zeros_like(term[:, :1]), incl[:, :-1]], axis=1
        )
        dele = pre + jnp.uint32(rinv) * (tot - pre - term)
        halves.append(jnp.concatenate([tot, dele], axis=1))  # [C, L+1]

    run_start = jnp.concatenate(
        [jnp.ones((C, 1), dtype=bool), padded[:, 1:] != padded[:, :-1]],
        axis=1,
    )
    valid = jnp.concatenate([lengths[:, None] > 0, mask & run_start], axis=1)
    return halves, valid


def _d1_hash_mode() -> str:
    return os.environ.get("SWARM_TPU_D1_HASH", "poly")


@partial(jax.jit, static_argnames=("width",))
def prepare_network(packed, lengths, zob, width):
    """(padded [n, W] u8, hi [M], lo [M], owner [M]) for the whole db.

    Kept for unit tests; the production path is network_pairs, which
    fuses preparation and join into one program, so the key arrays stay
    fused intermediates instead of program outputs.
    """
    padded = unpack2bit_device(packed, width)
    (keys_hi, keys_lo), valid = deletion_keys_device(padded, lengths, zob)
    n = padded.shape[0]
    owner = jnp.where(valid, jnp.arange(n, dtype=jnp.int32)[:, None], -1)
    return padded, keys_hi.reshape(-1), keys_lo.reshape(-1), owner.reshape(-1)


@partial(
    jax.jit,
    static_argnames=(
        "width", "lcap", "cap", "cap2", "window", "cap_deep", "capw",
        "capf",
    ),
)
def network_pairs(
    packed, lengths, zob, width, lcap, cap, cap2, window, cap_deep=None,
    capw=None, capf=None,
):
    """Fused join WITHOUT verification: packed codes in, unique candidate
    pairs out, plus one status vector.

    The join and the verification (verify_pairs_compact) are two
    programs: each emits only O(pairs) data, while device-resident
    INPUTS (packed) are re-passed for free. Whether one fused program
    is faster on the GPU is not yet measured. The status comes back as
    a single int32 vector ([n_flagged, n_pairs, overflow_run, 0,
    n_deep, n_words, n_sub]) so the retry loop costs one tiny readback
    instead of one per count.

    lcap (real length cap, 16-bucketed) trims the slot axis below the
    tile-aligned width: at 150 nt / width 192 that is ~17% fewer hash
    scans AND ~17% fewer sort keys — every slot beyond lcap is padding
    and can never hold a valid deletion key.
    """
    padded = unpack2bit_device(packed, width)
    if _d1_hash_mode() == "zobrist":
        (keys_hi, keys_lo), valid = deletion_keys_device(
            padded[:, :lcap], lengths, zob
        )
    else:
        (keys_hi, keys_lo), valid = deletion_keys_poly(
            padded[:, :lcap], lengths
        )
    n = padded.shape[0]
    owner = jnp.where(valid, jnp.arange(n, dtype=jnp.int32)[:, None], -1)
    (pa, pb, n_flagged, n_pairs, overflow_run, n_deep, n_words,
     n_sub) = join_pairs(
        keys_hi.reshape(-1), keys_lo.reshape(-1), owner.reshape(-1), n,
        cap=cap, cap2=cap2, window=window, cap_deep=cap_deep, capw=capw,
        capf=capf,
    )
    status = jnp.stack(
        [n_flagged, n_pairs, overflow_run, jnp.zeros((), jnp.int32),
         n_deep, n_words, n_sub]
    )
    return pa, pb, status


@partial(jax.jit, static_argnames=("width",))
def verify_pairs(packed, lengths, pa, pb, width):
    """Exact dist<=1 verification of candidate pairs (device gathers).

    Gathers the 2-bit PACKED rows (width/16 uint32 words) instead of
    unpacked byte codes: the row gather is the dominant cost at 1M-pair
    capacities and packed rows move 4x fewer bytes. The check itself
    runs on the packed words (XOR + 2-bit-field popcounts + a one-field
    funnel shift) — see _verify_dist1_packed.
    """
    del width  # packed rows carry their own word count
    ok = pa >= 0
    pa_c = jnp.maximum(pa, 0)
    pb_c = jnp.maximum(pb, 0)
    return ok & _verify_dist1_packed(
        packed[pa_c], packed[pb_c], lengths[pa_c], lengths[pb_c]
    )


@partial(jax.jit, static_argnames=("n", "cap3"))
def verify_pairs_compact(packed, lengths, pa, pb, n, cap3):
    """Exact dist<=1 verification + device dedup + compaction.

    Instead of shipping the full [cap2] candidate arrays plus a bool
    mask to the host, this program sorts the VERIFIED pairs
    canonically, drops duplicates (a pair found via several
    shared keys), and returns only [cap3] compacted slots plus a
    count. cap3 tracks the real pair population (persisted alongside
    the join params); retry with doubled cap3 when status[0] > cap3.

    Returns (gab [2, cap3], status int32[2]) where status[0] is the
    number of unique verified pairs; gab[0]/gab[1] come back sorted by
    (a, b) with -1 filler.
    """
    ok = pa >= 0
    pa_c = jnp.maximum(pa, 0)
    pb_c = jnp.maximum(pb, 0)
    good = ok & _verify_dist1_packed(
        packed[pa_c], packed[pb_c], lengths[pa_c], lengths[pb_c]
    )
    # canonical sort; failed slots carry the n sentinel and sink to
    # the end (pa < pb < n for every real pair)
    big = jnp.int32(n)
    s_a, s_b = jax.lax.sort(
        (jnp.where(good, pa, big), jnp.where(good, pb, big)), num_keys=2,
        is_stable=False,
    )
    uniq = jnp.concatenate(
        [
            jnp.ones(1, dtype=bool),
            (s_a[1:] != s_a[:-1]) | (s_b[1:] != s_b[:-1]),
        ]
    )
    keep = uniq & (s_a < big)
    n_good = jnp.sum(keep, dtype=jnp.int32)
    (gsel,) = jnp.nonzero(keep, size=cap3, fill_value=0)
    gpicked = jnp.arange(cap3, dtype=jnp.int32) < n_good
    ga = jnp.where(gpicked, s_a[jnp.minimum(gsel, s_a.shape[0] - 1)], -1)
    gb = jnp.where(gpicked, s_b[jnp.minimum(gsel, s_b.shape[0] - 1)], -1)
    status = jnp.stack([n_good, jnp.zeros((), jnp.int32)])
    # one [2, cap3] output: the pair lists come back to the host in a
    # single transfer instead of two
    return jnp.stack([ga, gb]), status


def _field_mask(k):
    """Bits [0, 2k) set, for per-word 2-bit-field counts k in [0, 16]
    (uint32-safe at both ends: shift amounts stay < 32)."""
    kc = jnp.clip(k, 0, 15).astype(jnp.uint32)
    part = (jnp.uint32(1) << (2 * kc)) - jnp.uint32(1)
    full = jnp.uint32(0xFFFFFFFF)
    return jnp.where(k >= 16, full, jnp.where(k <= 0, jnp.uint32(0), part))


def _verify_dist1_packed(xa, xb, La, Lb):
    """Exact edit-distance==1 over gathered 2-bit-packed rows.

    Same semantics as _verify_dist1_rows (the byte-codes version, kept
    as the oracle): equal lengths -> exactly one mismatching base;
    length difference 1 -> the shorter equals the longer with one base
    deleted. Rows are [P, Wd] uint32, base j at bits 2*(j%16) of word
    j//16, zero-padded past the sequence length (pack2bit layout).
    """
    P, Wd = xa.shape
    u1 = jnp.uint32(0x55555555)
    widx = jnp.arange(Wd, dtype=jnp.int32)[None, :]  # [1, Wd]

    # --- equal lengths: exactly one mismatching 2-bit field ---
    # (padding is zero on both sides at equal lengths, so no mask)
    x0 = xa ^ xb
    m0 = (x0 | (x0 >> 1)) & u1
    nmis = jnp.sum(jnp.bitwise_count(m0), axis=1)
    same_ok = (La == Lb) & (nmis == 1)

    # --- length difference 1: x = longer, y = shorter ---
    a_long = (La >= Lb)[:, None]
    xw = jnp.where(a_long, xa, xb)
    yw = jnp.where(a_long, xb, xa)
    ly = jnp.minimum(La, Lb).astype(jnp.int32)  # [P]

    # first mismatching field f in [0, ly); f = ly when the shorter is
    # a prefix of the longer (deleting the longer's last base works)
    d0 = xw ^ yw
    md = (d0 | (d0 >> 1)) & u1
    md = md & _field_mask(ly[:, None] - 16 * widx)
    has = md != 0
    w0 = jnp.min(jnp.where(has, widx, Wd), axis=1)  # [P]
    mword = jnp.sum(jnp.where(widx == w0[:, None], md, jnp.uint32(0)), axis=1)
    lsb = mword & (~mword + jnp.uint32(1))
    ctz = jnp.bitwise_count(lsb - jnp.uint32(1))  # 32 when mword == 0
    f = jnp.where(
        mword == 0, ly, (16 * w0 + (ctz >> 1).astype(jnp.int32))
    )  # [P]

    # suffix check: fields j in [f, ly) of (x >> one field) must equal y
    xs = (xw >> 2) | (
        jnp.concatenate([xw[:, 1:], jnp.zeros((P, 1), jnp.uint32)], axis=1)
        << 30
    )
    e = xs ^ yw
    em = (e | (e >> 1)) & u1
    lo = f[:, None] - 16 * widx
    hi = ly[:, None] - 16 * widx
    check = _field_mask(hi) & ~_field_mask(lo)
    diff_ok = (jnp.abs(La - Lb) == 1) & jnp.all((em & check) == 0, axis=1)
    return same_ok | diff_ok


def _verify_dist1_rows(rows_a, rows_b, La, Lb):
    """Exact edit-distance==1 over gathered code rows (jnp, vectorized).

    Mirrors the reference's check_variant semantics (src/variants.cc:118-165)
    without knowing the edit: equal lengths -> exactly one mismatch;
    length difference 1 -> shorter == longer with one base removed.
    """
    width = rows_a.shape[1]
    idx = jnp.arange(width, dtype=jnp.int32)[None, :]

    within_min = idx < jnp.minimum(La, Lb)[:, None]
    mism = (rows_a != rows_b) & within_min
    same_ok = (La == Lb) & (jnp.sum(mism, axis=1) == 1)

    x = jnp.where((La >= Lb)[:, None], rows_a, rows_b)  # longer
    y = jnp.where((La >= Lb)[:, None], rows_b, rows_a)  # shorter
    ly = jnp.minimum(La, Lb)
    within = idx < ly[:, None]
    e1 = (x == y) | ~within
    c = jnp.cumsum((~e1).astype(jnp.int32), axis=1) > 0  # from 1st mismatch on
    e2 = (x[:, 1:] == y[:, :-1]) | ~within[:, :-1]
    diff_ok = (jnp.abs(La - Lb) == 1) & jnp.all(e2 | ~c[:, :-1], axis=1)
    return same_ok | diff_ok


def join_pairs(
    keys_hi: jnp.ndarray,  # [M] uint32 (invalid keys may hold anything)
    keys_lo: jnp.ndarray,  # [M] uint32
    owner: jnp.ndarray,  # [M] int32 sequence id, -1 for invalid keys
    n: int,
    cap: int,
    cap2: int,
    window: int,
    cap_deep: int = None,
    capw: int = None,
    capf: int = None,
):
    """Unique candidate pairs (pa < pb) sharing a deletion key.

    Returns (pa [cap2], pb [cap2], n_flagged, n_pairs, overflow_run,
    n_deep, n_words, n_sub); filler slots hold -1. Retry with a bigger
    cap / cap2 / window / cap_deep / capw / capf when n_flagged > cap /
    n_pairs > cap2 / overflow_run > 0 / n_deep > cap_deep / n_words >
    capw / n_sub > capf. capw and capf default to cap, which never
    overflows (every occupied word/subword holds >= 1 flagged slot);
    tighter values shrink the level inputs (see below).

    Shape of the hot path:
      * the sort orders by keys_hi ALONE (num_keys=1) with the packed
        (keys_lo prefix << OB) | owner word riding as a payload: a
        1-key sort is cheaper than a 2-key sort (its lowering on the
        GPU is recorded in PERF.md). Full-key equality moves into the flagged-element checks,
        where the payload word is being gathered anyway for the owner.
      * invalid slots carry the all-ones sentinel in both words; a
        real key can never equal it because real owners are < 2^OB-1,
        so the sentinel-collision fallback of the 3-operand design is
        structurally unnecessary.
      * equal-HI runs are contiguous, but equal FULL keys inside an hi
        run need not be adjacent (e.g. lo-values K1 K2 K1), so flags
        are hi-run based: an element is flagged iff its full key
        equals the previous slot's (the dominant j=1 case — an
        elementwise shifted compare, no gathers) OR it sits at depth
        >= 2 of an hi run (it may have a full-key partner farther
        back). Chance hi collisions are almost all isolated length-2
        runs — full_eq false, depth < 2 — so they do NOT inflate the
        flagged set (expected extra flags: M^2/2^33 * P(run >= 3),
        ~1e5 at 1M amplicons).
      * runs longer than 2 are rare (hash collisions or dense
        microvariant clusters), so the j>=2 partner checks run on a
        second, much smaller compaction (the "deep" subset). Hi-key
        equality j slots back is the AND of the intervening hi_eq1
        bits — bool gathers, not key-word gathers — and the partner's
        payload word (gathered for its owner) also carries the lo
        prefix for the full-key check.
    """
    if cap_deep is None:
        cap_deep = cap
    if capw is None:
        capw = cap
    if capf is None:
        capf = cap
    M = keys_hi.shape[0]
    ob = max(int(n).bit_length(), 8)  # owner field bits; n < 2^ob - 1
    lb = max(32 - ob, 0)  # keys_lo bits that still discriminate
    sent = jnp.uint32(0xFFFFFFFF)
    invalid = owner < 0
    if lb > 0:
        k2 = ((keys_lo >> (32 - lb)) << ob) | owner.astype(jnp.uint32)
    else:
        k2 = owner.astype(jnp.uint32)
    keys_hi = jnp.where(invalid, sent, keys_hi)
    k2 = jnp.where(invalid, sent, k2)
    s_hi, s_k2 = jax.lax.sort((keys_hi, k2), num_keys=1, is_stable=False)

    omask = jnp.uint32((1 << ob) - 1)
    val = s_k2 != sent  # invalid iff both words all-ones; hi can be FF

    hi_eq1 = (s_hi[1:] == s_hi[:-1]) & val[1:] & val[:-1]
    hi_eq1 = jnp.concatenate([jnp.zeros(1, dtype=bool), hi_eq1])
    if lb > 0:
        full_eq1 = hi_eq1 & jnp.concatenate(
            [
                jnp.zeros(1, dtype=bool),
                (s_k2[1:] >> ob) == (s_k2[:-1] >> ob),
            ]
        )
    else:
        full_eq1 = hi_eq1
    # depth >= 2 of an hi run: may hold a non-adjacent full-key partner
    depth2 = hi_eq1 & jnp.concatenate([jnp.zeros(1, dtype=bool), hi_eq1[:-1]])
    eq1 = full_eq1 | depth2

    n_flagged = jnp.sum(eq1, dtype=jnp.int32)
    # three-level compaction (32-slot words -> 8-slot subwords ->
    # flags): flagged slots are sparse but ISOLATED — sorted hash
    # order spreads key groups uniformly, so ~n_flagged words are
    # occupied and a single wide level cannot compress. Each nonzero's
    # cost is ~linear in its input, so the level inputs M/32, 4*capw, and 8*capf (~14M total at 1M
    # amplicons) replace one M-sized pass.
    W32 = 32
    M32 = -(-M // W32) * W32
    af = jnp.concatenate(
        [eq1, jnp.zeros(M32 - M, dtype=bool)]
    ).reshape(-1, W32)
    wflag = jnp.any(af, axis=1)
    n_words = jnp.sum(wflag, dtype=jnp.int32)
    (wsel,) = jnp.nonzero(wflag, size=capw, fill_value=0)
    w_picked = jnp.arange(capw, dtype=jnp.int32) < n_words
    bits = af[wsel] & w_picked[:, None]  # [capw, 32]

    sub = bits.reshape(capw * 4, 8)
    sflag = jnp.any(sub, axis=1)
    n_sub = jnp.sum(sflag, dtype=jnp.int32)
    (ssel,) = jnp.nonzero(sflag, size=capf, fill_value=0)
    s_picked = jnp.arange(capf, dtype=jnp.int32) < n_sub
    bits2 = sub[ssel] & s_picked[:, None]  # [capf, 8]
    # base slot of the selected subword: word wsel[ssel//4], sub ssel%4
    swbase = wsel[ssel // 4] * W32 + (ssel % 4) * 8
    flat_idx = swbase[:, None] + jnp.arange(8, dtype=jnp.int32)[None, :]
    cand = jnp.where(bits2, flat_idx, M32).reshape(-1)  # ascending order
    (sel2,) = jnp.nonzero(cand < M32, size=cap, fill_value=0)
    sel = jnp.minimum(cand[sel2], M - 1)
    # valid selections are the prefix (nonzero returns ascending indices)
    picked = jnp.arange(cap, dtype=jnp.int32) < n_flagged

    a_k2 = s_k2[sel]
    a_col = jnp.where(picked, (a_k2 & omask).astype(jnp.int32), -1)

    # j == 1: a pair iff the full key equals the previous slot's
    # (full_eq1 — flagged elements may instead be depth-2 hi-run
    # members whose only match sits farther back). sel >= 1
    # structurally: eq1[0] is hardwired False.
    b1_col = (s_k2[jnp.maximum(sel - 1, 0)] & omask).astype(jnp.int32)
    ok1 = picked & full_eq1[sel] & (b1_col != a_col)
    pl1 = jnp.where(ok1, jnp.minimum(a_col, b1_col), n)
    ph1 = jnp.where(ok1, jnp.maximum(a_col, b1_col), n)

    # deep subset: flagged elements whose HI run extends at least 2
    # back (hi[i] == hi[i-2] iff hi_eq1[i] & hi_eq1[i-1]; hi_eq1[i]
    # holds for every flagged element by construction)
    deep_flag = picked & hi_eq1[jnp.maximum(sel - 1, 0)] & (sel >= 1)
    n_deep = jnp.sum(deep_flag, dtype=jnp.int32)
    (didx,) = jnp.nonzero(deep_flag, size=cap_deep, fill_value=0)
    dpicked = jnp.arange(cap_deep, dtype=jnp.int32) < n_deep
    dsel = jnp.minimum(sel[didx], M - 1)
    da_col = jnp.where(dpicked, a_col[didx], -1)
    da_pref = a_k2[didx] >> ob if lb > 0 else None

    # chain_j: hi[dsel] == hi[dsel - j], maintained as the AND of the
    # intervening adjacent-equality bits (sorted order makes equal-hi
    # runs contiguous, so endpoint equality == all-intermediate
    # equality). j=2 holds by construction of deep_flag. The partner
    # is a pair only if its payload's lo prefix also matches (full-key
    # equality; the payload word is gathered for the owner anyway).
    chain = dpicked
    dpl_cols, dph_cols = [], []
    for j in range(2, window + 1):
        if j > 2:
            chain = chain & hi_eq1[jnp.clip(dsel - (j - 1), 0, M - 1)]
        b_k2 = s_k2[jnp.clip(dsel - j, 0, M - 1)]
        b_col = (b_k2 & omask).astype(jnp.int32)
        ok = chain & (dsel >= j) & (b_col != da_col)
        if lb > 0:
            ok = ok & ((b_k2 >> ob) == da_pref)
        dpl_cols.append(jnp.where(ok, jnp.minimum(da_col, b_col), n))
        dph_cols.append(jnp.where(ok, jnp.maximum(da_col, b_col), n))
    # an equal hi key window+1 back means the run is longer than the
    # window can enumerate => escalate
    over_chain = chain & hi_eq1[jnp.clip(dsel - window, 0, M - 1)]
    over = jnp.sum(over_chain & (dsel >= window + 1), dtype=jnp.int32)

    parts_lo = [pl1]
    parts_hi = [ph1]
    if dpl_cols:
        parts_lo.append(jnp.stack(dpl_cols, axis=1).reshape(-1))
        parts_hi.append(jnp.stack(dph_cols, axis=1).reshape(-1))
    plo = jnp.concatenate(parts_lo)  # [cap + cap_deep*(window-1)]
    phi = jnp.concatenate(parts_hi)

    # second compaction (no dedup sort here: the verifier program
    # dedups the verified list on device)
    is_pair = plo < n
    n_pairs = jnp.sum(is_pair, dtype=jnp.int32)
    (sel3,) = jnp.nonzero(is_pair, size=cap2, fill_value=0)
    picked2 = jnp.arange(cap2, dtype=jnp.int32) < n_pairs
    pa = jnp.where(picked2, plo[sel3], -1)
    pb = jnp.where(picked2, phi[sel3], -1)
    return pa, pb, n_flagged, n_pairs, over, n_deep, n_words, n_sub


def verify_dist1(
    padded: np.ndarray, lengths: np.ndarray, a: np.ndarray, b: np.ndarray
) -> np.ndarray:
    """Host (numpy) exact dist==1 check — used by tests as the oracle
    for the device verifier and by the host fallback paths."""
    if len(a) == 0:
        return np.zeros(0, dtype=bool)
    La = lengths[a]
    Lb = lengths[b]
    width = padded.shape[1]
    idx = np.arange(width)[None, :]

    rows_a = padded[a]
    rows_b = padded[b]

    out = np.zeros(len(a), dtype=bool)

    same_len = La == Lb
    if np.any(same_len):
        within = idx < La[same_len, None]
        mism = (rows_a[same_len] != rows_b[same_len]) & within
        out[same_len] = mism.sum(axis=1) == 1

    diff1 = np.abs(La - Lb) == 1
    if np.any(diff1):
        sel = np.nonzero(diff1)[0]
        a_longer = La[sel] >= Lb[sel]
        x = np.where(a_longer[:, None], rows_a[sel], rows_b[sel])
        y = np.where(a_longer[:, None], rows_b[sel], rows_a[sel])
        ly = np.minimum(La[sel], Lb[sel])
        within = idx < ly[:, None]
        e1 = (x[:, :width] == y) | ~within
        c = np.logical_or.accumulate(~e1, axis=1)  # first mismatch onward
        e2 = (x[:, 1:] == y[:, :-1]) | ~within[:, :-1]
        out[sel] = np.all(e2 | ~c[:, :-1], axis=1)
    return out


# (cap, cap2, window) that last succeeded per (n_pad, width) — skips
# wasted undersized attempts on repeat runs within a process, and is
# persisted next to the XLA compile cache so FRESH processes start at
# the params whose program that cache already holds (an undersized
# first attempt costs a full recompile)
_LAST_GOOD_PARAMS = {}


def _params_path():
    from .neighbors_jax import compile_cache_dir

    cache = compile_cache_dir()
    if not cache:
        return None
    return os.path.join(cache, "join_params.json")


def _load_good_params():
    path = _params_path()
    if path is None:
        return
    try:
        import json

        with open(path) as fh:
            for k, v in json.load(fh).items():
                v = list(v)
                if len(v) == 3:  # pre-round-4 format: no cap_deep/cap3
                    v = v + [max(v[0] >> 3, 1 << 13), max(v[1] >> 1, 1 << 13)]
                while len(v) in (5, 6):  # pre-round-5: no capw/capf
                    v = v + [max(v[0] * 5 // 8, 1 << 13)]
                _LAST_GOOD_PARAMS.setdefault(
                    tuple(int(x) for x in k.split(",")), tuple(v)
                )
    except (OSError, ValueError):
        pass


def _save_good_params():
    path = _params_path()
    if path is None:
        return
    try:
        import json

        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(
                {",".join(map(str, k)): v for k, v in _LAST_GOOD_PARAMS.items()},
                fh,
            )
        os.replace(tmp, path)
    except OSError:
        pass


_load_good_params()


class SentinelCollision(RuntimeError):
    """A valid key equals the invalid-slot sentinel (probability
    ~M * 2^-64) — the caller must use the exact host path."""


def _row_bucket(n: int) -> int:
    """Pad row counts to coarse buckets so compiled programs are reused."""
    if n <= 4096:
        return _round_up(max(n, 256), 256)
    step = 8192
    return ((n + step - 1) // step) * step


# content-addressed device residency: CLI runs are stateless (a fresh
# engine per invocation), but the serving pattern re-clusters the same
# corpus (plain run, then -f; parameter sweeps; the resident server).
# A blake2b of the packed codes is paid instead of a host-to-device
# copy. One entry: the cache bounds device memory at a single
# resident corpus.
_DEVICE_ARRAY_CACHE = {}

# digest memo keyed by arena object identity: the serving-model DB
# cache returns the SAME numpy arrays across runs, so the ~0.2s blake2b
# at 1M amplicons is paid once per resident corpus. Holding a reference
# to the keyed array pins it, keeping id() stable.
_DIGEST_MEMO = {}


def _content_digest(db) -> str:
    key = (id(db.codes), id(db.lengths))
    hit = _DIGEST_MEMO.get(key)
    if hit is not None:
        return hit[1]
    import hashlib

    h = hashlib.blake2b(db.codes, digest_size=16)
    h.update(np.ascontiguousarray(db.lengths))
    digest = h.hexdigest()
    _DIGEST_MEMO.clear()
    _DIGEST_MEMO[key] = ((db.codes, db.lengths), digest)
    return digest


class SortJoinNeighborEngine:
    """Whole-database d=1 network via one global device sort-join."""

    def __init__(self, db):
        n = len(db)
        self.n = n
        self.db = db
        max_len = max(int(db.longest), 1)
        self.width = _round_up(max_len, 64)
        # slot-axis cap: the real length ceiling, 16-bucketed — slots
        # beyond it are tile padding and generate no valid keys
        self.lcap = min(_round_up(max_len, 16), self.width)
        self.n_pad = _row_bucket(max(n, 1))
        self.zob = jnp.asarray(make_zobrist_pair(self.width))
        self._device = None
        self._pending = None

    def _params(self):
        shape_key = (self.n_pad, self.width, self.lcap)
        cap = 1 << max(14, (self.n - 1).bit_length())
        cap2 = cap
        window = 8
        cap_deep = max(cap >> 3, 1 << 13)
        cap3 = max(cap2 >> 1, 1 << 13)
        # isolated flags: occupied words/subwords track the flag count
        capw = max(cap * 5 // 8, 1 << 13)
        capf = max(cap * 3 // 4, 1 << 13)
        cached = _LAST_GOOD_PARAMS.get(shape_key)
        if cached:
            cap, cap2, window = (
                max(cap, cached[0]), max(cap2, cached[1]),
                max(window, cached[2]),
            )
            if len(cached) >= 5:
                cap_deep = max(cap_deep, cached[3])
                cap3 = max(cap3, cached[4])
            if len(cached) >= 7:
                capw = max(capw, cached[5])
                capf = max(capf, cached[6])
        return shape_key, cap, cap2, window, cap_deep, cap3, capw, capf

    def start(self) -> None:
        """Dispatch join + verify asynchronously at the cached params.
        build_network consumes the result; a later cap retry just
        discards the speculative programs."""
        _, cap, cap2, window, cap_deep, cap3, capw, capf = self._params()
        packed, lengths = self._device_arrays()
        pa, pb, status = network_pairs(
            packed, lengths, self.zob, width=self.width,
            lcap=self.lcap, cap=cap, cap2=cap2, window=window,
            cap_deep=cap_deep, capw=capw, capf=capf,
        )
        gab, vstatus = verify_pairs_compact(
            packed, lengths, pa, pb, n=self.n_pad, cap3=cap3
        )
        self._pending = (
            (cap, cap2, window, cap_deep, cap3, capw, capf), pa, pb, gab,
            vstatus, status,
        )

    def _device_arrays(self):
        if self._device is None:
            db = self.db
            # content key over the RAW arena: on a hit (the serving
            # pattern: re-clustering the resident corpus) the pad +
            # 2-bit pack are skipped along with the H2D
            key = (self.n_pad, self.width, _content_digest(db))
            hit = _DEVICE_ARRAY_CACHE.get(key)
            if hit is None:
                from .neighbors import pad_codes

                padded = np.zeros((self.n_pad, self.width), dtype=np.uint8)
                padded[: self.n] = pad_codes(
                    db.codes, db.offsets, db.lengths, self.width
                )
                lengths = np.zeros(self.n_pad, dtype=np.int32)
                lengths[: self.n] = db.lengths
                _DEVICE_ARRAY_CACHE.clear()
                hit = (jnp.asarray(pack2bit(padded)), jnp.asarray(lengths))
                _DEVICE_ARRAY_CACHE[key] = hit
            self._device = hit
        return self._device

    def build_network(self, no_break: bool, abundances: np.ndarray):
        import os as _os
        import sys as _sys
        import time as _time

        timing = _os.environ.get("SWARM_TPU_TIMING")

        def _t(tag, t0):
            if timing:
                _sys.__stderr__.write(
                    f"[d1join] {tag} {_time.perf_counter() - t0:8.3f}s\n"
                )
            return _time.perf_counter()

        n = self.n
        if n == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)

        t0 = _time.perf_counter()
        packed, lengths = self._device_arrays()
        t0 = _t("pack+H2D", t0)

        (shape_key, cap, cap2, window, cap_deep, cap3, capw,
         capf) = self._params()
        pending = self._pending
        self._pending = None
        while True:
            params = (cap, cap2, window, cap_deep, cap3, capw, capf)
            if pending is not None and pending[0] == params:
                # consume the start() dispatch (it ran on the device
                # under the host's hashing phase)
                _, pa, pb, gab, vstatus, status = pending
                pending = None
            else:
                pa, pb, status = network_pairs(
                    packed, lengths, self.zob, width=self.width,
                    lcap=self.lcap, cap=cap, cap2=cap2, window=window,
                    cap_deep=cap_deep, capw=capw, capf=capf,
                )
                # dispatch the verifier BEFORE the status readback:
                # both programs queue on the device back-to-back, so
                # the host pays one sync instead of two; a cap retry
                # (rare — params persist across runs) just discards
                # the speculative work
                gab, vstatus = verify_pairs_compact(
                    packed, lengths, pa, pb, n=self.n_pad, cap3=cap3
                )
            stat = np.asarray(status)
            n_flagged, n_pairs, over, sentinel_hits = (
                int(x) for x in stat[:4]
            )
            n_deep = int(stat[4]) if stat.shape[0] > 4 else 0
            n_words = int(stat[5]) if stat.shape[0] > 5 else 0
            n_sub = int(stat[6]) if stat.shape[0] > 6 else 0
            if sentinel_hits > 0:
                raise SentinelCollision(
                    "a real deletion key equals the invalid-key sentinel"
                )
            if n_flagged > cap:
                cap *= 2
                cap2 = max(cap2, cap)
                continue
            if n_words > capw:
                capw *= 2
                continue
            if n_sub > capf:
                capf *= 2
                continue
            if n_deep > cap_deep:
                cap_deep *= 2
                continue
            if over > 0:
                window *= 2
                continue
            if n_pairs > cap2:
                cap2 *= 2
                continue
            # cap3 retries rerun only the (cheap) verifier program; the
            # join results stay device-resident
            while True:
                n_good = int(np.asarray(vstatus)[0])
                if n_good <= cap3:
                    break
                cap3 *= 2
                gab, vstatus = verify_pairs_compact(
                    packed, lengths, pa, pb, n=self.n_pad, cap3=cap3
                )
            params = (cap, cap2, window, cap_deep, cap3, capw, capf)
            break
        t0 = _t("join program+status", t0)
        if _LAST_GOOD_PARAMS.get(shape_key) != params:
            _LAST_GOOD_PARAMS[shape_key] = params
            _save_good_params()

        from .. import metrics

        metrics.record(d1_join_comparisons=int(n_pairs))

        # unique verified pairs, already canonically sorted on device;
        # one [2, cap3] transfer
        gab_np = np.asarray(gab)
        pa_np = gab_np[0, :n_good].astype(np.int64)
        pb_np = gab_np[1, :n_good].astype(np.int64)
        t0 = _t("verify+D2H", t0)

        # both directions, abundance rule (ab[from] >= ab[to] unless
        # no_break), sorted by (from, to)
        from .. import _native

        if _native.available():
            ef_s, et_s = _native.d1_finish_edges(
                pa_np, pb_np, abundances.astype(np.int64), no_break
            )
            _t("host dedup+sort", t0)
            return ef_s, et_s
        ef = np.concatenate([pa_np, pb_np])
        et = np.concatenate([pb_np, pa_np])
        if not no_break:
            keep = abundances[ef] >= abundances[et]
            ef, et = ef[keep], et[keep]
        order = np.lexsort((et, ef))
        _t("host dedup+sort", t0)
        return ef[order], et[order]


# ---------------------------------------------------------------------
# width-bucketed join: mixed-length corpora without the [n, max_width]
# memory cliff (one multi-kilobase read no longer inflates every row —
# deletion-key hashes are width-agnostic, so per-bucket keygen feeds
# ONE global sort and the exact check runs on the host arena)
# ---------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("widths", "lcaps", "n", "cap", "cap2", "window"),
)
def network_pairs_bucketed(
    packeds, lengthss, owners, zob, widths, lcaps, n, cap, cap2, window
):
    """Fused multi-bucket join: per-bucket keygen (each at its own
    width) -> concatenated key streams -> one global sort-join.

    packeds/lengthss/owners: tuples of per-bucket arrays; owners carry
    GLOBAL amplicon ids (-1 on pad rows). Pairs come back as global ids
    and are exactness-checked on the host arena (no full-width device
    code table exists in this mode)."""
    his, los, owns = [], [], []
    for packed, lens, owner_rows, W, lcap in zip(
        packeds, lengthss, owners, widths, lcaps
    ):
        padded = unpack2bit_device(packed, W)
        (k_hi, k_lo), valid = deletion_keys_device(
            padded[:, :lcap], lens, zob
        )
        own = jnp.where(valid, owner_rows[:, None], -1)
        his.append(k_hi.reshape(-1))
        los.append(k_lo.reshape(-1))
        owns.append(own.reshape(-1))
    return join_pairs(
        jnp.concatenate(his), jnp.concatenate(los), jnp.concatenate(owns),
        n, cap=cap, cap2=cap2, window=window,
    )


class BucketedSortJoinEngine:
    """Multi-width d=1 sort-join. Rows are binned to geometric width
    levels (64 * 4^k); device memory is sum(n_k * W_k) instead of
    n * roundup(longest) — a lone 5 kb read among 150 nt amplicons
    costs its own bytes, not a 26x blowup of the whole table."""

    LEVEL_BASE = 64
    LEVEL_STEP = 4

    @classmethod
    def widths_for(cls, lengths):
        w = cls.LEVEL_BASE
        levels = []
        maxlen = int(np.max(lengths)) if len(lengths) else 1
        while True:
            levels.append(w)
            if w >= maxlen:
                break
            w *= cls.LEVEL_STEP
        return levels

    @classmethod
    def worthwhile(cls, lengths) -> bool:
        """True when bucketing saves >40% of the single-table bytes."""
        if len(lengths) == 0:
            return False
        levels = cls.widths_for(lengths)
        if len(levels) < 2:
            return False
        full = _round_up(int(np.max(lengths)), 64) * len(lengths)
        cost = 0
        for i, w in enumerate(levels):
            lo = levels[i - 1] if i else 0
            n_k = int(np.sum((lengths > lo) & (lengths <= w)))
            cost += n_k * w
        return cost < 0.6 * full

    def __init__(self, db):
        n = len(db)
        self.n = n
        lengths = db.lengths.astype(np.int64)
        self.levels = self.widths_for(lengths)
        full_width = _round_up(max(int(db.longest), 1), 64)
        self.zob = jnp.asarray(make_zobrist_pair(full_width))
        self.db = db

        self.buckets = []  # (packed, lengths, owners, W, lcap)
        from .neighbors import pad_codes

        for i, w in enumerate(self.levels):
            lo = self.levels[i - 1] if i else 0
            sel = np.nonzero((lengths > lo) & (lengths <= w))[0]
            if len(sel) == 0:
                continue
            rows = _row_bucket(len(sel))
            padded = np.zeros((rows, w), dtype=np.uint8)
            sub_off = db.offsets[sel]
            sub_len = db.lengths[sel]
            padded[: len(sel)] = pad_codes(
                db.codes, sub_off, sub_len, w
            )
            lens = np.zeros(rows, dtype=np.int32)
            lens[: len(sel)] = sub_len
            owners = np.full(rows, -1, dtype=np.int32)
            owners[: len(sel)] = sel
            lcap = min(_round_up(int(sub_len.max()), 16), w)
            self.buckets.append(
                (jnp.asarray(pack2bit(padded)), jnp.asarray(lens),
                 jnp.asarray(owners), w, lcap)
            )

    def build_network(self, no_break: bool, abundances: np.ndarray):
        n = self.n
        if n == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        packeds = tuple(b[0] for b in self.buckets)
        lengthss = tuple(b[1] for b in self.buckets)
        owners = tuple(b[2] for b in self.buckets)
        widths = tuple(b[3] for b in self.buckets)
        lcaps = tuple(b[4] for b in self.buckets)

        cap = 1 << max(14, (n - 1).bit_length())
        cap2 = cap
        window = 8
        while True:
            pa, pb, n_flagged, n_pairs, over, _n_deep, _nw, _ns = (
                network_pairs_bucketed(
                    packeds, lengthss, owners, self.zob,
                    widths=widths, lcaps=lcaps, n=n,
                    cap=cap, cap2=cap2, window=window,
                )
            )
            if int(over) > 0:
                window *= 2
                continue
            if int(n_flagged) > cap:
                cap *= 2
                cap2 = max(cap2, cap)
                continue
            if int(n_pairs) > cap2:
                cap2 *= 2
                continue
            break

        from .. import _native, metrics

        metrics.record(d1_join_comparisons=int(n_pairs))
        pa_np = np.asarray(pa).astype(np.int64)
        pb_np = np.asarray(pb).astype(np.int64)
        if _native.available():
            good = _native.verify_dist1_pairs(
                self.db.codes, self.db.offsets, self.db.lengths, pa_np, pb_np
            )
        else:
            w_full = _round_up(max(int(self.db.longest), 1), 64)
            from .neighbors import pad_codes

            padded_full = pad_codes(
                self.db.codes, self.db.offsets, self.db.lengths, w_full
            )
            good = (pa_np >= 0) & verify_dist1(
                padded_full, self.db.lengths.astype(np.int64),
                np.maximum(pa_np, 0), np.maximum(pb_np, 0),
            )
        pa_np = pa_np[good]
        pb_np = pb_np[good]

        packed_pairs = np.unique(pa_np * np.int64(n) + pb_np)
        pa_np = packed_pairs // n
        pb_np = packed_pairs % n

        ef = np.concatenate([pa_np, pb_np])
        et = np.concatenate([pb_np, pa_np])
        if not no_break:
            keep = abundances[ef] >= abundances[et]
            ef, et = ef[keep], et[keep]
        order = np.lexsort((et, ef))
        return ef[order], et[order]
