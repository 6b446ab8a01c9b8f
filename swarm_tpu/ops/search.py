"""Cost-space global alignment with the search-kernel's exact semantics.

The reference's hot kernel (src/search8.cc / search16.cc) is a striped
SIMD Needleman-Wunsch in cost space whose per-cell direction bits and
backtrack tie-breaking (src/utils/backtrack.h) determine the *number of
differences* used for all d>=2 clustering decisions. This module
reproduces those bits exactly with wide-integer arithmetic, batched
over target sequences (one query vs many targets — the same batching
axis the reference maps onto SIMD channels, here an array axis).

Saturation semantics: the SIMD kernels saturate at 255 (8-bit mode) or
65535 (16-bit mode) and reject saturated scores with diff=max. Because
saturating arithmetic preserves min(true, MAX) for every cell (costs
are non-negative), computing the DP unsaturated and rejecting scores
>= MAX yields identical results (proof in repo docs/PARITY.md).

Direction-bit semantics per cell (column i = query pos, row j = target
pos), derived from onestep_8 (src/search8.cc:451-474):
  bit_up      set iff  Hdiag + V <= F_in
  bit_left    set iff  E_in <= min(Hdiag + V, F_in)
  bit_extup   set iff  Hnew + Q <= F_in + R
  bit_extleft set iff  Hnew + Q <= E_in + R
with Q = gapopen + gapextend, R = gapextend; F runs along the row
(consumes query), E is carried down columns (consumes target).
"""

from typing import Tuple

import numpy as np

BIT_UP = 1
BIT_LEFT = 2
BIT_EXTUP = 4
BIT_EXTLEFT = 8


def search_diffs(
    qseq: np.ndarray,
    target_rows: np.ndarray,
    target_lens: np.ndarray,
    mismatch: int,
    gapopen: int,
    gapextend: int,
    bit_mode: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Align one query against a batch of targets.

    target_rows: [B, max_dlen] uint8 code matrix; target_lens: [B].
    Returns (scores, diffs, alignment_lengths), with diff = saturation
    max when score saturates (reference: src/search8.cc:792-805).
    """
    from .. import _native

    B, max_dlen = target_rows.shape
    qlen = len(qseq)
    if _native.available() and B > 0 and qlen > 0:
        sat = 255 if bit_mode == 8 else 65535
        return _native.nw_diffs_batch(
            qseq, target_rows, target_lens, mismatch, gapopen, gapextend, sat
        )
    Q = np.int64(gapopen + gapextend)
    R = np.int64(gapextend)
    go = np.int64(gapopen)
    ge = np.int64(gapextend)
    sat_max = np.int64(255 if bit_mode == 8 else 65535)

    cols = np.arange(qlen, dtype=np.int64)

    # boundaries (derived from channel init in search8: H0=0,
    # F0=2(go+ge), masked-restart reconstruction H_top=Q+i*R, E=2Q+i*R)
    H = Q + cols * R  # H[-1 row][i] = go+ge + i*ge
    E = 2 * Q + cols * R
    H = np.broadcast_to(H, (B, qlen)).copy()
    E = np.broadcast_to(E, (B, qlen)).copy()

    dirs = np.zeros((B, max_dlen, qlen), dtype=np.uint8)
    scores = np.zeros(B, dtype=np.int64)

    mismatch_cost = np.int64(mismatch)

    for row in range(max_dlen):
        d_codes = target_rows[:, row]  # [B]
        V = np.where(d_codes[:, None] == qseq[None, :], np.int64(0), mismatch_cost)

        diag_boundary = np.int64(0) if row == 0 else go + row * ge
        diag_in = np.empty((B, qlen), dtype=np.int64)
        diag_in[:, 0] = diag_boundary
        diag_in[:, 1:] = H[:, :-1]
        diag = diag_in + V

        E_in = E

        # F recurrence along the row via min-plus prefix scan:
        # F_in[0] = 2go + (row+2)*ge;  F_out[i] = min(Hnew[i]+Q, F_in[i]+R)
        # Hnew[i] = min(diag[i], F_in[i], E_in[i]).
        # Using pre = min(diag, E) in the scan is exact for Q >= R >= 0.
        pre = np.minimum(diag, E_in)
        f_boundary = 2 * go + (row + 2) * ge
        # F_in[i] = min(f_boundary + i*R, min_{k<i}(Hnew[k] + Q + (i-1-k)*R));
        # substituting pre[k] for Hnew[k] is exact because Q >= R >= 0.
        A = pre + Q - (cols + 1) * R
        running = np.minimum.accumulate(A, axis=1)
        F_in = np.empty((B, qlen), dtype=np.int64)
        F_in[:, 0] = f_boundary
        if qlen > 1:
            F_in[:, 1:] = np.minimum(
                f_boundary + cols[1:] * R, running[:, :-1] + cols[1:] * R
            )

        Hnew = np.minimum(pre, F_in)

        row_dirs = np.where(diag <= F_in, BIT_UP, 0)
        row_dirs |= np.where(E_in <= np.minimum(diag, F_in), BIT_LEFT, 0)
        hq = Hnew + Q
        row_dirs |= np.where(hq <= F_in + R, BIT_EXTUP, 0)
        row_dirs |= np.where(hq <= E_in + R, BIT_EXTLEFT, 0)
        dirs[:, row, :] = row_dirs.astype(np.uint8)

        E = np.minimum(hq, E_in + R)
        H = Hnew

        ended = target_lens == row + 1
        if np.any(ended):
            scores[ended] = H[ended, qlen - 1]

    from .. import _native

    if _native.available() and B > 0:
        diffs, alignlengths = _native.nw_backtrack_batch(
            qseq, target_rows, target_lens, dirs
        )
        saturated = scores >= sat_max
        diffs[saturated] = sat_max
        alignlengths[saturated] = 0
        return scores, diffs, alignlengths

    diffs = np.empty(B, dtype=np.int64)
    alignlengths = np.zeros(B, dtype=np.int64)
    for b in range(B):
        if scores[b] >= sat_max:
            diffs[b] = sat_max
            continue
        diffs[b], alignlengths[b] = _backtrack(
            qseq, target_rows[b], int(target_lens[b]), dirs[b]
        )
    return scores, diffs, alignlengths


def _backtrack(qseq, dcodes, dlen, dirs) -> Tuple[int, int]:
    """Count differences along the kernel's tie-broken optimal path
    (reference: src/utils/backtrack.h:51-138)."""
    qlen = len(qseq)
    column = qlen - 1
    row = dlen - 1
    aligned = 0
    matches = 0
    UNKNOWN, INSERTION, DELETION, MATCH = 0, 1, 2, 3
    op = UNKNOWN
    while column >= 0 and row >= 0:
        aligned += 1
        cell = dirs[row, column]
        if op == INSERTION and not (cell & BIT_EXTLEFT):
            row -= 1
        elif op == DELETION and not (cell & BIT_EXTUP):
            column -= 1
        elif cell & BIT_LEFT:
            row -= 1
            op = INSERTION
        elif not (cell & BIT_UP):
            column -= 1
            op = DELETION
        else:
            if qseq[column] == dcodes[row]:
                matches += 1
            column -= 1
            row -= 1
            op = MATCH
    aligned += column + 1 + row + 1
    return aligned - matches, aligned


def set_bit_mode(d: int, penalty_mismatch: int, penalty_gapopen: int,
                 penalty_gapextend: int) -> int:
    """8-bit unless d or penalties overflow uint8 (src/algo.cc:96-120)."""
    diff_saturation = min(
        255 // penalty_mismatch, 255 // (penalty_gapopen + penalty_gapextend)
    )
    return 16 if d > diff_saturation else 8


# ---------------------------------------------------------------------
# reference-binary-faithful kernel (boundary artifact included)
# ---------------------------------------------------------------------

def ref_block_schedule(lens, bit_mode: int, Q: int, R: int, SAT: int):
    """Simulate the channel scheduler of the reference's search8/16 main
    loop (16 channels at 8-bit, 8 at 16-bit; the easy/non-easy refill
    protocol of src/search16.cc:455-660) over the full ordered target
    list of one search_do call.

    Returns (start_iter[B], junk[(iters+1), 2]) where junk[i] is the
    (F0, H0) left-boundary register pair a block running at global
    iteration i observes. The compiled reference keeps these in
    registers that never see the per-channel re-initialization stores
    (see _native/swarm_native.c: nw_diffs_refsched), so they accumulate
    4R per iteration from 0, saturating at SAT — and every block of a
    target after its first uses them instead of the intended 2Q/0.
    """
    channels = 16 if bit_mode == 8 else 8
    B = len(lens)
    start_iter = [0] * B
    junk = [(0, 0)]
    ch_target = [-1] * channels
    ch_remaining = [0] * channels
    easy = False
    nxt = 0
    done_ct = 0
    it = 0
    F0 = 0
    while done_ct < B:
        any_finish = False
        if not easy:
            for c in range(channels):
                if ch_target[c] >= 0 and ch_remaining[c] > 0:
                    ch_remaining[c] -= min(4, ch_remaining[c])
                    if ch_remaining[c] == 0:
                        any_finish = True
                else:
                    if ch_target[c] >= 0:
                        done_ct += 1
                        ch_target[c] = -1
                    if nxt < B:
                        ch_target[c] = nxt
                        start_iter[nxt] = it
                        ch_remaining[c] = int(lens[nxt])
                        nxt += 1
                        ch_remaining[c] -= min(4, ch_remaining[c])
                        if ch_remaining[c] == 0:
                            any_finish = True
            easy = not any_finish
            if done_ct == B:
                break
        else:
            for c in range(channels):
                if ch_target[c] >= 0 and ch_remaining[c] > 0:
                    ch_remaining[c] -= min(4, ch_remaining[c])
                    if ch_remaining[c] == 0:
                        any_finish = True
            easy = not any_finish
        t3 = min(F0 + 3 * R, SAT)
        H0 = max(t3 - Q, 0)
        F0 = min(t3 + R, SAT)
        it += 1
        junk.append((F0, H0))
    return start_iter, junk


def search_diffs_ref(
    qseq: np.ndarray,
    target_rows: np.ndarray,
    target_lens: np.ndarray,
    mismatch: int,
    gapopen: int,
    gapextend: int,
    bit_mode: int,
    compute: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Align one query against the FULL ordered target list of one
    search_do call, replicating the reference BINARY — including the
    left-boundary artifact its release build compiles into search8/16
    (documented at _native/swarm_native.c: nw_diffs_refsched; verified
    against an instrumented reference build).

    Because each target's per-block boundaries depend on the global
    block index at which the channel scheduler ran them, the list must
    be exactly the reference's master_targets (the qgram survivors, in
    pool order). `compute` may mark targets whose DP can be skipped
    (pruned by a conservative bound); they still shape the schedule.
    Skipped targets report diff = saturation max.
    """
    from .. import _native

    B, max_dlen = target_rows.shape
    qlen = len(qseq)
    if B == 0 or qlen == 0:
        z = np.zeros(B, dtype=np.int64)
        return z, z.copy(), z.copy()

    if bit_mode == 8:
        # search8.cc compiles CORRECTLY in the release build: its vector
        # accumulators stay in sync with the per-channel lane stores
        # (verified with an instrumented build), so 8-bit mode has the
        # intended per-target boundaries and no schedule dependence —
        # the ideal kernel applies, and screened-out targets can simply
        # be dropped from the batch.
        if compute is None:
            return search_diffs(
                qseq, target_rows, target_lens,
                mismatch, gapopen, gapextend, bit_mode,
            )
        scores = np.full(B, -1, dtype=np.int64)
        diffs = np.full(B, 255, dtype=np.int64)
        alens = np.zeros(B, dtype=np.int64)
        surv = np.nonzero(compute)[0]
        if len(surv):
            s, dd, al = search_diffs(
                qseq, target_rows[surv], target_lens[surv],
                mismatch, gapopen, gapextend, bit_mode,
            )
            scores[surv] = s
            diffs[surv] = dd
            alens[surv] = al
        return scores, diffs, alens

    if _native.available():
        return _native.nw_diffs_refsched(
            qseq, target_rows, target_lens, compute,
            mismatch, gapopen, gapextend, bit_mode,
        )

    SAT = 255 if bit_mode == 8 else 65535
    Q = (gapopen + gapextend) & SAT
    R = gapextend & SAT
    V_MM = mismatch & SAT
    F0_FIRST = (2 * (gapopen + gapextend)) & SAT
    start_iter, junk = ref_block_schedule(target_lens, bit_mode, Q, R, SAT)

    scores = np.zeros(B, dtype=np.int64)
    diffs = np.zeros(B, dtype=np.int64)
    alens = np.zeros(B, dtype=np.int64)
    for b in range(B):
        if compute is not None and not compute[b]:
            scores[b] = -1
            diffs[b] = SAT
            alens[b] = 0
            continue
        dlen = int(target_lens[b])
        dseq = target_rows[b]
        # masked first-block restore
        MQ = Q
        Hb = [0] * qlen
        Eb = [0] * qlen
        for i in range(qlen):
            Hb[i] = MQ
            Eb[i] = min(min(MQ, SAT) + Q, SAT)
            MQ = min(MQ + R, SAT)
        dirs = np.zeros((dlen, qlen), dtype=np.uint8)
        score = 0
        f0_k = hchain = 0
        for row in range(dlen):
            k, j = row >> 2, row & 3
            if j == 0:
                f0_k, hchain = (F0_FIRST, 0) if k == 0 else junk[start_iter[b] + k]
            elif j == 1:
                hchain = max(f0_k - Q, 0)
            else:
                hchain = min(hchain + R, SAT)
            F = f0_k
            for _ in range(j):
                F = min(F + R, SAT)
            diag_in = hchain
            dch = dseq[row]
            for i in range(qlen):
                H = min(diag_in + (0 if dch == qseq[i] else V_MM), SAT)
                W = H
                if F < H:
                    H = F
                bits = 1 if W == H else 0
                E_in = Eb[i]
                if E_in < H:
                    H = E_in
                if H == E_in:
                    bits |= 2
                N = H
                H = min(H + Q, SAT)
                F = min(F + R, SAT)
                E = min(E_in + R, SAT)
                if H < F:
                    F = H
                if H == F:
                    bits |= 4
                if H < E:
                    E = H
                if H == E:
                    bits |= 8
                dirs[row, i] = bits
                diag_in = Hb[i]
                Hb[i] = N
                Eb[i] = E
            if row + 1 == dlen:
                score = Hb[qlen - 1]
        scores[b] = score
        if score >= SAT:
            diffs[b] = SAT
            alens[b] = 0
            continue
        col, row = qlen - 1, dlen - 1
        aligned = matches = 0
        op = 0
        while col >= 0 and row >= 0:
            aligned += 1
            cell = dirs[row, col]
            if op == 1 and not cell & 8:
                row -= 1
            elif op == 2 and not cell & 4:
                col -= 1
            elif cell & 2:
                row -= 1
                op = 1
            elif not cell & 1:
                col -= 1
                op = 2
            else:
                if qseq[col] == dseq[row]:
                    matches += 1
                col -= 1
                row -= 1
                op = 3
        aligned += col + 1 + row + 1
        diffs[b] = aligned - matches
        alens[b] = aligned
    return scores, diffs, alens
