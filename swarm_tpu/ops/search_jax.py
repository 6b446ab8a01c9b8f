"""Device batched cost-space alignment screening for the d>=2 engine.

The reference's hot kernel is a striped SIMD Needleman-Wunsch in cost
space whose backtracked difference count decides membership
(src/search8.cc, src/search16.cc). The device formulation splits the
work:

  1. THIS module: a batched score-only forward pass on the device —
     one query row per lax.scan step, the gap-F recurrence solved with
     the same min-plus prefix-scan trick as ops/search.py (exact for
     Q >= R >= 0). No direction bits, no backtrack: output is [B] i32
     scores, so program outputs stay tiny.
  2. Host: pairs with score > d * max(mismatch, gapopen + gapextend)
     cannot have <= d differences (every difference costs at most that
     much), so they are rejected outright; the few survivors are
     re-run through the exact host kernel (ops/search.py + the native
     backtrack), which reproduces the reference's tie-broken diff
     counts bit-for-bit.

The screen is sound: diff(pair) <= d  ==>  score(pair) <= cutoff, so no
accepted pair is ever lost; everything the screen passes is re-checked
exactly.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

BIG = np.int32(2**30)


@partial(jax.jit, static_argnames=())
def nw_scores_device(
    padded: jnp.ndarray,  # [n, W] uint8 codes (device-resident)
    lengths: jnp.ndarray,  # [n] int32
    seed_id: jnp.ndarray,  # scalar int32
    target_ids: jnp.ndarray,  # [B] int32, -1 padding
    mismatch: jnp.ndarray,  # scalar int32 penalties
    gapopen: jnp.ndarray,
    gapextend: jnp.ndarray,
):
    """Exact global-alignment cost of seed vs each target ([B] int32).

    Identical cost model to ops/search.py:search_diffs (which mirrors
    src/search8.cc onestep_8): gap open Q = go + ge, extend R = ge,
    boundaries H[-1][i] = Q + iR, E init 2Q + iR, F row boundary
    2go + (row+2)ge. Padding targets report BIG.
    """
    n, W = padded.shape
    B = target_ids.shape[0]
    go = gapopen.astype(jnp.int32)
    ge = gapextend.astype(jnp.int32)
    Q = go + ge
    R = ge
    mm = mismatch.astype(jnp.int32)

    qseq = padded[seed_id]  # [W]
    qlen = lengths[seed_id]
    tid = jnp.maximum(target_ids, 0)
    rows = padded[tid]  # [B, W]
    dlens = jnp.where(target_ids >= 0, lengths[tid], 0)

    cols = jnp.arange(W, dtype=jnp.int32)
    H0 = jnp.broadcast_to(Q + cols * R, (B, W)).astype(jnp.int32)
    E0 = jnp.broadcast_to(2 * Q + cols * R, (B, W)).astype(jnp.int32)
    scores0 = jnp.full((B,), BIG, dtype=jnp.int32)

    rows_T = rows.T  # [W, B]: scan consumes one target row per step

    def step(carry, xs):
        H, E, scores = carry
        row, d_codes = xs
        V = jnp.where(d_codes[:, None] == qseq[None, :], 0, mm)
        diag_boundary = jnp.where(row == 0, 0, go + row * ge)
        diag = jnp.concatenate(
            [jnp.full((B, 1), diag_boundary, jnp.int32), H[:, :-1]], axis=1
        ) + V
        pre = jnp.minimum(diag, E)
        # F recurrence via min-plus prefix scan (exact for Q >= R >= 0)
        A = pre + Q - (cols + 1) * R
        running = jax.lax.associative_scan(jnp.minimum, A, axis=1)
        f_boundary = 2 * go + (row + 2) * ge
        F = jnp.concatenate(
            [
                jnp.full((B, 1), f_boundary, jnp.int32),
                jnp.minimum(
                    f_boundary + cols[1:] * R, running[:, :-1] + cols[1:] * R
                ),
            ],
            axis=1,
        )
        Hnew = jnp.minimum(pre, F)
        Enew = jnp.minimum(Hnew + Q, E + R)
        ended = dlens == row + 1
        final_col = jnp.take_along_axis(
            Hnew, jnp.full((B, 1), qlen - 1, jnp.int32), axis=1
        )[:, 0]
        scores = jnp.where(ended, final_col, scores)
        return (Hnew, Enew, scores), None

    (_, _, scores), _ = jax.lax.scan(
        step, (H0, E0, scores0), (jnp.arange(W, dtype=jnp.int32), rows_T)
    )
    return scores


class DeviceAligner:
    """Holds device-resident codes and dispatches batched screens."""

    #: below this batch size the dispatch latency exceeds the host cost
    #: (not yet measured on the GPU)
    MIN_DEVICE_BATCH = 2048

    def __init__(self, padded_np: np.ndarray, lengths_np: np.ndarray):
        self.padded = jnp.asarray(padded_np)
        self.lengths = jnp.asarray(lengths_np.astype(np.int32))
        self.n = padded_np.shape[0]

    def scores(self, seed_id: int, target_ids: np.ndarray,
               mismatch: int, gapopen: int, gapextend: int) -> np.ndarray:
        B = len(target_ids)
        b_pad = 1 << max(11, (B - 1).bit_length())
        ids = np.full(b_pad, -1, dtype=np.int32)
        ids[:B] = target_ids
        out = nw_scores_device(
            self.padded, self.lengths,
            jnp.int32(seed_id), jnp.asarray(ids),
            jnp.int32(mismatch), jnp.int32(gapopen), jnp.int32(gapextend),
        )
        return np.asarray(out)[:B]
