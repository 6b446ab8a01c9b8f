"""Pallas (Triton) forward-tracked banded diff kernel for the GPU.

Same semantics as ops/d2_diffs_jax.d2_diffs_program (the forward-diff
DP that mirrors the native backtrack bit-for-bit; see that module's
header for the tie-break contract), laid out for a GPU's threads and
registers instead of an XLA scan carry:

  * one directed task per thread, TASKS tasks per program;
  * the whole band state (4 * W int32 per task, W = 2B + 1) stays in
    registers for all Lmax rows: the row loop runs inside the kernel,
    so the scan's per-row round trip of the state through device
    memory disappears;
  * codes are stored position-major ([L, N] uint8), so each row's loads
    are coalesced across the program's tasks;
  * the query window slides by one character per row (slot k at row r
    reads q[r + k - B]), so a row loads ONE new query character plus
    one target character, both prefetched a row ahead.

Register demand grows with W, so DeviceDiffEngine routes bands wider
than MAX_BAND to the XLA scan.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

INF32 = np.int32(1 << 28)

TASKS = 128  # tasks per program: one per thread at NUM_WARPS = 4
NUM_WARPS = 4
#: widest band the kernel keeps in registers (W = 33 slots, ~170
#: live int32 per thread); wider bands run the XLA scan
MAX_BAND = 16


def _make_kernel(B, Lmax, mismatch, go, ge, d):
    W = 2 * B + 1
    Q = go + ge
    R = ge
    cutoff = d * max(mismatch, Q)
    INF = INF32  # np scalar: kernels cannot close over jnp values

    def kernel(qT_ref, tT_ref, ql_ref, dl_ref, out_ref):
        ql = ql_ref[:]  # [TASKS] int32
        dl = dl_ref[:]
        shape = (TASKS,)
        qd = ql - dl  # final cell sits at slot k with k - B == ql - dl
        ql_pos = ql > 0

        # row -1 boundary per slot k (mirrors d2_diffs_program init)
        Hb0, Eb0, Hd0, Ed0 = [], [], [], []
        for k in range(W):
            im1 = k - B - 1
            if im1 >= 0:
                ok = jnp.int32(im1) < ql
                Hb0.append(jnp.where(ok, jnp.int32(Q + im1 * R), INF))
                Eb0.append(jnp.where(ok, jnp.int32(2 * Q + im1 * R), INF))
                Hd0.append(jnp.full(shape, im1 + 1, dtype=jnp.int32))
                Ed0.append(jnp.full(shape, im1 + 2, dtype=jnp.int32))
            else:
                Hb0.append(jnp.full(shape, INF32, dtype=jnp.int32))
                Eb0.append(jnp.full(shape, INF32, dtype=jnp.int32))
                Hd0.append(jnp.zeros(shape, dtype=jnp.int32))
                Ed0.append(jnp.zeros(shape, dtype=jnp.int32))
        # qT[j] = q[j - B]: row 0's window is qT[0 .. W-1]
        win0 = [qT_ref[k, :].astype(jnp.int32) for k in range(W)]
        dchar0 = tT_ref[0, :].astype(jnp.int32)
        score0 = jnp.full(shape, INF32, dtype=jnp.int32)
        sdiff0 = jnp.zeros(shape, dtype=jnp.int32)

        # the m_inf clamp of d2_diffs_program is dropped: unclamped sums
        # stay far below int32 overflow (INF + Lmax*mismatch) and only
        # change state on cells whose cost already exceeds the cutoff,
        # so the accept/diff OUTPUT is identical (pinned by
        # tests/test_d2_diffs_kernel.py)
        def make_body(mid):
            """mid=True: rows in [B+1, Lmax-B), where every slot has
            0 < i <= Lmax-1, so the i == 0 seeding selects and the
            in_range preservation drop out."""

            def row_body(row, carry):
                state = list(carry[:4 * W])
                win = list(carry[4 * W:5 * W])
                dchar, score, sdiff = carry[5 * W:]
                Hb = state[0:W]
                Eb = state[W:2 * W]
                Hd = state[2 * W:3 * W]
                Ed = state[3 * W:4 * W]

                # next row's characters (qT and tT carry one spare row)
                q_next = qT_ref[row + W, :].astype(jnp.int32)
                d_next = tT_ref[row + 1, :].astype(jnp.int32)

                emit = (row == dl - 1) & ql_pos
                if not mid:
                    # go + row*ge, but 0 at row 0 (no select on scalar
                    # literals: Triton's lowering mistypes them)
                    bval = jnp.minimum(row, 1) * (go + row * ge)
                    bval_d = row
                    fboundary = 2 * go + (row + 2) * ge
                    fboundary_d = row + 2
                Fv = jnp.full(shape, INF32, dtype=jnp.int32)
                Fd = jnp.zeros(shape, dtype=jnp.int32)
                for k in range(W):
                    i = row + (k - B)  # query index, the same for every task
                    m_valid = i < ql if mid else (i >= 0) & (i < ql)
                    if mid:
                        diag_in = Hb[k]
                        diag_d = Hd[k]
                    else:
                        in_range = (i >= 0) & (i <= Lmax - 1)
                        at0 = i == 0
                        diag_in = jnp.where(at0, bval, Hb[k])
                        diag_d = jnp.where(at0, bval_d, Hd[k])
                        Fv = jnp.where(at0, fboundary, Fv)
                        Fd = jnp.where(at0, fboundary_d, Fd)
                    is_mm = (dchar != win[k]).astype(jnp.int32)
                    diag = diag_in + is_mm * mismatch
                    diag_d = diag_d + is_mm
                    if k + 1 < W:
                        E_in = Eb[k + 1]
                        E_in_d = Ed[k + 1]
                    else:
                        E_in = jnp.full(shape, INF32, dtype=jnp.int32)
                        E_in_d = jnp.zeros(shape, dtype=jnp.int32)
                    pre = jnp.minimum(diag, E_in)
                    Hnew = jnp.minimum(pre, Fv)
                    b1 = diag <= Fv
                    b2 = E_in <= jnp.minimum(diag, Fv)
                    hq = Hnew + Q
                    b4 = hq <= Fv + R
                    b8 = hq <= E_in + R
                    Hd_new = jnp.where(b2, E_in_d, jnp.where(b1, diag_d, Fd))
                    Enew = jnp.minimum(jnp.minimum(hq, E_in + R), INF)
                    Ed_new = jnp.where(b8, Hd_new + 1, E_in_d + 1)
                    Fnew = jnp.minimum(jnp.minimum(Fv + R, pre + Q), INF)
                    Fd_new = jnp.where(b4, Hd_new + 1, Fd + 1)
                    if mid:
                        upd = m_valid
                        Hb[k] = jnp.where(upd, Hnew, INF)
                        Eb[k] = jnp.where(upd, Enew, INF)
                    else:
                        upd = in_range & m_valid
                        Hb[k] = jnp.where(
                            in_range, jnp.where(m_valid, Hnew, INF), Hb[k])
                        Eb[k] = jnp.where(
                            in_range, jnp.where(m_valid, Enew, INF), Eb[k])
                    Hd[k] = jnp.where(upd, Hd_new, Hd[k])
                    Ed[k] = jnp.where(upd, Ed_new, Ed[k])
                    Fv = jnp.where(upd, Fnew, Fv)
                    Fd = jnp.where(upd, Fd_new, Fd)
                    # final cell: row == dl-1 and i == ql-1, i.e.
                    # qd == k - B (m_valid implied: ql = i+1 > i >= 0;
                    # ql_pos guards the ql == 0, i == -1 corner)
                    m_score = emit & (qd == (k - B))
                    score = jnp.where(m_score, Hnew, score)
                    sdiff = jnp.where(m_score, Hd_new, sdiff)
                return (tuple(Hb) + tuple(Eb) + tuple(Hd) + tuple(Ed)
                        + tuple(win[1:]) + (q_next, d_next, score, sdiff))

            return row_body

        carry = (tuple(Hb0) + tuple(Eb0) + tuple(Hd0) + tuple(Ed0)
                 + tuple(win0) + (dchar0, score0, sdiff0))
        r1 = min(B + 1, Lmax)
        r2 = max(Lmax - B, r1)
        carry = jax.lax.fori_loop(0, r1, make_body(False), carry)
        carry = jax.lax.fori_loop(r1, r2, make_body(True), carry)
        carry = jax.lax.fori_loop(r2, Lmax, make_body(False), carry)
        score, sdiff = carry[-2], carry[-1]

        active = (ql > 0) & (dl > 0) & (jnp.abs(ql - dl) <= B)
        ok = active & (score <= cutoff) & (sdiff <= d)
        out_ref[:] = jnp.where(ok, sdiff, jnp.full(shape, -1, jnp.int32))

    return kernel


@partial(
    jax.jit,
    static_argnames=("B", "Lmax", "mismatch", "go", "ge", "d", "interpret"),
)
def d2_diffs_kernel(tq, td, qlens, dlens, B, Lmax, mismatch, go, ge, d,
                    interpret=False):
    """diffs[N] for directed tasks: drop-in for d2_diffs_program.

    tq/td: [N, Lmax] uint8 code rows; qlens/dlens: [N] int32; N must be
    a TASKS multiple. Returns int32 diffs, -1 = rejected.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    N = tq.shape[0]
    assert N % TASKS == 0, f"pad the task count to a {TASKS} multiple"
    W = 2 * B + 1
    # position-major [L, N]; q front-padded with B zero rows so that
    # qT[row + k] is slot k's character, and both arrays carry one
    # spare row for the kernel's next-row prefetch
    qT = jnp.pad(tq, ((0, 0), (B, B + 1))).T  # [Lmax + W, N]
    tT = jnp.pad(td, ((0, 0), (0, 1))).T  # [Lmax + 1, N]
    kernel = _make_kernel(int(B), int(Lmax), int(mismatch), int(go),
                          int(ge), int(d))
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((N,), jnp.int32),
        grid=(N // TASKS,),
        in_specs=[
            pl.BlockSpec((Lmax + W, TASKS), lambda p: (0, p)),
            pl.BlockSpec((Lmax + 1, TASKS), lambda p: (0, p)),
            pl.BlockSpec((TASKS,), lambda p: (p,)),
            pl.BlockSpec((TASKS,), lambda p: (p,)),
        ],
        out_specs=pl.BlockSpec((TASKS,), lambda p: (p,)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="d2_diffs_kernel",
    )(qT, tT, qlens.astype(jnp.int32), dlens.astype(jnp.int32))
