"""Device exact-diff kernel for d>=2 candidate pairs (pure-pair mode).

The network engine's survivor pairs need the exact difference count of
the cost-optimal alignment under the reference's pure-pair 8-bit
semantics (swarm_native.c: d2_pair_diff_one / d2_pair_diff_batch16,
mirroring src/search8.cc + src/utils/backtrack.h:51-138 in ideal
mode). The native 16-lane kernel derives diffs by backtracking a
direction-bit tile; on a device a backtrack is a serial gather chain,
so this kernel instead tracks the diff FORWARD through the same
banded (H, E, F) recurrence: alongside each cost it carries the
difference count of the path the backtrack WOULD choose, updated with
the identical tie-break comparisons the native kernel encodes in its
direction bits:

  bit1 = diag <= F            H-node source: E if bit2, else F if
  bit2 = E <= min(diag, F)      NOT bit1, else diag (mism adds 1)
  bit4 = H + Q <= F + R       F provenance into the next column:
                                open from H (diff = Hd+1) iff bit4,
                                else extend (diff = Fd+1)
  bit8 = H + Q <= E + R       E provenance into the next row, same way

Because each selection reads the same comparisons in the same
priority order, the forward-tracked diff equals the backtracked diff
cell for cell (regression-pinned against the native kernel by
tests/test_d2_diffs_jax.py over randomized tie-heavy corpora).

Tasks (directed pairs) ride the array axis [N]; the band (width
2B+1, 23 at d=2 with default scores) is unrolled; rows are a
lax.scan. Every sequence access is a column slice — q's character at
band slot k of row r is index r+k-B for EVERY task, so there are no
per-task gathers inside the scan. On the GPU, bands up to
d2_diffs_kernel.MAX_BAND run the same DP as a Pallas (Triton) kernel
that keeps the band state in registers (ops/d2_diffs_kernel.py).
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .neighbors_jax import _round_up  # noqa: F401  (configures jax cache)

INF32 = np.int32(1 << 28)


@partial(jax.jit, static_argnames=("B", "Lmax", "mismatch", "go", "ge", "d"))
def d2_diffs_program(tq, td, qlens, dlens, B, Lmax, mismatch, go, ge, d):
    """diffs[N] for directed tasks (query row tq[i], target row td[i]).

    tq/td: [N, Lmax] uint8 code rows (0..3, padding arbitrary);
    qlens/dlens: [N] int32. Returns int32 diffs, -1 = rejected
    (cost > cutoff = d*max(mismatch, go+ge), or diff > d, or
    |qlen-dlen| > B, or empty lane).
    """
    W = 2 * B + 1
    Q = go + ge
    R = ge
    cutoff = d * max(mismatch, Q)
    INF = jnp.int32(INF32)
    N = tq.shape[0]

    ql = qlens.astype(jnp.int32)
    dl = dlens.astype(jnp.int32)
    active = (ql > 0) & (dl > 0) & (jnp.abs(ql - dl) <= B)

    # row -1 boundary per slot k: im1 = k - B - 1 leading columns
    Hb, Eb, Hd, Ed = [], [], [], []
    for k in range(W):
        im1 = k - B - 1
        if im1 >= 0:
            ok = jnp.int32(im1) < ql
            Hb.append(jnp.where(ok, jnp.int32(Q + im1 * R), INF))
            Eb.append(jnp.where(ok, jnp.int32(2 * Q + im1 * R), INF))
            Hd.append(jnp.full((N,), im1 + 1, dtype=jnp.int32))
            Ed.append(jnp.full((N,), im1 + 2, dtype=jnp.int32))
        else:
            Hb.append(jnp.full((N,), INF32, dtype=jnp.int32))
            Eb.append(jnp.full((N,), INF32, dtype=jnp.int32))
            Hd.append(jnp.zeros((N,), dtype=jnp.int32))
            Ed.append(jnp.zeros((N,), dtype=jnp.int32))

    score0 = jnp.full((N,), INF32, dtype=jnp.int32)
    sdiff0 = jnp.zeros((N,), dtype=jnp.int32)

    def body(carry, row):
        Hb, Eb, Hd, Ed, score, sdiff = carry
        Hb, Eb, Hd, Ed = list(Hb), list(Eb), list(Hd), list(Ed)
        dchar = jax.lax.dynamic_slice(td, (0, row), (N, 1))[:, 0]
        m_lastrow = row == dl - 1
        bval = jnp.where(row == 0, 0, go + row * ge).astype(jnp.int32)
        bval_d = row
        fboundary = (2 * go + (row + 2) * ge).astype(jnp.int32)
        fboundary_d = row + 2
        Fv = jnp.full((N,), INF32, dtype=jnp.int32)
        Fd = jnp.zeros((N,), dtype=jnp.int32)
        for k in range(W):
            i = row + (k - B)  # lane-independent query index
            # slots whose query index is outside [0, Lmax) were never
            # visited by the native loop this row: preserve state
            in_range = (i >= 0) & (i <= Lmax - 1)
            iclip = jnp.clip(i, 0, Lmax - 1)
            qchar = jax.lax.dynamic_slice(tq, (0, iclip), (N, 1))[:, 0]
            m_valid = (i >= 0) & (i < ql)
            at0 = i == 0
            diag_in = jnp.where(at0, bval, Hb[k])
            diag_d = jnp.where(at0, bval_d, Hd[k])
            Fv = jnp.where(at0, fboundary, Fv)
            Fd = jnp.where(at0, fboundary_d, Fd)
            m_inf = diag_in >= INF
            add = jnp.where(dchar == qchar, 0, mismatch).astype(jnp.int32)
            diag = jnp.where(m_inf, INF, diag_in + add)
            diag_d = diag_d + jnp.where(dchar == qchar, 0, 1)
            E_in = Eb[k + 1] if k + 1 < W else jnp.full(
                (N,), INF32, dtype=jnp.int32)
            E_in_d = Ed[k + 1] if k + 1 < W else jnp.zeros(
                (N,), dtype=jnp.int32)
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
            Hb[k] = jnp.where(in_range,
                              jnp.where(m_valid, Hnew, INF), Hb[k])
            Hd[k] = jnp.where(in_range & m_valid, Hd_new, Hd[k])
            Eb[k] = jnp.where(in_range,
                              jnp.where(m_valid, Enew, INF), Eb[k])
            Ed[k] = jnp.where(in_range & m_valid, Ed_new, Ed[k])
            Fv = jnp.where(in_range & m_valid, Fnew, Fv)
            Fd = jnp.where(in_range & m_valid, Fd_new, Fd)
            m_score = m_lastrow & (i == ql - 1) & m_valid
            score = jnp.where(m_score, Hnew, score)
            sdiff = jnp.where(m_score, Hd_new, sdiff)
        return (tuple(Hb), tuple(Eb), tuple(Hd), tuple(Ed),
                score, sdiff), None

    carry = (tuple(Hb), tuple(Eb), tuple(Hd), tuple(Ed), score0, sdiff0)
    (Hb, Eb, Hd, Ed, score, sdiff), _ = jax.lax.scan(
        body, carry, jnp.arange(Lmax, dtype=jnp.int32))

    ok = active & (score <= cutoff) & (sdiff <= d)
    return jnp.where(ok, sdiff, -1)


class DeviceDiffEngine:
    """Batches directed diff tasks through d2_diffs_program.

    Construction uploads the padded code rows once; diffs_pairs()
    mirrors the contract of _native.d2_diffs_pairs (diff_ab/diff_ba
    with -1 for skipped directions and rejections).
    """

    def __init__(self, db, d: int):
        from .neighbors import pad_codes
        from .. import _native  # noqa: F401  (band formula parity)

        self.d = int(d)
        self.n = len(db)
        # round the row width up to a 64 multiple: one compiled program
        # serves every corpus in the same length bucket
        self.Lmax = -(-max(int(db.longest), 1) // 64) * 64
        rows = pad_codes(db.codes, db.offsets, db.lengths, self.Lmax)
        self.rows_dev = jnp.asarray(rows)
        self.len_dev = jnp.asarray(
            np.ascontiguousarray(db.lengths, dtype=np.int32))
        self.abundances = np.asarray(db.abundances, dtype=np.int64)

    @staticmethod
    def band_for_exact(cutoff: int, go: int, ge: int) -> int:
        # mirror swarm_native.c:band_for_exact
        need = cutoff + go + 2 * ge + 1 - go
        B = -(-need // ge)
        return max(B, 1)

    @staticmethod
    def use_kernel(B: int) -> bool:
        """The register-resident kernel on the GPU, for bands it can
        hold (B <= MAX_BAND); the XLA scan otherwise, and on the CPU,
        where Triton does not compile."""
        from ..device import device_platform
        from .d2_diffs_kernel import MAX_BAND

        return device_platform() == "gpu" and B <= MAX_BAND

    def task_arrays(self, tq, td):
        """Device arrays (rows_q, rows_d, qlen, dlen) for the directed
        tasks (query tq[i], target td[i]), padded to a power of two
        (at least 1024) so compile shapes come in buckets; padding
        tasks have qlen 0 and come out rejected."""
        npad = max(1024, 1 << (len(tq) - 1).bit_length())
        qi = np.zeros(npad, dtype=np.int64)
        di = np.zeros(npad, dtype=np.int64)
        qi[: len(tq)] = tq
        di[: len(td)] = td
        qi = jnp.asarray(qi)
        di = jnp.asarray(di)
        qlen = jnp.take(self.len_dev, qi)
        return (
            jnp.take(self.rows_dev, qi, axis=0),
            jnp.take(self.rows_dev, di, axis=0),
            jnp.where(jnp.arange(npad) < len(tq), qlen, 0),
            jnp.take(self.len_dev, di),
        )

    def diffs_pairs(self, pa, pb, mismatch, go, ge, no_break):
        """(diff_ab, diff_ba) int64 arrays, -1 = skipped/rejected."""
        P = len(pa)
        cutoff = self.d * max(mismatch, go + ge)
        B = self.band_for_exact(cutoff, go, ge)
        ab = self.abundances
        need_ab = np.full(P, True) if no_break else ab[pa] >= ab[pb]
        need_ba = np.full(P, True) if no_break else ab[pb] >= ab[pa]
        tq = np.concatenate([pa[need_ab], pb[need_ba]])
        td = np.concatenate([pb[need_ab], pa[need_ba]])
        n_ab = int(need_ab.sum())
        out = np.empty(len(tq), dtype=np.int64)
        use_kernel = self.use_kernel(B)
        from .. import metrics

        metrics.engine(d2_diffs="device_kernel" if use_kernel
                       else "device_scan")
        # task-count buckets bound compile shapes; 1M tasks of scan
        # state stay under ~600 MB of device memory at d=2 widths
        CHUNK = 1 << 20
        if use_kernel:
            from .d2_diffs_kernel import d2_diffs_kernel as program
        else:
            program = d2_diffs_program
        for c0 in range(0, len(tq), CHUNK):
            part_q = tq[c0:c0 + CHUNK]
            diffs = program(
                *self.task_arrays(part_q, td[c0:c0 + CHUNK]),
                B=B, Lmax=self.Lmax, mismatch=int(mismatch),
                go=int(go), ge=int(ge), d=self.d,
            )
            out[c0:c0 + CHUNK] = np.asarray(
                diffs[: len(part_q)]).astype(np.int64)
        diff_ab = np.full(P, -1, dtype=np.int64)
        diff_ba = np.full(P, -1, dtype=np.int64)
        diff_ab[need_ab] = out[:n_ab]
        diff_ba[need_ba] = out[n_ab:]
        return diff_ab, diff_ba
