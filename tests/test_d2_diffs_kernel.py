"""The Pallas (Triton) forward-diff kernel and the choice of diff kernel.

On the CPU the kernel runs in interpret mode against the native diffs
(the oracle test_d2_diffs_jax.py also pins the XLA scan to), at small
widths: the interpreter is slow. The real widths run compiled on the
GPU against the scan and the native diffs (marker `gpu`; chip_smoke.py
runs them).
"""

import numpy as np
import pytest

from swarm_tpu import _native, device, metrics
from swarm_tpu.ops.d2_diffs_jax import DeviceDiffEngine, d2_diffs_program
from swarm_tpu.ops.d2_diffs_kernel import MAX_BAND, TASKS, d2_diffs_kernel

from test_d2_diffs_jax import _chain_corpus, _mkdb

pytestmark = pytest.mark.skipif(
    not _native.available(), reason="native kernels unavailable"
)


def _task_arrays(eng, pa, pb):
    """Both directions of every pair as device task arrays, cut to the
    first TASKS multiple (the interpreter pays for every program)."""
    m = -(-2 * len(pa) // TASKS) * TASKS
    arrays = eng.task_arrays(np.concatenate([pa, pb]), np.concatenate([pb, pa]))
    return [a[:m] for a in arrays]


@pytest.mark.parametrize(
    "seed,d,scores",
    [
        (1, 2, (4, 12, 4)),
        (4, 2, (2, 2, 2)),   # gap-open == extend: dense b4/b8 ties
        (5, 4, (1, 1, 1)),   # everything ties
        (6, 1, (9, 3, 1)),
        (3, 3, (4, 12, 4)),  # B = 15, near MAX_BAND
    ],
)
def test_kernel_interpret_matches_native(tmp_path, seed, d, scores):
    mismatch, go, ge = scores
    db = _mkdb(tmp_path, _chain_corpus(seed, 20, 40, d + 1))
    pa, pb = (x.astype(np.int64) for x in np.triu_indices(len(db), k=1))
    eng = DeviceDiffEngine(db, d)
    B = eng.band_for_exact(d * max(mismatch, go + ge), go, ge)
    assert B <= MAX_BAND  # the kernel serves only such bands
    got = np.asarray(d2_diffs_kernel(
        *_task_arrays(eng, pa, pb), B=B, Lmax=eng.Lmax,
        mismatch=mismatch, go=go, ge=ge, d=d, interpret=True))
    want_ab, want_ba = _native.d2_diffs_pairs(
        db.codes, db.offsets, db.lengths, db.abundances, pa, pb,
        d, mismatch, go, ge, True, nthreads=1,
    )
    assert (want_ab >= 0).any()
    P = len(pa)
    np.testing.assert_array_equal(got[:P], want_ab)
    np.testing.assert_array_equal(got[P:2 * P], want_ba)
    assert (got[2 * P:] == -1).all()  # padding tasks are rejected


@pytest.mark.parametrize(
    "platform,B,want",
    [
        ("gpu", 11, True),   # d=2 at default scores
        ("gpu", MAX_BAND, True),
        ("gpu", MAX_BAND + 1, False),  # too wide for registers: scan
        ("cpu", 11, False),  # Triton does not compile for the CPU
    ],
)
def test_kernel_choice_by_shape(monkeypatch, platform, B, want):
    monkeypatch.setattr(device, "device_platform", lambda: platform)
    assert DeviceDiffEngine.use_kernel(B) is want


def test_engine_records_diff_kernel(tmp_path):
    db = _mkdb(tmp_path, _chain_corpus(2, 30, 50, 3))
    pa, pb = np.triu_indices(len(db), k=1)
    metrics.reset()
    DeviceDiffEngine(db, 2).diffs_pairs(
        pa.astype(np.int64), pb.astype(np.int64), 4, 12, 4, False)
    assert metrics.engines == {"d2_diffs": "device_scan"}


def _gpu_or_skip():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA device (run by chip_smoke.py)")


@pytest.mark.gpu
@pytest.mark.parametrize("length", [150, 400])  # Lmax 192 and 448
def test_kernel_matches_scan_and_native_on_gpu(tmp_path, length):
    _gpu_or_skip()
    import bench
    from swarm_tpu.ops.d2_network import D2NetworkEngine

    fasta = tmp_path / "in.fasta"
    bench.gen_corpus(fasta, 6000, length, seed=7)
    db = _mkdb(tmp_path, [fasta.read_text()])
    d, mismatch, go, ge = 2, 4, 12, 4
    pa, pb, _ = D2NetworkEngine(db, d).candidate_pairs()
    eng = DeviceDiffEngine(db, d)
    B = eng.band_for_exact(d * max(mismatch, go + ge), go, ge)
    args = _task_arrays(eng, pa, pb)
    kw = dict(B=B, Lmax=eng.Lmax, mismatch=mismatch, go=go, ge=ge, d=d)
    got = np.asarray(d2_diffs_kernel(*args, **kw))
    np.testing.assert_array_equal(got, np.asarray(d2_diffs_program(*args, **kw)))
    want_ab, want_ba = _native.d2_diffs_pairs(
        db.codes, db.offsets, db.lengths, db.abundances, pa, pb,
        d, mismatch, go, ge, True, nthreads=4,
    )
    P = len(pa)
    np.testing.assert_array_equal(got[:P], want_ab)
    np.testing.assert_array_equal(got[P:2 * P], want_ba)
