"""Long-sequence support: the reference accepts sequences up to
67,108,861 nt (src/db.cc:439-442). The d>=2 engine stores codes in an
offset-based arena, so one multi-Mnt sequence costs only its own bytes
instead of inflating an [n, longest] matrix. Byte parity vs the
reference on mixed corpora with a multi-Mnt member.
"""

import numpy as np
import pytest

from genfasta import amplicon_cloud


def _mixed_corpus(seed, giant_len):
    rng = np.random.default_rng(seed)
    base = amplicon_cloud(seed=seed, n_centers=4, cloud_size=12,
                         length=60, max_edits=3, max_abundance=30)
    giant = "".join(np.array(list("ACGT"))[rng.integers(0, 4, giant_len)])
    # mid-abundance so it lands mid-pool
    return base + f">giant_15\n{giant}\n"


@pytest.mark.parametrize("d", [2, 3])
def test_d2_with_long_sequence_parity(both, d):
    # ~15 knt is near the practical ceiling of the reference at d>=2
    # (its direction buffer is O(longest^2) and aborts in the hundreds
    # of knt); parity holds where it can run at all
    fasta = _mixed_corpus(900 + d, giant_len=15_000)
    both.compare(
        ["-d", str(d), "-o", "out.txt", "-s", "stats.txt", "-w", "seeds.fasta"],
        fasta,
    )


def test_d2_multi_mnt_beyond_reference(both):
    """A 2 Mnt member at d=2: the REFERENCE binary aborts (bad_alloc in
    its O(longest^2) dirbuffer); the arena-based engine clusters it in
    normal memory. Capability beyond the reference, so no byte diff —
    the giant must land as its own singleton swarm."""
    fasta = _mixed_corpus(905, giant_len=2_000_000)
    workdir, r = both.run_one(
        "ours", ["-d", "2", "-o", "out.txt", "-s", "stats.txt"], fasta
    )
    assert r.returncode == 0, r.stderr[-500:]
    stats = (workdir / "stats.txt").read_text().splitlines()
    giant_rows = [ln for ln in stats if "giant" in ln]
    assert len(giant_rows) == 1
    assert giant_rows[0].split("\t")[0] == "1"  # singleton swarm


def test_d0_with_multi_mnt_sequence(both):
    fasta = _mixed_corpus(910, giant_len=1_000_000)
    both.compare(["-d", "0", "-o", "out.txt", "-s", "stats.txt"], fasta)
