"""Moderate-scale randomized byte-parity stress (device backend forced).

The regular parity tests use small corpora; these drive a few thousand
amplicons through the full CLI with SWARM_TPU_BACKEND=jax (on the CPU
mesh) and diff every output stream against the reference binary.
"""

import os

import pytest

from genfasta import amplicon_cloud


@pytest.fixture
def jax_backend():
    old = os.environ.get("SWARM_TPU_BACKEND")
    os.environ["SWARM_TPU_BACKEND"] = "jax"
    yield
    if old is None:
        os.environ.pop("SWARM_TPU_BACKEND", None)
    else:
        os.environ["SWARM_TPU_BACKEND"] = old


@pytest.mark.parametrize("seed", [101, 202])
def test_stress_d1_all_outputs(both, jax_backend, seed):
    fasta = amplicon_cloud(
        seed=seed, n_centers=40, cloud_size=60, length=110, max_edits=2
    )
    both.compare(
        ["-o", "out.txt", "-s", "stats.txt", "-i", "structure.txt",
         "-w", "seeds.fasta", "-u", "uclust.txt", "-l", "log.txt",
         "input.fasta"],
        fasta,
    )


def test_stress_d1_fastidious(both, jax_backend):
    fasta = amplicon_cloud(
        seed=303, n_centers=30, cloud_size=25, length=90, max_edits=3
    )
    both.compare(
        ["-f", "-o", "out.txt", "-s", "stats.txt", "-i", "structure.txt",
         "-l", "log.txt", "input.fasta"],
        fasta,
    )


def test_stress_d1_usearch_nobreak(both, jax_backend):
    fasta = amplicon_cloud(
        seed=404, n_centers=25, cloud_size=30, length=80, usearch=True
    )
    both.compare(
        ["-z", "-n", "-o", "out.txt", "-s", "stats.txt", "-l", "log.txt",
         "input.fasta"],
        fasta,
    )


def test_stress_sharded_backend(both):
    old = os.environ.get("SWARM_TPU_BACKEND")
    os.environ["SWARM_TPU_BACKEND"] = "jax_shard"
    try:
        fasta = amplicon_cloud(
            seed=505, n_centers=20, cloud_size=40, length=100
        )
        both.compare(
            ["-o", "out.txt", "-s", "stats.txt", "-l", "log.txt",
             "input.fasta"],
            fasta,
        )
    finally:
        if old is None:
            os.environ.pop("SWARM_TPU_BACKEND", None)
        else:
            os.environ["SWARM_TPU_BACKEND"] = old


@pytest.fixture
def host_engines():
    """Force the host engines (radix sort-join network + native graft),
    the production path when no healthy accelerator is attached."""
    old = {
        k: os.environ.get(k)
        for k in ("SWARM_TPU_BACKEND", "SWARM_TPU_GRAFT", "SWARM_TPU_D1_HOST")
    }
    os.environ["SWARM_TPU_BACKEND"] = "numpy"
    os.environ["SWARM_TPU_GRAFT"] = "native"
    os.environ["SWARM_TPU_D1_HOST"] = "sortjoin"
    yield
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_stress_host_engines_fastidious(both, host_engines):
    """Mid-scale -f through the host radix sort-join + native graft."""
    fasta = amplicon_cloud(
        seed=404, n_centers=120, cloud_size=40, length=120, max_edits=3,
        max_abundance=6,
    )
    both.compare(
        ["-f", "-o", "out.txt", "-s", "stats.txt", "-i", "structure.txt",
         "-w", "seeds.fasta", "-u", "uclust.txt", "-l", "log.txt",
         "input.fasta"],
        fasta,
    )


def test_stress_host_engines_threads(both, host_engines):
    """Host engines + -t 4 (threaded probe/writers) at mid scale."""
    os.environ["SWARM_TPU_D1_HOST"] = "probe"
    fasta = amplicon_cloud(
        seed=505, n_centers=100, cloud_size=35, length=100, max_edits=2
    )
    both.compare(
        ["-t", "4", "-o", "out.txt", "-s", "stats.txt", "-u", "uclust.txt",
         "-l", "log.txt", "input.fasta"],
        fasta,
    )
