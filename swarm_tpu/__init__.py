"""swarm_tpu — amplicon clustering on a GPU, written in JAX.

A from-scratch reimplementation of the capabilities of swarm
(https://github.com/torognes/swarm, v3.1.6) for an accelerator: the
O(n·L) and O(n²) inner work (microvariant hashing, sort joins, qgram
screens, banded cost-space alignment) runs as batched JAX/XLA/Pallas
programs on device,
while the host owns parsing, ordering, graph assembly and output.

Output is byte-compatible with the reference implementation
(see tests/test_d1_parity.py, test_general_parity.py, test_derep_parity.py
and test_stderr_progress.py, which diff against a reference binary).
"""

__version__ = "0.1.0"

SWARM_VERSION = "3.1.6"  # CLI/behaviour-compatibility version
