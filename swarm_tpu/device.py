"""Which JAX platform the engines run on.

The auto engine choice asks this once per stage: a GPU runs the device
engines, a CPU-only JAX runs the native host engines (they beat XLA's
CPU backend). An error while JAX starts its backend propagates: a
broken accelerator fails the run instead of being swapped for the host
engines.

SWARM_TPU_FORCE_PLATFORM=cpu (set together with JAX_PLATFORMS=cpu)
lets the auto choice take the device engines on the CPU: the tests run
them on virtual CPU devices.
"""

import os


def device_platform() -> str:
    """JAX's default backend: "gpu" or "cpu"."""
    import jax

    return jax.default_backend()


def use_device_engines() -> bool:
    """True when the auto choice should run the device engines."""
    if os.environ.get("SWARM_TPU_FORCE_PLATFORM") == "cpu":
        return True
    return device_platform() != "cpu"
