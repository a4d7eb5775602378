"""Device identity for measurement entry points (bench.py, chip_smoke.py).

A measurement path runs on the GPU or not at all: it never falls back to
the CPU, and every result it prints names the device it ran on.
"""

from __future__ import annotations

import subprocess


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (`name, power.limit`, one line per card). Runs as a child process,
    off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"
    return out or "unavailable (empty nvidia-smi output)"


def require_gpu() -> dict:
    """Exit with a message unless JAX's default devices are GPUs.
    Returns {platform, kind, count, card} for the run's records."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX reports platform '{devs[0].platform}' "
            f"({len(devs)} device(s)); this measurement path runs only on "
            "a GPU"
        )
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "card": card_info(),
    }

