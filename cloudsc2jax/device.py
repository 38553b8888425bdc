"""Which way the Pallas kernels run on the platform at hand.

The kernels are written for the GPU (Triton route).  On the CPU the same
kernel code runs in Pallas interpret mode — slow, but the same semantics,
which is how the tests reach the kernels without a card.  Any other
platform has no route and is refused rather than guessed at.
"""

from __future__ import annotations

import os
import subprocess
import sys

__all__ = ["pallas_interpret", "nvidia_smi", "cards_on_host"]


def pallas_interpret(platform: str | None = None, *, announce: bool = False
                     ) -> bool:
    """True on ``"cpu"`` (interpret mode), False on ``"gpu"`` (compiled);
    any other platform raises.  ``platform`` defaults to that of the
    first JAX device; ``announce`` says on stderr when interpret mode is
    chosen."""
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    if platform == "gpu":
        return False
    if platform == "cpu":
        if announce:
            print("NOTE: --pallas on the CPU runs in Pallas interpret mode",
                  file=sys.stderr)
        return True
    raise RuntimeError(
        f"no Pallas route for platform {platform!r}: the kernels compile "
        "for the GPU and run in interpret mode on the CPU"
    )


def _smi_lines(query: str) -> list[str]:
    """``nvidia-smi --query-gpu=<query>`` (csv, no header), one line per
    card; empty where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.strip().splitlines() if ln.strip()]


def nvidia_smi(query: str = "name,power.limit") -> str | None:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line, or None
    where there is no ``nvidia-smi``.  A card set below its maximum power
    limit runs slower under load, so every measurement names the limit it
    ran at."""
    lines = _smi_lines(query)
    return lines[0] if lines else None


def cards_on_host() -> int:
    """The GPUs a process on this host can open: the entries of
    ``CUDA_VISIBLE_DEVICES`` where it is set, else the cards nvidia-smi
    lists; 0 where there are none."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    return len(_smi_lines("index"))
