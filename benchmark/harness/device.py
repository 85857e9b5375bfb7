"""What a run says about the card it ran on."""

from __future__ import annotations

import subprocess

QUERY = "name,clocks.sm,clocks.max.sm,power.limit,power.draw,temperature.gpu"


def card_line() -> str:
    """nvidia-smi's name, SM clock and its maximum, power limit and draw,
    and temperature of each card, or why there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return (out.stdout.strip().replace("\n", " | ")
            or out.stderr.strip() or "nvidia-smi printed nothing")
