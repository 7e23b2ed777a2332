"""The card a measurement ran on: its name and power limit, read from
``nvidia-smi``, to print beside every time (a card set below its
maximum power runs slower under load)."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card,
    e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]
