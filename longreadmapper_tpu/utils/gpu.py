"""Identity of the GPUs a measurement ran on, as nvidia-smi reports it.

A card may run below its maximum power limit and then slows under load,
so every recorded time names the card and its limit.
"""

from __future__ import annotations

import subprocess
from typing import List


def card_name_and_power_limit() -> List[str]:
    """One `name, power.limit` line per GPU (e.g. 'NVIDIA H100 80GB HBM3,
    700.00 W').  Raises when nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    lines = [l.strip() for l in out.splitlines() if l.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no GPU")
    return lines
