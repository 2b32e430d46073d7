"""What the card says of itself beside the window: its name, power limit,
draw, clocks and temperature from `nvidia-smi` (read-only queries)."""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

FIELDS = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.mem",
          "temperature.gpu")


def sample(index: int = 0) -> Optional[dict]:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, f"--id={index}", f"--query-gpu={','.join(FIELDS)}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (subprocess.SubprocessError, OSError):
        return None
    values = [v.strip() for v in out.strip().split(",")]
    return dict(zip(FIELDS, values)) if len(values) == len(FIELDS) else None
