"""The benchmark's tests: run from the repository root with
``python -m pytest benchmark/tests``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.main import keep_out_jax  # noqa: E402

keep_out_jax()
