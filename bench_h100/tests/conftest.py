"""The benchmark's CPU tests import its modules (``run``, ``check``,
``reference``, ...) from the folder above, as ``run.py`` does."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
