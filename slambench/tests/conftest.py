"""The harness's modules import each other by their own names, as
``python3 slambench/run.py`` runs them; the tests see them the same way."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(1, str(HERE.parent.parent))
