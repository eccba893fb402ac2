"""The checkout's root on the path, so that ``perfbench`` and the port import
whichever directory pytest starts from."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
