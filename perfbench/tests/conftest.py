"""The benchmark's own tests: CPU only, at tiny sizes (``tiny.py``);
a test that needs the card is marked ``cuda`` and decides inside the
test whether one is there."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
