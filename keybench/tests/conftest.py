"""The benchmark's tests: `python -m pytest keybench/tests -q` from the
repository root.  The ones marked `cuda` run on the card only."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
