"""The benchmark's CPU tests import ``stereobench`` and the program from the
checkout's root.  Run them with ``python -m pytest stereobench/tests`` from the
root; tests marked ``cuda`` need a card and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
