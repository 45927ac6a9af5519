"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
root of the checkout.  Tests marked `cuda` run only where there is a card
and decide so inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
