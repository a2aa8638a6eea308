"""The benchmark's own tests (not collected with the repository's tests/):

    python -m pytest perfbench/tests -q

On the CPU the card tests (marker `cuda`) skip; on the card run them with
`python -m pytest perfbench/tests -q -m cuda`.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
