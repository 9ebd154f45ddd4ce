"""``python -m repro_torch.api`` — the suite-runner CLI.

(Entry point lives here rather than in ``suite.py`` so the package
``__init__``'s eager ``.suite`` import and runpy never double-execute the
module.)
"""
import sys

from .suite import main

if __name__ == "__main__":
    sys.exit(main())
