"""Entry point of the benchmark (see harness.py):

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
