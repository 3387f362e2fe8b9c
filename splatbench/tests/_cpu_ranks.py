"""run.py's ranks on the CPU, for the harness's tests: rank 0 and every
other rank run a cell of a fixture benchmark with run.py's own launch,
collection and merge (run.run_cell), past its look for cards, each rank on
the CPU and the group over gloo.

    python3 splatbench/tests/_cpu_ranks.py \
        --bench splatbench/tests/ranks/BENCHMARK.json \
        --workload collectives2 --seed 1 --seconds 0.5 --trace 0
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from splatbench import harness, run  # noqa: E402


def main(argv=None) -> int:
    args = run.parse(argv)
    return run.run_cell(args, harness.load_json(args.bench), "cpu")


if __name__ == "__main__":
    raise SystemExit(main())
