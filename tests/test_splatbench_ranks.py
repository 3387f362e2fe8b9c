"""The benchmark harness's cell on several cards, as a tier-1 gate:
splatbench/tests/test_splatbench_ranks.py's cases (harness.merge_results'
rules on hand-made results of 2-4 ranks; run.py's launch, collection and
merge over gloo ranks on the CPU; a rank that fails or ends ends the run),
collected here, where `pytest tests/` looks."""

import importlib.util
import os
import sys

_HERE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "splatbench", "tests")
if _HERE not in sys.path:
    sys.path.insert(0, _HERE)
_spec = importlib.util.spec_from_file_location(
    "splatbench_tests_ranks", os.path.join(_HERE, "test_splatbench_ranks.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)
globals().update({k: v for k, v in vars(_mod).items()
                  if k.startswith("test_")})
