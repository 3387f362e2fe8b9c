"""The benchmark's cells capture1m-refine-fit and capture1m-flythrough, as
a tier-1 gate: splatbench/tests/test_splatbench_refine.py's cases (both
drivers end to end at a tiny size on the CPU, the refine fit's fault and
control failing, the port's aux step against reference/refine.py, the
flythrough's loop, the readers of project_bwd_roofline and aux_ms),
collected here, where `pytest tests/` looks."""

import importlib.util
import os
import sys

_HERE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "splatbench", "tests")
if _HERE not in sys.path:
    sys.path.insert(0, _HERE)
_spec = importlib.util.spec_from_file_location(
    "splatbench_tests_refine",
    os.path.join(_HERE, "test_splatbench_refine.py"))
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)
globals().update({k: v for k, v in vars(_mod).items()
                  if k.startswith("test_")})
