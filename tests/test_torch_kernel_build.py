"""The kernel library's build on the CPU, with a stand-in for nvcc that
writes empty objects and logs each call: processes that share a checkout
(the ranks of a multi-process run) build the library once, under the
build directory's lock, and every one of them gets its path."""

import json
import os
import stat
import subprocess
import sys

from tests.test_torch_multihost import REPO

PROCESSES = 4
TIMEOUT_S = 120
FAKE_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\\n")
time.sleep(1.0)
open(args[args.index("-o") + 1], "wb").close()
"""
CHILD = """import json, sys
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
cuda_lib.BUILD_DIR = sys.argv[1]
path = cuda_lib._build()
print(json.dumps(dict(path=path, built=cuda_lib.BuildInfo.seconds > 0.0)))
"""


def test_processes_sharing_a_checkout_build_once(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, PYTHONPATH=REPO, FAKE_NVCC_LOG=str(log),
               PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    build = str(tmp_path / "_build")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, build], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(PROCESSES)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert len({g["path"] for g in got}) == 1
    assert os.path.isfile(got[0]["path"])
    assert sum(g["built"] for g in got) == 1
    calls = log.read_text().split()
    sources = [f for f in os.listdir(os.path.join(
        REPO, "gaussian_splat_ipu_tpu_torch", "csrc")) if f.endswith(".cu")]
    assert calls.count("link") == 1
    assert calls.count("compile") == len(sources)
