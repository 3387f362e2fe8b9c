"""One process of tests/test_torch_multihost_train.py: the port's train
CLI (app/train.py run) in a process group of WORLD processes, its
statistics saved as JSON.

    python tests/_torch_train_child.py RANK WORLD HOST:PORT OUT_JSON ARG...

The GSPLAT_* environment is set from the first three arguments; "{rank}"
in an ARG is replaced by RANK.
"""

import json
import os
import sys

import torch

KEYS = ("losses", "events", "final_loss", "psnr", "eval_psnr", "step",
        "num_gaussians", "final_alive", "shards", "processes",
        "final_overflow", "target_overflow")


def main():
    rank, world, coord, out = sys.argv[1:5]
    argv = [a.replace("{rank}", rank) for a in sys.argv[5:]]
    os.environ.update(GSPLAT_COORDINATOR=coord, GSPLAT_NUM_PROCESSES=world,
                      GSPLAT_PROCESS_ID=rank)
    torch.set_num_threads(1)
    from gaussian_splat_ipu_tpu_torch.app import train
    stats = train.run(argv)
    with open(out, "w") as f:
        json.dump({k: stats[k] for k in KEYS}, f)
    print("OK")


if __name__ == "__main__":
    main()
