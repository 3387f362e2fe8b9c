"""One process of tests/test_torch_multihost.py's capped-exchange case:
joins a gloo process group on the CPU, takes its shard of a seeded random
model, and renders it sharded with every exchange bucket capped at
CAP_ROWS rows (distributed._exchange_capacity patched, as the app's
distributed test patches it), spans recorded; saves what it saw.

    python tests/_torch_capped_exchange_child.py RANK WORLD HOST:PORT OUT
"""

import sys

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.parallel import distributed, multihost
from gaussian_splat_ipu_tpu_torch.utils import profiling
from tests._torch_multihost_child import CFG

CAP_ROWS = 128
GAUSSIANS = 2048
SEED = 11


def scene():
    """The whole model and the camera, the same in every process."""
    model = GaussianModel.random(
        GAUSSIANS, generator=torch.Generator().manual_seed(SEED),
        device="cpu")
    bb = np.ones(3, np.float32)
    cam = Camera.orbit(-bb, bb, float(np.radians(45.0)),
                       CFG.image_width / CFG.image_height, device="cpu")
    return model, cam


def main():
    rank, world, coord, out = sys.argv[1:5]
    torch.set_num_threads(1)
    assert multihost.initialize(coord, int(world), int(rank), device="cpu")
    mesh = multihost.make_process_mesh("cpu")
    model, cam = scene()
    model = multihost.local_model(model)
    distributed._exchange_capacity = (
        lambda nloc, d, requested=None: CAP_ROWS)
    rec = profiling.start("cpu")
    try:
        res = distributed.render_sharded(model, cam, CFG, mesh)
    finally:
        profiling.stop()
    summary = rec.summary()
    torch.save(dict(image=res.image,
                    exchange_overflow=int(res.exchange_overflow),
                    counters={k: summary[k] for k in (
                        "exchange.rows_sent", "exchange.bucket_rows",
                        "exchange.recv_rows")}), out)
    torch.distributed.destroy_process_group()
    print("OK")


if __name__ == "__main__":
    main()
