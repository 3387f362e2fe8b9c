"""One process of tests/test_torch_multihost.py: joins a gloo process
group on the CPU, loads its shard of a PLY, renders it sharded with a
gradient, exports the PLY by positional writes, and saves what it saw.

    python tests/_torch_multihost_child.py RANK WORLD HOST:PORT PLY OUT_DIR
"""

import os
import sys

import numpy as np
import torch

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.parallel import distributed, multihost
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

CFG = RasterConfig(image_width=64, image_height=256, pair_capacity=1 << 12,
                   max_chunks_per_tile=4)


def main():
    rank, world, coord, ply, out = sys.argv[1:6]
    torch.set_num_threads(1)
    assert multihost.initialize(coord, int(world), int(rank), device="cpu")
    mesh = multihost.make_process_mesh("cpu")
    scene = multihost.load_scene_sharded(ply, mesh)
    cam = Camera.orbit(scene.bb_min, scene.bb_max, float(np.radians(45.0)),
                       0.25, device="cpu")
    model = scene.model.trainable()
    res = distributed.render_sharded(model, cam, CFG, mesh)
    loss = res.image.abs().mean()
    grads = torch.autograd.grad(loss, tuple(model.parameters()))
    sumsq = torch.stack([(g * g).sum() for g in grads]).sum().reshape(1)
    torch.distributed.all_reduce(sumsq)
    multihost.export_ply_sharded(os.path.join(out, "export.ply"),
                                 scene.model)
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             image=res.image.detach().numpy(), bb_min=scene.bb_min,
             bb_max=scene.bb_max, bounds=multihost.local_shard_bounds(97),
             num_pairs=int(res.num_pairs), sumsq=float(sumsq),
             **scene.model.to_numpy())
    torch.distributed.destroy_process_group()
    print("OK")


if __name__ == "__main__":
    main()
