"""One process of tests/test_torch_city_sharded.py: rank RANK of WORLD in a
gloo group on the CPU, making its shard of a small city scene from the
seed and running the sharded train step the benchmark's sharded_fit
driver builds, once, on one drone view; its results saved with
torch.save.

    python tests/_city_sharded_child.py RANK WORLD HOST:PORT OUT CONFIG

CONFIG is a JSON file holding {"config", "traffic", "seed", "view"}.
Saved: the shard the rank drew (scene and start), the target and the
start's image (the sharded render, gathered), the step's loss and drop
counters, the rank's rows of the first gradient (Adam's first moment
over 1 - b1), and the exchange's counters (rows sent, bucket rows, rows
received) of the start's render and of the step, each recorded alone.
"""

import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("exchange.rows_sent", "exchange.bucket_rows",
            "exchange.recv_rows")


def recorded(fn):
    """fn() with spans recorded: (its result, the exchange's counters)."""
    from gaussian_splat_ipu_tpu_torch.utils import profiling
    rec = profiling.start("cpu")
    try:
        out = fn()
    finally:
        profiling.stop()
    summary = rec.summary()
    return out, {k: summary[k] for k in COUNTERS}


def main():
    rank, world, coord, out, conf = sys.argv[1:6]
    os.environ.update(GSPLAT_COORDINATOR=coord, GSPLAT_NUM_PROCESSES=world,
                      GSPLAT_PROCESS_ID=rank)
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from gaussian_splat_ipu_tpu_torch.models.camera import Camera
    from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
    from gaussian_splat_ipu_tpu_torch.parallel import distributed, multihost
    from gaussian_splat_ipu_tpu_torch.runtime.engine import RenderEngine
    from gaussian_splat_ipu_tpu_torch.train import trainer
    from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig
    from splatbench import city, harness
    from splatbench.drivers import fit, sharded_fit

    with open(conf) as f:
        c = json.load(f)
    config, traffic, seed = c["config"], c["traffic"], c["seed"]
    assert multihost.initialize(device="cpu")
    r = multihost.process_index()
    pmesh = multihost.make_process_mesh("cpu")
    cams = city.drone_cameras(config, traffic, "cpu")
    gt = city.make_shard(config["scene"], seed, r, "cpu")
    init = city.perturb_shard(gt, traffic["perturb"], seed, r)
    cfg = harness.raster_config(config, sharded_fit.capacity(
        config, [gt, init], cams))
    cam = Camera(*cams[c["view"]])
    with torch.no_grad():
        target = distributed.render_sharded(
            GaussianModel(*(gt[k] for k in city.FIELDS)), cam, cfg,
            pmesh).image
        image, render_counts = recorded(
            lambda: distributed.render_sharded(
                GaussianModel(*(init[k] for k in city.FIELDS)), cam, cfg,
                pmesh).image)
    tcfg = trainer.TrainConfig(**fit.train_settings(config, traffic))
    state = trainer.init_state(GaussianModel(
        *(init[k].clone() for k in city.FIELDS), requires_grad=True), tcfg)
    engine = RenderEngine(RuntimeConfig(device="cpu"))
    trainer.register_step(engine, state, cam, target, cfg, tcfg,
                          step_fn=sharded_fit.build_step(pmesh, cfg, tcfg),
                          eager=sharded_fit.EAGER)
    (loss, stats), step_counts = recorded(
        lambda: engine.run(trainer.STEP_PROGRAM, state, cam, target))
    grads = {k: state.opt_state.adam[k].mu / (1.0 - fit.B1)
             for k in city.FIELDS}
    torch.save(dict(gt=gt, init=init, target=target, image=image,
                    loss=float(loss), stats=stats.tolist(), grads=grads,
                    pair_capacity=cfg.pair_capacity,
                    counters=dict(render=render_counts, step=step_counts)),
               out)
    print("OK")


if __name__ == "__main__":
    main()
