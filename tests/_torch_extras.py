"""Shared set-up of the training-extras parity tests: one scene, camera and
target made from a seed for both packages, and train states carried
across as numpy leaves (a reference pytree rebuilt from the port's
to_numpy, in JAX's flatten order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaussian_splat_ipu_tpu.models.gaussians import GaussianModel as JModel
from gaussian_splat_ipu_tpu.render import pipeline as jpipe
from gaussian_splat_ipu_tpu.train import trainer as jtrainer
from gaussian_splat_ipu_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_ipu_tpu_torch.train import trainer
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
from tests.test_torch_config import jax_config
from tests.test_torch_train import cameras, jmodel, params_np

CFG = RasterConfig(image_width=64, image_height=48, tile_width=16,
                   tile_height=16, chunk_size=32, pair_capacity=1 << 12,
                   max_chunks_per_tile=16)
TC = trainer.TrainConfig(ssim_weight=0.2, scene_extent=1.5)
JTC = jtrainer.TrainConfig(ssim_weight=0.2, scene_extent=1.5)


@functools.lru_cache(maxsize=None)
def scene(n=150, sh_degree=1, rot=40.0, cfg=CFG):
    """(params as numpy, JAX camera, port camera, target (H, W, 4) numpy):
    the target is another seeded model's render, so steps have a
    gradient. Cached: callers must not write into what it returns."""
    p = params_np(0, n, sh_degree=sh_degree, log_scale=(-3.5, -2.0))
    jc, tcam = cameras(cfg, rot)
    target = np.asarray(jpipe.render_image(
        jmodel(params_np(3, n, sh_degree=sh_degree, log_scale=(-3.5, -2.0))),
        jc, jax_config(cfg), False))
    return p, jc, tcam, target


def port_state(p: dict, seed=0, moments=True) -> trainer.TrainState:
    """A port TrainState on the CPU from numpy parameters; with `moments`,
    random Adam moments and counts of 3, so row surgery shows."""
    state = trainer.init_state(
        GaussianModel.from_numpy(p, device="cpu").trainable(), TC)
    if moments:
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for st in state.opt_state.adam.values():
                st.count.fill_(3)
                st.mu.copy_(torch.tensor(rng.normal(
                    size=st.mu.shape).astype(np.float32)))
                st.nu.copy_(torch.tensor(rng.uniform(
                    0.1, 1.0, st.nu.shape).astype(np.float32)))
            state.opt_state.means_lr_count.fill_(3)
            state.step.fill_(3)
    return state


def jax_copy(x):
    """A JAX array of its own: the port's to_numpy aliases a CPU tensor's
    storage, the port updates in place, and JAX runs asynchronously."""
    return jnp.asarray(np.array(x))


def jax_train_state(leaves):
    """The reference TrainState holding copies of the 22 numpy leaves."""
    params = JModel(*(jnp.zeros(np.shape(x), jnp.float32)
                      for x in leaves[:5]))
    treedef = jax.tree_util.tree_structure(jtrainer.init_state(params))
    return jax.tree_util.tree_unflatten(treedef,
                                        [jax_copy(x) for x in leaves])


def leaves_of(tree) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
