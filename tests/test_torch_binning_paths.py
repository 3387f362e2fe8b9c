"""The binning's gather paths (expand_kernel=False, presort_depth, the exact
two-pass sort) against the JAX package: kernel F's plain version against
the reference's interpret-mode expand_pairs, each path's VJP, the presort
gradients against the exact sort's, and the huge-grid fallback to the
exact sort."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splat_ipu_tpu.render import binning as jbin
from gaussian_splat_ipu_tpu.render.kernels import expand as jexp
from gaussian_splat_ipu_tpu.render.projection import (
    ProjectedSplats as JSplats)
from gaussian_splat_ipu_tpu_torch.render import binning
from gaussian_splat_ipu_tpu_torch.render.kernels import expand
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig
from tests.test_torch_binning import (CFG, assert_binned_equal, jax_splats,
                                      to_torch)

torch.set_num_threads(1)

# tests/test_binning.py's grid: 4x2 tiles of 32x32.
SMALL = RasterConfig(image_width=128, image_height=64, tile_width=32,
                     tile_height=32, pair_capacity=256, chunk_size=8,
                     max_chunks_per_tile=32)
PATHS = [dict(expand_kernel=False), dict(presort_depth=True),
         dict(fused_sort_key=False)]


def make_splats(xy, radius, depth, opacity=0.9):
    """tests/test_binning.py::make_splats, as numpy for both packages."""
    n = len(xy)
    return JSplats(
        xy=jnp.asarray(np.asarray(xy, np.float32)),
        depth=jnp.asarray(np.asarray(depth, np.float32)),
        conic=jnp.tile(jnp.array([[1.0, 0.0, 1.0]], jnp.float32), (n, 1)),
        color=jnp.tile(jnp.array([[1.0, 0.5, 0.25]], jnp.float32), (n, 1)),
        opacity=jnp.full((n,), opacity, jnp.float32),
        radius=jnp.stack([jnp.asarray(radius, jnp.float32)] * 2, -1))


def test_expand_pairs_plain_matches_pallas_interpret():
    """Exact: a row copy. gid_pre from the gather path's own scatter-max +
    cummax on a scene with culled gaussians and a pad tail; P = 3000 is
    not a multiple of the reference's 2048-slot chunk."""
    cfg = dataclasses.replace(CFG, pair_capacity=3008)
    ts = to_torch(jax_splats(3, 700, cfg))
    packed, offs = binning.pack_gaussians(ts, cfg)
    n = packed.shape[0] - 1
    gid_pre, _ = binning.gather_slots(offs, 3000)
    assert 0 < int(offs[n]) < 3000 and int(gid_pre[-1]) == n
    got = expand.expand_pairs(packed, gid_pre)
    want = jexp.expand_pairs(jexp.pad_packed_cols(jnp.asarray(packed.numpy())),
                             jnp.asarray(gid_pre.numpy()), interpret=True)
    assert got.shape == (16, 3000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        expand.expand_pairs_torch(packed, gid_pre).numpy(), np.asarray(want))


def test_gather_slots_match_the_stream_expansion():
    """The scatter-max + cummax slots equal kernel B's binary search, in
    the overflowing case too (slots past P drop)."""
    ts = to_torch(jax_splats(1, 600, CFG))
    _, offs = binning.pack_gaussians(ts, CFG)
    for p in (4096, 512):
        gid, rank = binning.gather_slots(offs, p)
        packed = torch.zeros((offs.shape[0], 16))
        _, want_gid, want_rank = expand.stream_expand_torch(packed, offs, p)
        np.testing.assert_array_equal(gid.numpy(), want_gid.numpy())
        np.testing.assert_array_equal(rank.numpy(), want_rank.numpy())


@pytest.mark.parametrize("change", PATHS)
def test_gather_path_vjp_matches_jax(change):
    """A cotangent on the pair table carried back to the five splat fields
    by the port's _PairTable and by the reference's custom VJPs
    (binning.py:307-315, :727-738, :790-797); sums reassociate, hence
    1e-6."""
    cfg = dataclasses.replace(CFG, exact_tile_test=True, **change)
    js = jax_splats(0, 1500, cfg)
    cot = np.random.default_rng(1).normal(
        size=(16, cfg.pair_capacity)).astype(np.float32)
    names = ("xy", "depth", "conic", "color", "opacity")

    def jf(*fields):
        s = js._replace(**dict(zip(names, fields)))
        return jnp.sum(jbin.bin_splats(s, cfg).features * cot)

    want = jax.grad(jf, argnums=tuple(range(5)))(
        *(getattr(js, k) for k in names))
    ts = to_torch(js)
    leaves = [getattr(ts, k).clone().requires_grad_() for k in names]
    feats = binning.bin_splats(ts._replace(**dict(zip(names, leaves))),
                               cfg).features
    torch.sum(feats * torch.tensor(cot)).backward()
    for name, leaf, w in zip(names, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    assert float(leaves[0].grad.abs().max()) > 1.0


def test_presort_matches_exact_sort_with_gradients():
    """Port of tests/test_binning.py:261-321: the depth presort keeps the
    exact f32 depth order, so its table equals the exact two-pass sort's,
    and so do the opacity gradients (atol 1e-6, as there)."""
    rng = np.random.default_rng(14)
    n = 24
    xy = rng.uniform(0, [128, 64], (n, 2))
    depth = rng.uniform(0.5, 9.0, n)
    js = make_splats(xy, rng.uniform(1, 4, n), depth)
    ts = to_torch(js)

    def grad_with(cfg):
        op = ts.opacity.clone().requires_grad_()
        b = binning.bin_splats(ts._replace(opacity=op), cfg)
        torch.sum(b.features[binning.FEAT_OPACITY]
                  * (1.0 + b.features[binning.FEAT_R])).backward()
        return b, op.grad

    b_pre, g_pre = grad_with(dataclasses.replace(SMALL, presort_depth=True))
    b_ex, g_ex = grad_with(dataclasses.replace(SMALL, fused_sort_key=False))
    for name in ("pair_gid", "features", "tile_starts", "tile_ends",
                 "num_pairs"):
        np.testing.assert_array_equal(getattr(b_pre, name).detach().numpy(),
                                      getattr(b_ex, name).detach().numpy(),
                                      err_msg=name)
    np.testing.assert_allclose(g_pre.numpy(), g_ex.numpy(), atol=1e-6)
    assert float(g_pre.abs().max()) > 0


def test_huge_tile_grid_falls_back_to_exact_sort():
    """Port of tests/test_binning.py:233: a 512x128 tile grid leaves fewer
    than 16 depth bits for the fused key, so the exact two-pass path runs;
    bit-identical to the JAX package, one pair per tile."""
    cfg = RasterConfig(image_width=4096, image_height=1024, tile_width=8,
                       tile_height=8, pair_capacity=256, chunk_size=8,
                       max_chunks_per_tile=8)
    assert 31 - (cfg.num_tiles + 1).bit_length() < 16
    js = make_splats([[4.0, 4.0], [12.0, 4.0]], [2.0, 2.0], [2.0, 1.0])
    want = jbin.bin_splats(js, cfg)
    got = binning.bin_splats(to_torch(js), cfg)
    assert_binned_equal(want, got)
    assert int(got.num_pairs) == 2 and int(got.overflow) == 0
    assert int(got.tile_ends[0] - got.tile_starts[0]) == 1
    assert int(got.tile_ends[1] - got.tile_starts[1]) == 1
