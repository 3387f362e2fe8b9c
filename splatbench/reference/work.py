"""The benchmark's work model: the operations and bytes that a frame or a
train step needs, from the counts that the plain reference takes on the
cell's own inputs, and the published peaks of one NVIDIA H100 (SXM, dense,
at its full 700 W power limit; a card set lower runs slower, so every
share is reported with the card's limit beside it).

The arithmetic of the compositing kernels' bounds is a frozen copy of the
one the port's card smoke test used for its kernel table (27 operations a
live evaluation forward, 54 backward; a kernel's bound is its bytes over
the memory rate or its operations over the FP32 rate, whichever is
larger). Its counts are never the program's: the pairs are those of the
reference's exact ellipse-tile test, the live evaluations those of the
reference's own walk. A share therefore reads the same work whatever
implements it.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12      # HBM3
PEAK_OPS_S = 67e12          # FP32 outside the tensor cores

# Per live (pair, pixel) evaluation: the compositing forward (power, exp,
# clamp, tests, the transmittance step and the colour accumulation) and
# its backward (the replay plus the gradient terms of the nine rows).
OPS_FWD_LIVE = 27
OPS_BWD_LIVE = 54
# Per gaussian projected: the view and clip transforms (56), the screen
# mapping (6), the 3D covariance from scale and quaternion (81), the EWA
# projection with its clamps (80), the conic (8), the sigmoid (4), the
# footprint extent (12) and the cull (12).
OPS_PROJECT = 259
# Per gaussian, the colour at each SH degree: the view direction (27 from
# degree 1 on), 2 operations per coefficient and channel, the basis
# functions (4, 12 and 37 for degrees 1-3 together) and the clamp (9).
OPS_SH = {0: 9, 1: 27 + 2 * 3 * 4 + 4 + 9, 2: 27 + 2 * 3 * 9 + 12 + 9,
          3: 27 + 2 * 3 * 16 + 37 + 9}
# Autodiff of the projection: two passes' worth of the forward.
PROJECT_BWD_X = 2
# Per image value (pixel and RGB channel): L1 forward and backward (5);
# SSIM's five separable 11-tap blurs (2 x 11 x 2 operations each, 220)
# and its per-pixel terms (20), forward, and twice that backward.
OPS_L1_VALUE = 5
OPS_SSIM_VALUE = 3 * 240
# Per parameter: one Adam update (moments, bias correction, root, step).
OPS_ADAM = 13
# Bytes per pair of the compositing table (9 f32 rows), per tile range
# (two i32), per pixel: C writes RGBA f32 (16; +4 for the contributor
# count when it trains); D reads the image cotangent, 1 - alpha and the
# count (24) and writes the 9 rows of each pair's gradient.
BYTES_PAIR = 9 * 4
BYTES_RANGE = 8
BYTES_PIXEL_FWD = 16
BYTES_PIXEL_FWD_TRAIN = 20
BYTES_PIXEL_BWD = 24


def bound_s(n_bytes: float, ops: float) -> float:
    """The least time the card could take, in seconds."""
    return max(n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S)


def padded_pixels(rc: dict) -> int:
    tx = -(-rc["image_width"] // rc["tile_width"])
    ty = -(-rc["image_height"] // rc["tile_height"])
    return tx * ty * rc["tile_width"] * rc["tile_height"]


def num_tiles(rc: dict) -> int:
    return (-(-rc["image_width"] // rc["tile_width"])
            * -(-rc["image_height"] // rc["tile_height"]))


def raster_fwd_bound_s(counts: dict, rc: dict, train: bool) -> float:
    """Kernel C on one frame: the table read once, the ranges, the pixels
    written; 27 operations per live evaluation."""
    per_pixel = BYTES_PIXEL_FWD_TRAIN if train else BYTES_PIXEL_FWD
    n_bytes = (BYTES_PAIR * counts["pairs"] + BYTES_RANGE * num_tiles(rc)
               + per_pixel * padded_pixels(rc))
    return bound_s(n_bytes, OPS_FWD_LIVE * counts["live"])


def raster_bwd_bound_s(counts: dict, rc: dict) -> float:
    """Kernel D on one step: the table read and its gradient written, the
    ranges, the pixels read; 54 operations per live evaluation."""
    n_bytes = (2 * BYTES_PAIR * counts["pairs"] + BYTES_RANGE * num_tiles(rc)
               + BYTES_PIXEL_BWD * padded_pixels(rc))
    return bound_s(n_bytes, OPS_BWD_LIVE * counts["live"])


def frame_ops(counts: dict, scene: dict) -> float:
    """Operations of one frame: every gaussian projected and coloured,
    and the live evaluations composited."""
    n = scene["gaussians"]
    return (n * (OPS_PROJECT + OPS_SH[scene["sh_degree"]])
            + OPS_FWD_LIVE * counts["live"])


def step_ops(counts: dict, scene: dict, rc: dict, ssim_weight: float
             ) -> float:
    """Operations of one train step: the frame forward, the loss forward
    and backward, the compositing and projection backward, and Adam over
    every parameter (59 a gaussian at SH degree 3, 14 at degree 0)."""
    n = scene["gaussians"]
    k = (scene["sh_degree"] + 1) ** 2
    params = n * (3 + 3 + 4 + 1 + 3 * k)
    values = 3 * rc["image_width"] * rc["image_height"]
    loss = values * (OPS_L1_VALUE + (OPS_SSIM_VALUE if ssim_weight > 0
                                     else 0))
    proj = n * (OPS_PROJECT + OPS_SH[scene["sh_degree"]])
    return ((1 + PROJECT_BWD_X) * proj + loss
            + (OPS_FWD_LIVE + OPS_BWD_LIVE) * counts["live"]
            + OPS_ADAM * params)
