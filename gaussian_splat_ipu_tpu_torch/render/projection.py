"""Projection stage: gaussian parameters -> screen-space splats (torch port
of gaussian_splat_ipu_tpu/render/projection.py): view/clip transforms,
viewport mapping, EWA cov2D, conic, alpha-aware extents, SH colour and the
frustum cull.

Two implementations of one algorithm, chosen by what the call shows: on
CUDA, kernel G (render/kernels/project.py) in one pass when the model's
five tensors, the camera's and any xy_probe are f32 and no gradient is
recorded for the projection or the environment rotation; where a gradient
is recorded for the model, the probe or the view matrix (pose
refinement), G runs inside an autograd Function whose backward is kernel
G-bwd, which computes the view's gradient only where it is asked for.
Otherwise the plain version, project_gaussians_torch, which stays the CPU
path. `plain_calls` counts the CUDA calls that took the plain version, by
reason ("camera_grad": a gradient on proj or env_rot; "dtype"); G's
launches count in cuda_lib.launches["project_gaussians"], G-bwd's in
cuda_lib.launches["project_gaussians_bwd"]."""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.models.gaussians import FIELDS, GaussianModel
from gaussian_splat_ipu_tpu_torch.ops import covariance, sh, transforms
from gaussian_splat_ipu_tpu_torch.render.kernels import project as kernel
from gaussian_splat_ipu_tpu_torch.utils.config import RasterConfig

plain_calls: collections.Counter = collections.Counter()


class ProjectedSplats(NamedTuple):
    """Screen-space splats, all (N,) or (N, k) f32."""

    xy: torch.Tensor        # (N, 2) pixel centre
    depth: torch.Tensor     # (N,) view-space depth (positive in front)
    conic: torch.Tensor     # (N, 3) inverse 2D covariance (A, B, C)
    color: torch.Tensor     # (N, 3) RGB
    opacity: torch.Tensor   # (N,) post-activation opacity
    radius: torch.Tensor    # (N, 2) footprint half-extents; (0, 0) = culled


def plain_reason(model: GaussianModel, camera: Camera,
                 xy_probe: torch.Tensor | None) -> str | None:
    """Why a call takes the plain version rather than kernels G and G-bwd,
    or None: the module docstring's rule, the device aside."""
    cam = [camera.view, camera.proj, camera.env_rot]
    if torch.is_grad_enabled() and any(t.requires_grad for t in cam[1:]):
        return "camera_grad"
    probe = [] if xy_probe is None else [xy_probe]
    if any(t.dtype != torch.float32
           for t in [getattr(model, k) for k in FIELDS] + cam + probe):
        return "dtype"
    return None


class _Project(torch.autograd.Function):
    """G forward, G-bwd backward: the splats of `project_gaussians`,
    differentiable in the model's five tensors, the view matrix and the xy
    probe (radius is not differentiable, as in the plain version)."""

    @staticmethod
    def forward(ctx, cfg, degree, means, log_scales, quats, opacities, sh_,
                view, proj, env_rot, xy_probe):
        inputs = (means, log_scales, quats, opacities, sh_, view, proj,
                  env_rot)
        xy, *rest = kernel.project(*inputs, cfg, degree)
        if xy_probe is not None:
            xy.add_(xy_probe)
        ctx.save_for_backward(*inputs)
        ctx.cfg, ctx.degree = cfg, degree
        ctx.mark_non_differentiable(rest[-1])
        ctx.set_materialize_grads(False)
        return (xy, *rest)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_xy, g_depth, g_conic, g_color, g_opacity, _):
        need_fields = ctx.needs_input_grad[2:7]
        need_view = ctx.needs_input_grad[7]
        need_probe = ctx.needs_input_grad[10]
        grads, g_probe, g_view = (None,) * 5, None, None
        if any(need_fields) or need_view:
            cots = tuple(None if g is None
                         else g if g.dim() == 1 or g.stride(1) == 1
                         else g.contiguous()
                         for g in (g_xy, g_depth, g_conic, g_color,
                                   g_opacity))
            out = kernel.project_bwd(
                *ctx.saved_tensors, ctx.cfg, ctx.degree, cots,
                probe=need_probe, view_grad=need_view)
            grads, g_probe = out[:5], out[5]
            g_view = out[6] if need_view else None
            grads = [g if need else None
                     for g, need in zip(grads, need_fields)]
        elif need_probe and g_xy is not None:
            g_probe = g_xy.clone()
        return (None, None, *grads, g_view, None, None, g_probe)


def project_gaussians(model: GaussianModel, camera: Camera,
                      cfg: RasterConfig,
                      xy_probe: torch.Tensor | None = None
                      ) -> ProjectedSplats:
    """xy_probe: optional (N, 2) zeros added to the screen position, whose
    gradient is the screen-space positional gradient densification uses.
    On CUDA tensors kernel G computes the splats, and G-bwd their
    gradients, unless plain_reason gives a reason not to (module
    docstring)."""
    if model.means.is_cuda:
        reason = plain_reason(model, camera, xy_probe)
        if reason is None:
            degree = model.sh_degree
            if cfg.active_sh_degree >= 0:
                degree = min(degree, cfg.active_sh_degree)
            fields = [getattr(model, k).contiguous() for k in FIELDS]
            cam = [t.contiguous() for t in (camera.view, camera.proj,
                                            camera.env_rot)]
            probe = [] if xy_probe is None else [xy_probe.contiguous()]
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in fields + probe + cam[:1]):
                return ProjectedSplats(*_Project.apply(
                    cfg, degree, *fields, *cam, *(probe or [None])))
            xy, *rest = kernel.project(*fields, *cam, cfg, degree)
            return ProjectedSplats(xy + probe[0] if probe else xy, *rest)
        plain_calls[reason] += 1
    return project_gaussians_torch(model, camera, cfg, xy_probe)


def project_gaussians_torch(model: GaussianModel, camera: Camera,
                            cfg: RasterConfig,
                            xy_probe: torch.Tensor | None = None
                            ) -> ProjectedSplats:
    """The plain version: project_gaussians in PyTorch ops, on any device,
    differentiable."""
    means = transforms.at_least_f32(model.means)

    view_h = transforms.transform_points(camera.view, means)      # (N, 4)
    clip = transforms.transform_points(camera.proj, view_h)        # (N, 4)
    t_view = view_h[:, :3]
    depth = -t_view[:, 2]  # camera looks down -z; positive in front

    xy = transforms.clip_to_screen(clip, cfg.image_width, cfg.image_height)
    if xy_probe is not None:
        xy = xy + xy_probe

    fx, fy, tan_fovx, tan_fovy = camera.focals(cfg.image_width,
                                               cfg.image_height)
    cov3d = covariance.covariance_3d(model.log_scales, model.quats)
    a, b, c = covariance.ewa_project(t_view, cov3d, camera.view, fx, fy,
                                     tan_fovx, tan_fovy, cfg.lowpass)
    ca, cb, cc, conic_valid = covariance.conic(a, b, c)

    opacity = transforms.at_least_f32(model.opacities)
    if cfg.sigmoid_opacity:
        opacity = torch.sigmoid(opacity)
    if cfg.antialias:
        opacity = opacity * covariance.aa_opacity_compensation(
            a, b, c, cfg.lowpass)
    rx, ry = covariance.splat_extent(a, c, opacity.detach(), cfg.alpha_min,
                                     cfg.extent_sigma)

    degree = model.sh_degree
    if cfg.active_sh_degree >= 0:
        degree = min(degree, cfg.active_sh_degree)
    if degree == 0:
        color = sh.dc_to_rgb(model.sh[:, 0])
    else:
        dirs = means - camera.cam_origin[None, :]
        dirs = dirs / torch.clamp_min(
            torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), 1e-8)
        rot = (transforms.rotate_y(camera.env_rot[1])[:3, :3]
               @ transforms.rotate_x(camera.env_rot[0])[:3, :3])
        dirs = dirs @ rot.T
        color = sh.eval_sh(model.sh, dirs, degree)

    # Frustum cull: in front of the near plane, on screen with the radius
    # guard band, a valid conic, a non-empty footprint, visible opacity.
    w = clip[:, 3]
    near_ok = w > 1e-6
    on_screen = ((xy[:, 0] + rx >= 0.0)
                 & (xy[:, 0] - rx <= cfg.image_width)
                 & (xy[:, 1] + ry >= 0.0)
                 & (xy[:, 1] - ry <= cfg.image_height))
    visible = near_ok & on_screen & conic_valid & (rx > 0.0) & (
        ry > 0.0) & (opacity >= cfg.alpha_min)
    radius = torch.where(visible[:, None], torch.stack([rx, ry], -1), 0.0)

    return ProjectedSplats(
        xy=xy,
        depth=depth,
        conic=torch.stack([ca, cb, cc], -1),
        color=color,
        opacity=opacity,
        radius=radius,
    )
