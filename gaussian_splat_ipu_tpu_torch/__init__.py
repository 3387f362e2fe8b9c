"""gaussian_splat_ipu_tpu_torch — the PyTorch + CUDA port of the renderer.

A second package beside the JAX reference (`gaussian_splat_ipu_tpu`). Module
paths mirror the reference: `render/binning.py` here is the counterpart of
`gaussian_splat_ipu_tpu/render/binning.py`, and so on. Plain tensor code is
PyTorch; every Pallas kernel on the forward render path has a hand-written
CUDA kernel under `csrc/`, built with nvcc at first use and bound with
ctypes (`render/kernels/cuda_lib.py`). Each kernel sits beside its plain
PyTorch version, which CPU tensors take.

This package imports torch and never jax, and nothing of the reference
package: it keeps its own copies of the reference's jax-free modules,
`RasterConfig` (utils/config.py), the PNG codec (utils/image.py) and the
PLY parser and writer (io/ply.py).

Public surface:

  models    GaussianModel (nn.Module), Camera
  render    render / render_image / render_depth, points.render_points
  io        load_scene, Scene
  runtime   RenderEngine (programs captured as CUDA graphs)
  ui        InterfaceServer / InterfaceClient, the viewer CLI
  app       python -m gaussian_splat_ipu_tpu_torch.app.main --input s.ply
"""
