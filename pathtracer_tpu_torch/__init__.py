"""PyTorch + CUDA port of the wavefront path tracer (pathtracer_tpu).

The same masked wavefront, scene model and estimators as the JAX package,
in eager PyTorch; the Pallas kernels of the mesh path become hand-written
CUDA kernels for Hopper (csrc/), each with a plain PyTorch version beside
its wrapper. This package imports torch and never jax.
"""

from .engine.wavefront import render, render_iteration
from .scene.loader import load_scene
from .scene.types import RenderSettings, SceneArrays

__all__ = ["load_scene", "RenderSettings", "SceneArrays", "render",
           "render_iteration"]
