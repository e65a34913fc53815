"""PyTorch + CUDA port of the wavefront path tracer (pathtracer_tpu).

The same wavefront engine (masked, material-sorted and tiled modes), the
persistent engine, scene model and estimators as the JAX package, in eager
PyTorch; the Pallas kernels (the mesh intersectors' and the scan's) become
hand-written CUDA kernels for Hopper (csrc/), each with a plain PyTorch version beside
its wrapper. This package imports torch and never jax.
"""

from .engine.persistent import render_persistent
from .engine.wavefront import render, render_iteration
from .scene.loader import load_scene
from .scene.types import RenderSettings, SceneArrays

__all__ = ["load_scene", "RenderSettings", "SceneArrays", "render",
           "render_iteration", "render_persistent"]
