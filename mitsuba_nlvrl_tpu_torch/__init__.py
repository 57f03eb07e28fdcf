"""mitsuba_nlvrl_tpu_torch — the PyTorch/CUDA port of mitsuba_nlvrl_tpu.

The same wavefront renderer as the JAX package beside it, in plain torch
code, with every TPU kernel of the reference replaced by a kernel written
by hand for Hopper (``csrc/``). Entry points run on the CUDA device unless
the caller passes ``device='cpu'``. This package never imports JAX or the
reference package.
"""
from .scene.builder import build_scene, scene_from_numpy  # noqa: F401
from .render import preprocess, render, render_pass  # noqa: F401
from .integrators.vrl import maps_from_numpy, maps_to_numpy  # noqa: F401

__version__ = "0.1.0"
