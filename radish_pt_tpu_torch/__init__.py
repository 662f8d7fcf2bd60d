"""radish_pt_tpu_torch — the PyTorch/CUDA port of radish_pt_tpu.

The full-MIS wavefront path tracer on torch tensors, with hand-written CUDA
kernels (``csrc/``) for the Plücker closest-hit and shadow sweeps.  The JAX
package ``radish_pt_tpu`` is the reference it is tested against; this
package imports neither jax nor it.  Public API:

    from radish_pt_tpu_torch import load_scene, Renderer
"""

__version__ = "0.1.0"

from .scene.build import load_scene  # noqa: F401
from .render.renderer import Renderer  # noqa: F401
