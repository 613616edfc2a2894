"""gan_inpainting_torch — the PyTorch/CUDA port of ``gan_inpainting_tpu``.

Serves and trains the coarse-to-fine inpainting generator on an NVIDIA
H100: PyTorch (cuDNN) convolutions, and hand-written CUDA kernels for the
ops the JAX package wrote in Pallas (contextual attention forward and
backward and its overlap-add fold, ``ops/kernels/`` built from ``csrc/``).
``python -m gan_inpainting_torch train`` runs the alternating D/G step. Public functions keep the JAX
package's layouts (NHWC activations, HWIO kernels in the npz, (B, H, W, 1)
masks with 1 = hole) and run on CUDA unless the caller passes
``device="cpu"``.
"""

__version__ = "0.2.0"

from gan_inpainting_torch.configs.base import (  # noqa: F401
    Config,
    apply_overrides,
    get_config,
    list_configs,
)
from gan_inpainting_torch.infer.inpaint import Inpainter, inpaint  # noqa: F401
from gan_inpainting_torch.models.generator import (  # noqa: F401
    CoarseToFineGenerator,
    DilatedGenerator,
    build_generator,
)
