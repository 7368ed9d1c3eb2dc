"""TorchANI-TPU on PyTorch and CUDA: the port of the JAX package
``torchani_tpu`` to an NVIDIA H100.

Models are ``torch.nn.Module``s, everything else plain functions on tensors.
Entry points run on CUDA unless the caller passes ``device="cpu"``; without a
CUDA device such a call raises.  The angular AEV runs on a hand-written CUDA
kernel (``csrc/angular_aev.cu``), built by ``nvcc`` at its first use.

TF32 is switched off at import: it degrades ANI energies and forces far
beyond their tolerances.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from torchani_tpu_torch import (  # noqa: E402
    aev,
    constants,
    cutoffs,
    grad,
    interop,
    models,
    neighbors,
    nn,
    sae,
    testing,
    units,
    utils,
)
from torchani_tpu_torch.aev import AEVComputer  # noqa: E402
from torchani_tpu_torch.arch import ANI, Assembler  # noqa: E402
from torchani_tpu_torch.grad import energies_and_forces, single_point  # noqa: E402
from torchani_tpu_torch.nn import AtomicNetworks, Ensemble, SpeciesConverter  # noqa: E402
from torchani_tpu_torch.sae import SelfEnergy  # noqa: E402

__all__ = [
    "AEVComputer",
    "ANI",
    "Assembler",
    "AtomicNetworks",
    "Ensemble",
    "SelfEnergy",
    "SpeciesConverter",
    "energies_and_forces",
    "single_point",
    "aev",
    "constants",
    "cutoffs",
    "grad",
    "interop",
    "models",
    "neighbors",
    "nn",
    "sae",
    "testing",
    "units",
    "utils",
]
