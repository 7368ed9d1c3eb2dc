"""TorchANI-TPU on PyTorch and CUDA: the port of the JAX package
``torchani_tpu`` to an NVIDIA H100.

Models are ``torch.nn.Module``s, everything else plain functions on tensors.
Entry points run on CUDA unless the caller passes ``device="cpu"``; without a
CUDA device such a call raises.  The angular AEV (forward and backward), the
MD loop's per-step neighbor refresh (slot-row or atom-packed) and the per-lane
selection of runtime per-atom values inside D3 dispersion run on hand-written
CUDA kernels
(``csrc/angular_aev.cu``, ``csrc/bucket_select.cu``, ``csrc/packed_select.cu``,
``csrc/vals_select.cu``), built by ``nvcc`` at their first use.

TF32 is switched off at import: it degrades ANI energies and forces far
beyond their tolerances.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from torchani_tpu_torch import (  # noqa: E402
    aev,
    bucket_refresh,
    bucket_refresh_packed,
    constants,
    cutoffs,
    grad,
    interop,
    md,
    models,
    neighbors,
    nn,
    potentials,
    sae,
    testing,
    units,
    utils,
)
from torchani_tpu_torch.aev import AEVComputer  # noqa: E402
from torchani_tpu_torch.arch import ANI, Assembler, simple_ani  # noqa: E402
from torchani_tpu_torch.grad import energies_and_forces, single_point  # noqa: E402
from torchani_tpu_torch.md import (  # noqa: E402
    CachedSinglePoint,
    MDState,
    MolecularDynamics,
    kinetic_temperature,
    maxwell_boltzmann_velocities,
)
from torchani_tpu_torch.nn import AtomicNetworks, Ensemble, SpeciesConverter  # noqa: E402
from torchani_tpu_torch.sae import SelfEnergy  # noqa: E402

__all__ = [
    "AEVComputer",
    "ANI",
    "Assembler",
    "AtomicNetworks",
    "CachedSinglePoint",
    "Ensemble",
    "MDState",
    "MolecularDynamics",
    "SelfEnergy",
    "SpeciesConverter",
    "energies_and_forces",
    "kinetic_temperature",
    "maxwell_boltzmann_velocities",
    "simple_ani",
    "single_point",
    "aev",
    "bucket_refresh",
    "bucket_refresh_packed",
    "constants",
    "cutoffs",
    "grad",
    "interop",
    "md",
    "models",
    "neighbors",
    "nn",
    "potentials",
    "sae",
    "testing",
    "units",
    "utils",
]
