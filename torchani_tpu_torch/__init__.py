"""TorchANI-TPU on PyTorch and CUDA: the port of the JAX package
``torchani_tpu`` to an NVIDIA H100.

Models are ``torch.nn.Module``s, everything else plain functions on tensors.
Published-scheme weights load through `convert` (``models.*(pretrained=True)``
reads them from `paths.state_dicts_dir`); `grad` gives forces, Hessians,
vibrational analysis, ensemble forces and stress; MD runs NVE, Langevin,
Nose-Hoover, Berendsen NPT and RESPA multiple-timestep dynamics and records
trajectories.  On top of MD: `observables` (RDF, MSD, diffusion, VACF),
`optimize` (FIRE), `neb` (nudged elastic band), `replica` (parallel
tempering); the user surface is `io` (xyz, pdb), `ase` (an ASE calculator)
and `cli` (``ani-tpu-torch sp|md|opt``).  `ANIq` models (`models.ANImbis`,
`simple_aniq`) also predict atomic charges, normalized by `electro`, which
computes dipoles too; `potentials` holds the pair potentials (xTB and ZBL
repulsion, D3 dispersion, Lennard-Jones, fixed-charge Coulomb and MNOK).
Entry points run on CUDA unless the caller passes ``device="cpu"``; without a
CUDA device such a call raises.  The angular AEV (forward, backward and the
backward's own backward, for second derivatives), the
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
    ase,
    bucket_refresh,
    bucket_refresh_packed,
    cli,
    constants,
    convert,
    cutoffs,
    electro,
    grad,
    interop,
    io,
    legacy_data,
    md,
    models,
    neb,
    neighbors,
    neurochem,
    nn,
    observables,
    optimize,
    paths,
    potentials,
    replica,
    sae,
    testing,
    tuples,
    units,
    utils,
)
from torchani_tpu_torch.aev import AEVComputer  # noqa: E402
from torchani_tpu_torch.arch import ANI, ANIq, Assembler, simple_ani, simple_aniq  # noqa: E402
from torchani_tpu_torch.grad import (  # noqa: E402
    energies_and_forces,
    force_qbc,
    hessians,
    members_energies_and_forces,
    single_point,
    stress_fdotr,
    stress_scaling,
    vibrational_analysis,
)
from torchani_tpu_torch.md import (  # noqa: E402
    CachedSinglePoint,
    MDState,
    MolecularDynamics,
    MTSState,
    MultipleTimestepMD,
    kinetic_temperature,
    maxwell_boltzmann_velocities,
)
from torchani_tpu_torch.neb import NEBState, neb_path  # noqa: E402
from torchani_tpu_torch.nn import (  # noqa: E402
    ANIModel,
    ANINetworks,
    AtomicNetworks,
    Ensemble,
    SpeciesConverter,
)
from torchani_tpu_torch.optimize import (  # noqa: E402
    FireState,
    minimize_fire,
    minimize_fire_batched,
)
from torchani_tpu_torch.replica import ReplicaExchange, ReplicaState  # noqa: E402
from torchani_tpu_torch.sae import EnergyShifter, SelfEnergy  # noqa: E402

__all__ = [
    "AEVComputer",
    "ANI",
    "ANIModel",
    "ANINetworks",
    "ANIq",
    "Assembler",
    "AtomicNetworks",
    "CachedSinglePoint",
    "Ensemble",
    "FireState",
    "MDState",
    "MTSState",
    "MolecularDynamics",
    "MultipleTimestepMD",
    "NEBState",
    "ReplicaExchange",
    "ReplicaState",
    "EnergyShifter",
    "SelfEnergy",
    "SpeciesConverter",
    "energies_and_forces",
    "force_qbc",
    "hessians",
    "kinetic_temperature",
    "maxwell_boltzmann_velocities",
    "members_energies_and_forces",
    "minimize_fire",
    "minimize_fire_batched",
    "neb_path",
    "simple_ani",
    "simple_aniq",
    "single_point",
    "stress_fdotr",
    "stress_scaling",
    "vibrational_analysis",
    "aev",
    "ase",
    "bucket_refresh",
    "bucket_refresh_packed",
    "cli",
    "constants",
    "convert",
    "cutoffs",
    "electro",
    "grad",
    "interop",
    "io",
    "legacy_data",
    "md",
    "models",
    "neb",
    "neighbors",
    "neurochem",
    "nn",
    "observables",
    "optimize",
    "paths",
    "potentials",
    "replica",
    "sae",
    "testing",
    "tuples",
    "units",
    "utils",
]
