"""Atomic networks, ensembles, species conversion, the building blocks and
the species-blocked evaluation."""

from torchani_tpu_torch.nn import partition
from torchani_tpu_torch.nn.containers import (
    ANINetworks,
    AtomicNetworks,
    AtomicNetworksDiscardFirstScalar,
    Ensemble,
    GenericEnsemble,
    SpeciesConverter,
    parse_activation,
)
from torchani_tpu_torch.nn.core import (
    AtomicContainer,
    AtomicEmbedding,
    AtomicNetwork,
    AtomicOneHot,
    BmmAtomicNetwork,
    BmmEnsemble,
    BmmLinear,
    MNPNetworks,
    Sequential,
    TightCELU,
)
from torchani_tpu_torch.nn.shared import ANISharedNetworks, SingleNN

#: The reference's other name of `AtomicNetworks`
ANIModel = AtomicNetworks

__all__ = [
    "ANIModel",
    "ANINetworks",
    "ANISharedNetworks",
    "AtomicContainer",
    "AtomicEmbedding",
    "AtomicNetwork",
    "AtomicNetworks",
    "AtomicNetworksDiscardFirstScalar",
    "AtomicOneHot",
    "BmmAtomicNetwork",
    "BmmEnsemble",
    "BmmLinear",
    "Ensemble",
    "GenericEnsemble",
    "MNPNetworks",
    "Sequential",
    "SingleNN",
    "SpeciesConverter",
    "TightCELU",
    "parse_activation",
    "partition",
]
