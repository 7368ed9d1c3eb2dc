"""Atomic networks, ensembles and species conversion."""

from torchani_tpu_torch.nn.containers import (
    AtomicNetworks,
    AtomicNetworksDiscardFirstScalar,
    Ensemble,
    GenericEnsemble,
    SpeciesConverter,
    parse_activation,
)
from torchani_tpu_torch.nn.shared import ANISharedNetworks, SingleNN

__all__ = [
    "ANISharedNetworks",
    "AtomicNetworks",
    "AtomicNetworksDiscardFirstScalar",
    "Ensemble",
    "GenericEnsemble",
    "SingleNN",
    "SpeciesConverter",
    "parse_activation",
]
