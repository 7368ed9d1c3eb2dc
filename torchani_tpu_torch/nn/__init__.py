"""Atomic networks, ensembles and species conversion."""

from torchani_tpu_torch.nn.containers import (
    AtomicNetworks,
    Ensemble,
    SpeciesConverter,
    parse_activation,
)

__all__ = ["AtomicNetworks", "Ensemble", "SpeciesConverter", "parse_activation"]
