"""Model factories (counterpart of ``torchani_tpu/models.py``).

`ANI2x` builds the architecture of the published model with random weights
drawn from ``seed``.  Loading published weights (``pretrained=True``) needs
the state-dict converter, which the port does not have yet; the JAX model's
weights can be carried over with `torchani_tpu_torch.interop.load_jax_arrays`.
"""

import typing as tp

from torchani_tpu_torch.annotations import DeviceArg
from torchani_tpu_torch.arch import ANI, Assembler
from torchani_tpu_torch.utils import SYMBOLS_2X

__all__ = ["ANI2x"]


def ANI2x(
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """ANI-2x: HCNOSFCl, wB97X/6-31G(d), 8-member ensemble, AEV of 1008,
    cosine cutoff.  ``model_index`` keeps that one member only, as an
    `AtomicNetworks`."""
    if pretrained:
        raise NotImplementedError(
            "pretrained weights need the state-dict converter, which the "
            "PyTorch port does not have yet; pass pretrained=False"
        )
    asm = Assembler()
    asm.set_symbols(SYMBOLS_2X)
    asm.set_global_cutoff_fn("cosine")
    asm.set_aev_computer(radial="ani2x", angular="ani2x")
    asm.set_gsaes_as_self_energies("wb97x-631gd")
    model = asm.assemble(8, seed=seed, device=device)
    if model_index is not None:
        nnp = model.potentials["nnp"]
        nnp.neural_networks = nnp.neural_networks.member(model_index)
    return model
