"""Model factories (counterpart of ``torchani_tpu/models.py``).

`ANI2x`, `ANI2xr` and `ANI2dr` build the architecture of the published
model with random weights drawn from ``seed``.  Loading published weights
(``pretrained=True``) needs the state-dict converter, which the port does not
have yet; the JAX model's weights can be carried over with
`torchani_tpu_torch.interop.load_jax_arrays`.
"""

import typing as tp

from torchani_tpu_torch.annotations import DeviceArg
from torchani_tpu_torch.arch import ANI, Assembler, simple_ani
from torchani_tpu_torch.utils import SYMBOLS_2X, SYMBOLS_2X_ZNUM_ORDER

__all__ = ["ANI2x", "ANI2xr", "ANI2dr", "ANIdr"]


def _check_pretrained(pretrained: bool) -> None:
    if pretrained:
        raise NotImplementedError(
            "pretrained weights need the state-dict converter, which the "
            "PyTorch port does not have yet; pass pretrained=False"
        )


def _select_member(model: ANI, model_index: tp.Optional[int]) -> ANI:
    if model_index is not None:
        nnp = model.potentials["nnp"]
        nnp.neural_networks = nnp.neural_networks.member(model_index)
    return model


def ANI2x(
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """ANI-2x: HCNOSFCl, wB97X/6-31G(d), 8-member ensemble, AEV of 1008,
    cosine cutoff.  ``model_index`` keeps that one member only, as an
    `AtomicNetworks`."""
    _check_pretrained(pretrained)
    asm = Assembler()
    asm.set_symbols(SYMBOLS_2X)
    asm.set_global_cutoff_fn("cosine")
    asm.set_aev_computer(radial="ani2x", angular="ani2x")
    asm.set_gsaes_as_self_energies("wb97x-631gd")
    return _select_member(asm.assemble(8, seed=seed, device=device), model_index)


def ANI2xr(
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """ANI-2xr: the `simple_ani` architecture (0.9/5.2 smooth-cutoff AEV,
    ANI-2x widths with gelu and no bias, xTB repulsion at the radial cutoff)
    over the ANI-2x elements in atomic-number order, 8-member ensemble."""
    _check_pretrained(pretrained)
    model = simple_ani(
        SYMBOLS_2X_ZNUM_ORDER, "wb97x-631gd", ensemble_size=8, seed=seed, device=device
    )
    return _select_member(model, model_index)


def ANI2dr(
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """ANI-2dr: the `simple_ani` architecture at the B973c level of theory
    with xTB repulsion AND D3(BJ) dispersion (functional "b973c", 8 A), the
    ANI-2x elements in atomic-number order, 8-member ensemble."""
    _check_pretrained(pretrained)
    model = simple_ani(
        SYMBOLS_2X_ZNUM_ORDER, "b973c-def2mtzvp", ensemble_size=8,
        dispersion=True, repulsion=True, seed=seed, device=device,
    )
    return _select_member(model, model_index)


#: this family is also referred to as ANI-dr
ANIdr = ANI2dr
