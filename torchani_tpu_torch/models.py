"""Model factories (counterpart of ``torchani_tpu/models.py``).

Each factory builds the architecture of the published model with random
weights drawn from ``seed``.  With ``pretrained=True`` it then loads
``{name}_state_dict.npz`` or ``.pt`` from `torchani_tpu_torch.paths.state_dicts_dir`
through `torchani_tpu_torch.convert.load_state_dict`; there is no download
path, so a missing file raises `FileNotFoundError`.
"""

import typing as tp

import numpy as np

from torchani_tpu_torch.annotations import DeviceArg
from torchani_tpu_torch.arch import ANI, Assembler, simple_ani
from torchani_tpu_torch.paths import state_dicts_dir
from torchani_tpu_torch.utils import SYMBOLS_1X, SYMBOLS_2X, SYMBOLS_2X_ZNUM_ORDER

__all__ = ["ANI1x", "ANI1ccx", "ANI2x", "ANI2xr", "ANI2dr", "ANIdr"]


def _finish(
    model: ANI, name: str, pretrained: bool, model_index: tp.Optional[int]
) -> ANI:
    """Load the pretrained weights of ``name`` if asked, then keep member
    ``model_index`` only (as an `AtomicNetworks`) if one is given."""
    if pretrained:
        from torchani_tpu_torch.convert import load_state_dict, load_torch_state_dict

        for ext in (".npz", ".pt"):
            path = state_dicts_dir() / f"{name}_state_dict{ext}"
            if not path.exists():
                continue
            if ext == ".pt":
                sd = load_torch_state_dict(path)
            else:
                with np.load(path) as data:
                    sd = {k: data[k] for k in data.files}
            load_state_dict(model, sd)
            break
        else:
            raise FileNotFoundError(
                f"No pretrained weights for {name!r} in {state_dicts_dir()} and this "
                "build has no download path. Pass pretrained=False for random init."
            )
    if model_index is not None:
        nnp = model.potentials["nnp"]
        nnp.neural_networks = nnp.neural_networks.member(model_index)
    return model


def _base_assembler(symbols, aev: str, networks: str, lot: str) -> Assembler:
    asm = Assembler()
    asm.set_symbols(symbols)
    asm.set_global_cutoff_fn("cosine")
    asm.set_aev_computer(radial=aev, angular=aev)
    asm.set_atomic_networks(ctor=networks)
    asm.set_gsaes_as_self_energies(lot)
    return asm


def ANI1x(
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """ANI-1x: HCNO, wB97X/6-31G(d), 8-member ensemble, AEV of 384, cosine
    cutoff.  ``model_index`` keeps that one member only."""
    asm = _base_assembler(SYMBOLS_1X, "ani1x", "ani1x", "wb97x-631gd")
    return _finish(asm.assemble(8, seed=seed, device=device), "ani1x", pretrained, model_index)


def ANI1ccx(
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """ANI-1ccx: ANI-1x's architecture, transfer-learned to CCSD(T)*/CBS,
    8-member ensemble."""
    asm = _base_assembler(SYMBOLS_1X, "ani1ccx", "ani1ccx", "ccsd(t)star-cbs")
    return _finish(asm.assemble(8, seed=seed, device=device), "ani1ccx", pretrained, model_index)


def ANI2x(
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """ANI-2x: HCNOSFCl, wB97X/6-31G(d), 8-member ensemble, AEV of 1008,
    cosine cutoff.  ``model_index`` keeps that one member only, as an
    `AtomicNetworks`."""
    asm = _base_assembler(SYMBOLS_2X, "ani2x", "ani2x", "wb97x-631gd")
    return _finish(asm.assemble(8, seed=seed, device=device), "ani2x", pretrained, model_index)


def ANI2xr(
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """ANI-2xr: the `simple_ani` architecture (0.9/5.2 smooth-cutoff AEV,
    ANI-2x widths with gelu and no bias, xTB repulsion at the radial cutoff)
    over the ANI-2x elements in atomic-number order, 8-member ensemble."""
    model = simple_ani(
        SYMBOLS_2X_ZNUM_ORDER, "wb97x-631gd", ensemble_size=8, seed=seed, device=device
    )
    return _finish(model, "ani2xr", pretrained, model_index)


def ANI2dr(
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """ANI-2dr: the `simple_ani` architecture at the B973c level of theory
    with xTB repulsion AND D3(BJ) dispersion (functional "b973c", 8 A), the
    ANI-2x elements in atomic-number order, 8-member ensemble."""
    model = simple_ani(
        SYMBOLS_2X_ZNUM_ORDER, "b973c-def2mtzvp", ensemble_size=8,
        dispersion=True, repulsion=True, seed=seed, device=device,
    )
    return _finish(model, "ani2dr", pretrained, model_index)


#: this family is also referred to as ANI-dr
ANIdr = ANI2dr
