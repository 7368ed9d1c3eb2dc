"""Model factories (counterpart of ``torchani_tpu/models.py``).

Each factory builds the architecture of the published model with random
weights drawn from ``seed``.  With ``pretrained=True`` it then loads
``{name}_state_dict.npz`` or ``.pt`` from `torchani_tpu_torch.paths.state_dicts_dir`
through `torchani_tpu_torch.convert.load_state_dict`; there is no download
path, so a missing file raises `FileNotFoundError`.
"""

import typing as tp

import numpy as np

import torch

from torchani_tpu_torch.annotations import DeviceArg
from torchani_tpu_torch.arch import ANI, ANIq, Assembler, simple_ani
from torchani_tpu_torch.electro import ChargeNormalizer
from torchani_tpu_torch.nn import AtomicNetworksDiscardFirstScalar
from torchani_tpu_torch.paths import state_dicts_dir
from torchani_tpu_torch.potentials import SeparateChargesNNPotential
from torchani_tpu_torch.utils import SYMBOLS_1X, SYMBOLS_2X, SYMBOLS_2X_ZNUM_ORDER

__all__ = [
    "ANI1x",
    "ANI1ccx",
    "ANI2x",
    "ANI2xr",
    "ANI2dr",
    "ANIdr",
    "ANImbis",
    "ANIr2s",
    "ANIr2s_water",
    "ANIr2s_chcl3",
    "ANIr2s_ch3cn",
    "SnnANI2xr",
]


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


def ANImbis(
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANIq:
    """ANI-mbis: ANI-2x's AEV and energy networks (with the same ``seed``,
    equal to `ANI2x`'s) and MBIS atomic charges from like-2x charge networks
    with a head of two whose first output is discarded (gelu, no bias; their
    own generator, seed ``seed + 7``), normalized with (chi / eta)^2 weights
    scaled by q^2."""
    base = _base_assembler(SYMBOLS_2X, "ani2x", "ani2x", "wb97x-631gd").assemble(
        8, seed=seed, device=device
    )
    nnp = base.potentials["nnp"]
    charge_networks = AtomicNetworksDiscardFirstScalar.like_2x(
        SYMBOLS_2X, nnp.aev_computer.out_dim, out_dim=2, activation="gelu", bias=False,
        generator=torch.Generator().manual_seed(seed + 7), device=base.device,
    )
    normalizer = ChargeNormalizer.from_electronegativity_and_hardness(
        SYMBOLS_2X, scale_weights_by_charges_squared=True, device=base.device
    )
    potentials = dict(base.potentials)
    potentials["nnp"] = SeparateChargesNNPotential(
        SYMBOLS_2X, nnp.aev_computer, nnp.neural_networks, charge_networks, normalizer
    )
    model = ANIq(
        potentials=potentials, energy_shifter=base.energy_shifter, symbols=base.symbols,
        neighborlist=base.neighborlist, periodic_table_index=base.periodic_table_index,
    )
    return _finish(model, "animbis", pretrained, model_index)


#: the level of theory of each ANI-r2s solvent
_R2S_LOTS = {
    "vacuum": "r2scan3c-def2mtzvpp",
    "water": "r2scan3c_water-def2mtzvpp",
    "chcl3": "r2scan3c_chcl3-def2mtzvpp",
    "ch3cn": "r2scan3c_ch3cn-def2mtzvpp",
}


def ANIr2s(
    solvent: str = "water",
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """ANI-r2s, r2SCAN-3c in an implicit solvent (``"water"``, ``"chcl3"``,
    ``"ch3cn"``) or in vacuum: `simple_ani` with ANI-2x's AEV (0.8 / 5.1 A),
    the smooth cutoff, and xTB repulsion without an envelope, so the model's
    cutoff is infinite and its neighbor list all pairs; 8 members."""
    if solvent not in _R2S_LOTS:
        raise ValueError(f"Unsupported solvent {solvent!r}; options {sorted(_R2S_LOTS)}")
    model = simple_ani(
        SYMBOLS_2X, _R2S_LOTS[solvent], ensemble_size=8, repulsion=True,
        repulsion_cutoff=False, cutoff_fn="smooth", radial_start=0.8, angular_start=0.8,
        radial_cutoff=5.1, seed=seed, device=device,
    )
    return _finish(model, f"anir2s_{solvent}", pretrained, model_index)


def ANIr2s_water(model_index=None, pretrained: bool = False, seed: int = 0,
                 device: DeviceArg = None) -> ANI:
    """ANI-r2s in implicit water."""
    return ANIr2s("water", model_index, pretrained, seed, device)


def ANIr2s_chcl3(model_index=None, pretrained: bool = False, seed: int = 0,
                 device: DeviceArg = None) -> ANI:
    """ANI-r2s in implicit chloroform."""
    return ANIr2s("chcl3", model_index, pretrained, seed, device)


def ANIr2s_ch3cn(model_index=None, pretrained: bool = False, seed: int = 0,
                 device: DeviceArg = None) -> ANI:
    """ANI-r2s in implicit acetonitrile."""
    return ANIr2s("ch3cn", model_index, pretrained, seed, device)


def SnnANI2xr(
    model_index: tp.Optional[int] = None,
    pretrained: bool = False,
    seed: int = 0,
    device: DeviceArg = None,
) -> ANI:
    """SingleNN ANI-2xr: an 8-member `GenericEnsemble` of fully shared
    "large" networks (320 / 256 / 256 / 512, a species embedding of 10, one
    output column per element) over an AEV of 6 angular sections (1,456
    features), xTB repulsion, the ANI-2x elements in atomic-number order."""
    model = simple_ani(
        SYMBOLS_2X_ZNUM_ORDER, "wb97x-631gd", ensemble_size=8, container="SingleNN",
        container_ctor="large", sections=6, seed=seed, device=device,
    )
    return _finish(model, "snnani2xr", pretrained, model_index)
