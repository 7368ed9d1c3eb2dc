"""Weight conversion from the reference (torch) state-dict key scheme
(counterpart of ``torchani_tpu/convert.py``).

The reference stores models as flat state dicts with keys like
``potentials.nnp.neural_networks.members.{e}.atomics.{sym}.layers.{i}.weight``
holding each element's ``torch.nn.Linear`` layers at their own widths,
``(out, in)``.  This module loads such dicts (from ``.pt`` files through
`torch.load`, or from plain ``.npz``) into the port's model: each layer is
transposed to ``(in, out)`` and zero-padded into the ``(E, S, in, out)``
stacks of `torchani_tpu_torch.nn.Ensemble`.  `save_state_dict` writes the
port's model back in that scheme.
"""

import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.arch import ANI
from torchani_tpu_torch.nn import AtomicNetworks, Ensemble

__all__ = [
    "canonicalize_torch_keys",
    "load_torch_state_dict",
    "numpy_state_dict",
    "load_state_dict",
    "save_state_dict",
]

_AEV_PREFIX = "potentials.nnp.aev_computer."
_NETWORKS_PREFIX = "potentials.nnp.neural_networks."
_CHARGE_PREFIX = "potentials.nnp.charge_networks."
#: the AEV constants of the key scheme, as ``(term, buffer)``
_AEV_CONSTANTS = (
    ("radial", "eta"),
    ("radial", "shifts"),
    ("angular", "eta"),
    ("angular", "zeta"),
    ("angular", "shifts"),
    ("angular", "sections"),
)
#: the pair potentials' element-pair tables carried by the key scheme
_PAIR_TABLES = ("y_ab", "sqrt_alpha_ab", "k_rep_ab")

Layers = tp.List[tp.Tuple[np.ndarray, tp.Optional[np.ndarray]]]


def canonicalize_torch_keys(sd: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    """Apply the reference's backward-compatible key remaps to a flat state
    dict, so that a checkpoint of any vintage loads:

    - model level: numeric potential slots ``potentials.{0,1,2}.*`` become
      ``dispersion_d3`` / ``repulsion_xtb`` / ``nnp``, and bare
      ``aev_computer.*`` / ``neural_networks.*`` move under
      ``potentials.nnp.``;
    - network level: keys missing the ``atomics.`` segment gain it, and
      ``torch.nn.Sequential``-numbered layers (even indices are the Linear
      layers) become ``layers.{i}``, with index 6 the ``final_layer``.
    """
    even = [0, 2, 4, 6, 8]
    out: tp.Dict[str, tp.Any] = {}
    for k, v in sd.items():
        if k.startswith("potentials.0"):
            k = k.replace("potentials.0", "potentials.dispersion_d3", 1)
        elif k.startswith("potentials.1"):
            k = k.replace("potentials.1", "potentials.repulsion_xtb", 1)
        elif k.startswith("potentials.2"):
            k = k.replace("potentials.2", "potentials.nnp", 1)
        elif k.startswith("aev_computer") or k.startswith("neural_networks"):
            k = "potentials.nnp." + k
        for nn_name in ("neural_networks.", "charge_networks."):
            pos = k.find(nn_name)
            if pos < 0:
                continue
            head = k[: pos + len(nn_name)]
            parts = k[pos + len(nn_name):].split(".")
            i = 2 if parts[0] == "members" else 0
            if i < len(parts) and parts[i] != "atomics":
                parts.insert(i, "atomics")
            j = i + 2  # parts[i + 1] is the element symbol
            if j < len(parts) - 1 and parts[j].isdigit():
                n = int(parts[j])
                if n == 6:
                    parts[j] = "final_layer"
                else:
                    parts[j : j + 1] = ["layers", str(even.index(n))]
            k = head + ".".join(parts)
            break
        out[k] = v
    return out


def load_torch_state_dict(path) -> tp.Dict[str, np.ndarray]:
    """A ``.pt`` state dict as numpy arrays.  A lightning checkpoint's
    ``state_dict`` entry is unwrapped, keeping its ``model.*`` keys."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = {
            k[len("model."):]: v
            for k, v in sd["state_dict"].items()
            if k.startswith("model.")
        }
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def numpy_state_dict(module: torch.nn.Module) -> tp.Dict[str, np.ndarray]:
    """A module's own ``state_dict`` as numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def _f32(value: tp.Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, dtype=np.float32)


def _network_layers(
    sd: tp.Mapping[str, tp.Any], prefix: str, symbols: tp.Sequence[str]
) -> tp.Dict[str, Layers]:
    """Each symbol's ``[(W, b), ...]`` (reference layout, ``(out, in)``)
    under ``prefix``; the final layer last."""
    out: tp.Dict[str, Layers] = {}
    for sym in symbols:
        layers: Layers = []
        i = 0
        while f"{prefix}atomics.{sym}.layers.{i}.weight" in sd:
            name = f"{prefix}atomics.{sym}.layers.{i}"
            layers.append((_f32(sd[name + ".weight"]), sd.get(name + ".bias")))
            i += 1
        name = f"{prefix}atomics.{sym}.final_layer"
        if name + ".weight" not in sd:
            raise KeyError(f"the state dict has no {name}.weight")
        layers.append((_f32(sd[name + ".weight"]), sd.get(name + ".bias")))
        out[sym] = layers
    return out


def _fill_stacks(
    shapes: tp.Sequence[tp.Tuple[int, ...]],
    layer_dims: tp.Sequence[tp.Sequence[int]],
    symbols: tp.Sequence[str],
    per_symbol: tp.Mapping[str, Layers],
    what: str,
) -> tp.Tuple[tp.List[np.ndarray], tp.List[np.ndarray]]:
    """One member's ``(S, in, out)`` weight and ``(S, out)`` bias stacks of
    the given shapes, zero past each element's widths.  A layer wider than
    the element's widths in the model (``layer_dims``) raises: the port
    evaluates each element at those widths only."""
    num_layers = len(shapes)
    wstacks = [np.zeros(shape, dtype=np.float32) for shape in shapes]
    bstacks = [np.zeros((shape[0], shape[2]), dtype=np.float32) for shape in shapes]
    for si, sym in enumerate(symbols):
        layers = per_symbol[sym]
        if len(layers) != num_layers:
            raise ValueError(
                f"{what}{sym}: {len(layers)} layers in the state dict, the model has {num_layers}"
            )
        dims = layer_dims[si]
        for li, (w, b) in enumerate(layers):
            if w.ndim != 2 or w.shape[1] > dims[li] or w.shape[0] > dims[li + 1]:
                raise ValueError(
                    f"{what}{sym} layer {li}: weight {w.shape} is wider than the model's "
                    f"(out, in) = ({dims[li + 1]}, {dims[li]})"
                )
            wstacks[li][si, : w.shape[1], : w.shape[0]] = w.T
            if b is not None:
                bb = _f32(b)
                if bb.shape != (w.shape[0],):
                    raise ValueError(
                        f"{what}{sym} layer {li}: bias {bb.shape} does not match weight {w.shape}"
                    )
                bstacks[li][si, : bb.shape[0]] = bb
    return wstacks, bstacks


def _load_networks(networks: Ensemble, sd: tp.Mapping[str, tp.Any], prefix: str) -> None:
    """Fill ``networks`` (an `Ensemble`, or a single `AtomicNetworks`) in
    place; biases are read where the networks have them."""
    weights = networks._stacks()[0]  # (E, S, in, out) each
    if isinstance(networks, AtomicNetworks):
        members = [""]
    else:
        members = [f"members.{e}." for e in range(weights[0].shape[0])]
    shapes = [tuple(w.shape[1:]) for w in weights]
    new_w: tp.List[tp.List[np.ndarray]] = [[] for _ in weights]
    new_b: tp.List[tp.List[np.ndarray]] = [[] for _ in weights]
    for member in members:
        per_symbol = _network_layers(sd, prefix + member, networks.symbols)
        ws, bs = _fill_stacks(
            shapes, networks.layer_dims, networks.symbols, per_symbol, prefix + member + "atomics."
        )
        for li in range(len(weights)):
            new_w[li].append(ws[li])
            new_b[li].append(bs[li])
    params = list(zip(networks.weights, new_w))
    if networks.biases is not None:
        params += list(zip(networks.biases, new_b))
    with torch.no_grad():
        for param, stack in params:
            param.copy_(torch.as_tensor(np.stack(stack).reshape(tuple(param.shape))))


def _copy_into(target: torch.Tensor, value: tp.Any, key: str) -> None:
    arr = _f32(value)
    if arr.size != target.numel():
        raise ValueError(f"{key}: {arr.shape} does not match the model's {tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(torch.from_numpy(arr.reshape(tuple(target.shape)).copy()))


def load_state_dict(model: ANI, sd: tp.Mapping[str, tp.Any]) -> ANI:
    """Fill ``model`` (in place; returned) from a reference-scheme state
    dict of any vintage (keys pass through `canonicalize_torch_keys`).

    Loads the AEV constants, each member's per-element layers, the charge
    networks of an `ANIq` model (``potentials.nnp.charge_networks.*``, where
    the dict has them), the pair potentials' element-pair tables and the self
    energies.  A constant the dict lacks keeps the model's value; a network
    without its ``final_layer`` raises `KeyError`, and a layer wider than the
    model's stack `ValueError`.
    """
    sd = canonicalize_torch_keys(sd)
    nnp = model.potentials["nnp"]
    aev = nnp.aev_computer
    for term, name in _AEV_CONSTANTS:
        key = f"{_AEV_PREFIX}{term}.{name}"
        if key in sd:
            _copy_into(getattr(getattr(aev, term), name), sd[key], key)
    _load_networks(nnp.neural_networks, sd, _NETWORKS_PREFIX)
    charge_networks = getattr(nnp, "charge_networks", None)
    if charge_networks is not None and any(k.startswith(_CHARGE_PREFIX) for k in sd):
        _load_networks(charge_networks, sd, _CHARGE_PREFIX)
    for pname, pot in model.potentials.items():
        if pname == "nnp":
            continue
        for field in _PAIR_TABLES:
            key = f"potentials.{pname}.{field}"
            if key in sd and isinstance(getattr(pot, field, None), torch.Tensor):
                _copy_into(getattr(pot, field), sd[key], key)
    key = "energy_shifter.self_energies"
    if key in sd:
        _copy_into(model.energy_shifter.self_energies, sd[key], key)
    return model


def _network_arrays(networks: Ensemble, prefix: str) -> tp.Dict[str, np.ndarray]:
    """Each member's per-element layers at their own widths, ``(out, in)``."""
    weights, biases = networks._stacks()
    single = isinstance(networks, AtomicNetworks)
    out: tp.Dict[str, np.ndarray] = {}
    num_layers = len(weights)
    for e in range(weights[0].shape[0]):
        member = prefix if single else f"{prefix}members.{e}."
        for si, sym in enumerate(networks.symbols):
            dims = networks.layer_dims[si]
            for li in range(num_layers):
                name = (
                    f"{member}atomics.{sym}.final_layer"
                    if li == num_layers - 1
                    else f"{member}atomics.{sym}.layers.{li}"
                )
                w = weights[li][e, si, : dims[li], : dims[li + 1]]
                out[name + ".weight"] = w.detach().cpu().numpy().T.copy()
                if biases is not None:
                    b = biases[li][e, si, : dims[li + 1]]
                    out[name + ".bias"] = b.detach().cpu().numpy().copy()
    return out


def save_state_dict(model: ANI) -> tp.Dict[str, np.ndarray]:
    """The model as a flat dict of numpy arrays in the reference's key
    scheme: the inverse of `load_state_dict`."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().copy()

    sd = {"energy_shifter.self_energies": host(model.energy_shifter.self_energies)}
    nnp = model.potentials["nnp"]
    for term, name in _AEV_CONSTANTS:
        sd[f"{_AEV_PREFIX}{term}.{name}"] = host(getattr(getattr(nnp.aev_computer, term), name))
    sd.update(_network_arrays(nnp.neural_networks, _NETWORKS_PREFIX))
    charge_networks = getattr(nnp, "charge_networks", None)
    if charge_networks is not None:
        sd.update(_network_arrays(charge_networks, _CHARGE_PREFIX))
    for pname, pot in model.potentials.items():
        if pname == "nnp":
            continue
        for field in _PAIR_TABLES:
            if isinstance(getattr(pot, field, None), torch.Tensor):
                sd[f"potentials.{pname}.{field}"] = host(getattr(pot, field))
    return sd
