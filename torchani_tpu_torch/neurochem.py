"""Parsers for the original NeuroChem (ANI-1) file formats (counterpart of
``torchani_tpu/neurochem.py``).

Loads ``.params`` AEV constants, ``sae_linfit.dat`` self energies and the
bz2-compressed ``.nnf`` network specs with their ``.wparam``/``.bparam``
weight files (raw row-major f32, ``(out, in)``), as in the published
NeuroChem model-zoo directories, into the port's `AEVComputer`,
`AtomicNetworks`, `Ensemble` and `SelfEnergy`.

Every loader that builds a module takes ``device``: CUDA unless the caller
names another (`utils.resolve_device`).  The weights are read and
zero-padded into their per-layer stacks on the host (`convert._fill_stacks`,
the members stacked there too) and each stack moves to the device once.
Nothing is downloaded: the name resolvers read `paths.neurochem_dir` only.
"""

import bz2
import re
import struct as _struct
import typing as tp
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from torchani_tpu_torch.aev import AEVComputer
from torchani_tpu_torch.aev.terms import ANIAngular, ANIRadial
from torchani_tpu_torch.annotations import DeviceArg
from torchani_tpu_torch.arch import ANI
from torchani_tpu_torch.convert import _fill_stacks
from torchani_tpu_torch.nn import AtomicNetwork, AtomicNetworks, Ensemble
from torchani_tpu_torch.paths import neurochem_dir
from torchani_tpu_torch.potentials import NNPotential
from torchani_tpu_torch.sae import SelfEnergy
from torchani_tpu_torch.utils import resolve_device

__all__ = [
    "NeurochemParseError",
    "AEVConstants",
    "load_aev_constants_and_symbols",
    "load_aev_computer_and_symbols",
    "load_sae",
    "load_atomic_networks",
    "load_atomic_network",
    "load_member",
    "load_ensemble",
    "load_model_from_info",
    "load_model_from_info_file",
    "load_model_from_name",
    "modules_from_info",
    "modules_from_info_file",
    "modules_from_model_name",
    "model_dir_from_prefix",
    "download_model_parameters",
    "NeurochemInfo",
    "NeurochemLayerSpec",
]

#: one layer's ``(W (out, in), b (out,))``, as the files hold them
Layers = tp.List[tp.Tuple[np.ndarray, np.ndarray]]


class NeurochemParseError(RuntimeError):
    pass


@dataclass
class AEVConstants:
    radial_cutoff: float
    radial_eta: float
    radial_shifts: tp.Tuple[float, ...]
    angular_cutoff: float
    angular_eta: float
    angular_zeta: float
    angular_shifts: tp.Tuple[float, ...]
    sections: tp.Tuple[float, ...]


def _parse_bracket_list(value: str) -> tp.List[str]:
    return [x.strip() for x in value.replace("[", "").replace("]", "").split(",")]


def load_aev_constants_and_symbols(
    consts_file,
) -> tp.Tuple[AEVConstants, tp.Tuple[str, ...]]:
    """Parse a ``.params`` AEV-constants file (e.g. ``rHCNO-5.2R_16-...params``)."""
    floats: tp.Dict[str, float] = {}
    seqs: tp.Dict[str, tp.Tuple[float, ...]] = {}
    symbols: tp.Tuple[str, ...] = ()
    try:
        with open(consts_file, "rt") as f:
            for raw in f:
                if "=" not in raw:
                    continue
                name, value = (x.strip() for x in raw.split("=", 1))
                if name in ("Rcr", "Rca"):
                    floats[name] = float(value)
                elif name in ("EtaR", "Zeta", "EtaA"):
                    vals = [float(x) for x in _parse_bracket_list(value)]
                    if len(vals) != 1:
                        raise NeurochemParseError(f"Only single {name} supported, got {vals}")
                    floats[name] = vals[0]
                elif name in ("ShfR", "ShfZ", "ShfA"):
                    seqs[name] = tuple(float(x) for x in _parse_bracket_list(value))
                elif name == "Atyp":
                    symbols = tuple(_parse_bracket_list(value))
    except NeurochemParseError:
        raise
    except Exception as e:
        raise NeurochemParseError(f"Unable to parse const file {consts_file}") from e
    return (
        AEVConstants(
            radial_cutoff=floats["Rcr"],
            radial_eta=floats["EtaR"],
            radial_shifts=seqs["ShfR"],
            angular_cutoff=floats["Rca"],
            angular_eta=floats["EtaA"],
            angular_zeta=floats["Zeta"],
            angular_shifts=seqs["ShfA"],
            sections=seqs["ShfZ"],
        ),
        symbols,
    )


def load_aev_computer_and_symbols(
    consts_file, cutoff_fn: str = "cosine", device: DeviceArg = None, **kwargs
) -> tp.Tuple[AEVComputer, tp.Tuple[str, ...]]:
    """An `AEVComputer` (ANI radial and angular terms) from a ``.params``
    file, and its symbols; ``kwargs`` go to `AEVComputer.make`."""
    dev = resolve_device(device)
    c, symbols = load_aev_constants_and_symbols(consts_file)
    aev = AEVComputer.make(
        ANIRadial(c.radial_eta, c.radial_shifts, c.radial_cutoff, cutoff_fn, dev),
        ANIAngular(
            c.angular_eta, c.angular_zeta, c.angular_shifts, c.sections,
            c.angular_cutoff, cutoff_fn, dev,
        ),
        num_species=len(symbols),
        cutoff_fn=cutoff_fn,
        device=dev,
        **kwargs,
    )
    return aev, symbols


def load_sae(filename, device: DeviceArg = None) -> SelfEnergy:
    """Parse a NeuroChem ``sae_linfit.dat`` self-energy file: lines
    ``symbol,index=value``, ordered by the index."""
    dev = resolve_device(device)
    entries = []
    with open(Path(filename), "rt", encoding="utf-8") as f:
        for raw in f:
            if "=" not in raw:
                continue
            left, value = (x.strip() for x in raw.split("=", 1))
            symbol, idx = (x.strip() for x in left.split(","))
            entries.append((int(idx), symbol, float(value)))
    entries.sort()
    return SelfEnergy([s for _, s, _ in entries], [e for _, _, e in entries], dev)


@dataclass
class _LayerSpec:
    nodes: int
    activation: int
    weights: str
    weight_numel: int
    biases: str
    bias_numel: int


#: The reference's name of the ``.nnf`` layer spec
NeurochemLayerSpec = _LayerSpec


def _decompress_nnf(buffer_: bytes) -> str:
    """The text of an ``.nnf`` file: everything before the first ``=`` and
    the 2 bytes after it are a header, and the bz2 payload's last byte is
    dropped (NeuroChem's layout, kept byte for byte)."""
    while buffer_ and buffer_[0] != ord("="):
        buffer_ = buffer_[1:]
    buffer_ = buffer_[2:]
    return bz2.decompress(buffer_)[:-1].decode("ascii").strip()


def _parse_nnf(nnf_str: str) -> tp.List[_LayerSpec]:
    """Parse the (decompressed) ``.nnf`` layer specs: ``layer [ key=value;
    ... ]`` blocks giving ``nodes``, ``activation`` and the FILE references
    to the weight and bias blobs with their element counts."""
    specs: tp.List[_LayerSpec] = []
    blocks = nnf_str.replace("\n", "").replace("$", "").split("layer")[1:]
    for block in blocks:
        fields: tp.Dict[str, str] = {}
        for m in re.finditer(r"(\w+)\s*=\s*(FILE:\s*[^;]+|[^;\]]+);", block):
            fields[m.group(1)] = m.group(2).strip()
        files = re.findall(r"FILE:\s*([\w\.\-]+)\[(\d+)\]", block)
        wfile = bfile = ""
        wnum = bnum = 0
        for fname, numel in files:
            if fname.endswith(".wparam"):
                wfile, wnum = fname, int(numel)
            elif fname.endswith(".bparam"):
                bfile, bnum = fname, int(numel)
        specs.append(
            _LayerSpec(
                nodes=int(fields["nodes"]),
                activation=int(fields.get("activation", -1)),
                weights=wfile,
                weight_numel=wnum,
                biases=bfile,
                bias_numel=bnum,
            )
        )
    return specs


def _load_param_file(path: Path, numel: int) -> np.ndarray:
    raw = path.read_bytes()
    return np.asarray(_struct.unpack(f"{numel}f", raw[: numel * 4]), dtype=np.float32)


def _activation_name(index: int) -> str:
    # NeuroChem's activation table: 9 = CELU(0.1), 6 = linear (output layer)
    if index == 9:
        return "celu"
    raise NeurochemParseError(f"Unsupported activation index {index}")


def _nnf_layers(
    nnf_path: Path, in_dim: tp.Optional[int] = None
) -> tp.Tuple[Layers, tp.Tuple[int, ...], str]:
    """``(layers, dims, activation)`` of one ``.nnf`` network: ``(out, in)``
    weights and biases, ``(in, hidden..., out)``.  ``in_dim`` defaults to
    the first layer's weight count over its nodes."""
    specs = _parse_nnf(_decompress_nnf(nnf_path.read_bytes()))
    prev = specs[0].weight_numel // specs[0].nodes if in_dim is None else in_dim
    layers: Layers = []
    dims = [prev]
    activation = "celu"
    for i, spec in enumerate(specs):
        w = _load_param_file(nnf_path.parent / spec.weights, spec.weight_numel)
        b = _load_param_file(nnf_path.parent / spec.biases, spec.bias_numel)
        layers.append((w.reshape(spec.nodes, prev), b))
        dims.append(spec.nodes)
        prev = spec.nodes
        if i < len(specs) - 1 and spec.activation >= 0:
            activation = _activation_name(spec.activation)
    return layers, tuple(dims), activation


def _member_stacks(
    network_dir, symbols: tp.Sequence[str], in_dim: int
) -> tp.Tuple[tp.List[np.ndarray], tp.List[np.ndarray], tp.Tuple[tp.Tuple[int, ...], ...], str]:
    """One member's zero-padded ``(S, in, out)`` weight and ``(S, out)``
    bias stacks (numpy), its per-symbol widths and its activation, from the
    ``ANN-{symbol}.nnf`` files of ``network_dir``."""
    network_dir = Path(network_dir)
    per_symbol: tp.Dict[str, Layers] = {}
    layer_dims = []
    activation = "celu"
    for sym in symbols:
        layers, dims, act = _nnf_layers(network_dir / f"ANN-{sym}.nnf", in_dim)
        per_symbol[sym] = layers
        layer_dims.append(dims)
        activation = act
    num_layers = len(layer_dims[0]) - 1
    if any(len(d) - 1 != num_layers for d in layer_dims):
        raise ValueError("All species must have the same number of layers")
    shapes = [
        (len(symbols), max(d[li] for d in layer_dims), max(d[li + 1] for d in layer_dims))
        for li in range(num_layers)
    ]
    wstacks, bstacks = _fill_stacks(
        shapes, layer_dims, symbols, per_symbol, f"{network_dir}/ANN-"
    )
    return wstacks, bstacks, tuple(layer_dims), activation


def _to_device(arrays: tp.Sequence[np.ndarray], dev: torch.device) -> tp.List[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def load_atomic_networks(
    network_dir, symbols: tp.Sequence[str], in_dim: int, device: DeviceArg = None
) -> AtomicNetworks:
    """One member's per-element networks from a ``networks/`` directory of
    ``ANN-{symbol}.nnf`` files and the ``.wparam``/``.bparam`` files they
    name, as in the published NeuroChem model zoo."""
    dev = resolve_device(device)
    w, b, dims, activation = _member_stacks(network_dir, symbols, in_dim)
    return AtomicNetworks(_to_device(w, dev), _to_device(b, dev), dims, tuple(symbols), activation)


def load_member(
    model_dir, consts_file, device: DeviceArg = None
) -> tp.Tuple[AEVComputer, AtomicNetworks, tp.Tuple[str, ...]]:
    """``(aev_computer, networks, symbols)`` of one ensemble member's
    directory."""
    dev = resolve_device(device)
    aev, symbols = load_aev_computer_and_symbols(consts_file, device=dev)
    networks = load_atomic_networks(Path(model_dir) / "networks", symbols, aev.out_dim, dev)
    return aev, networks, symbols


def model_dir_from_prefix(prefix, idx: int) -> Path:
    """The ``networks`` directory of the ``idx``-th ensemble member."""
    prefix = Path(prefix)
    return (prefix.parent / f"{prefix.name}{idx}") / "networks"


def _ensemble(
    member_dirs: tp.Sequence[Path], symbols: tp.Sequence[str], in_dim: tp.Optional[int],
    dev: torch.device,
) -> Ensemble:
    """The members' stacks, stacked on the host into ``(E, S, in, out)``
    and moved to ``dev`` once a layer.  ``in_dim`` None reads each member's
    from its first symbol's file."""
    members = []
    for d in member_dirs:
        d_in = in_dim
        if d_in is None:
            d_in = _nnf_layers(Path(d) / f"ANN-{symbols[0]}.nnf")[1][0]
        members.append(_member_stacks(d, symbols, d_in))
    first = members[0]
    if any(m[2] != first[2] for m in members[1:]):
        raise ValueError("All ensemble members must share an architecture")
    weights = [np.stack([m[0][li] for m in members]) for li in range(len(first[0]))]
    biases = [np.stack([m[1][li] for m in members]) for li in range(len(first[1]))]
    return Ensemble(
        _to_device(weights, dev), _to_device(biases, dev), first[2], tuple(symbols), first[3]
    )


def load_atomic_network(filename, device: DeviceArg = None) -> AtomicNetwork:
    """One element's MLP from a ``.nnf`` file as an `nn.AtomicNetwork`
    (``(in, out)`` weights, the transpose of the file's)."""
    dev = resolve_device(device)
    layers, _, activation = _nnf_layers(Path(filename))
    return AtomicNetwork(
        _to_device([w.T for w, _ in layers], dev), _to_device([b for _, b in layers], dev),
        activation,
    )


def load_ensemble(
    symbols: tp.Sequence[str], prefix, count: int, device: DeviceArg = None
) -> Ensemble:
    """An ensemble from the NeuroChem member directories ``{prefix}0`` ...
    ``{prefix}{count - 1}``."""
    dev = resolve_device(device)
    return _ensemble(
        [model_dir_from_prefix(prefix, i) for i in range(count)], symbols, None, dev
    )


@dataclass
class NeurochemInfo:
    """The paths that a NeuroChem ``.info`` file names: the ``.params``
    constants, the ``sae_linfit.dat`` self energies, the ensemble prefix,
    and the ensemble size."""

    const: Path
    sae: Path
    ensemble_prefix: Path
    ensemble_size: int

    @classmethod
    def from_info_file(cls, info_file_path) -> "NeurochemInfo":
        info_file_path = Path(info_file_path)
        lines = [
            ln.strip() for ln in info_file_path.read_text().splitlines() if ln.strip()
        ][:4]
        root = info_file_path.parent
        return cls(
            const=root / lines[0],
            sae=root / lines[1],
            ensemble_prefix=root / lines[2],
            ensemble_size=int(lines[3]),
        )


def load_model_from_info(
    info_file, model_index: tp.Optional[int] = None, device: DeviceArg = None
) -> ANI:
    """An `ANI` model (one `NNPotential`, the self energies) from a
    NeuroChem ``.info`` file; ``model_index`` keeps that member only, as an
    `AtomicNetworks` (so does an ensemble of one)."""
    dev = resolve_device(device)
    info = NeurochemInfo.from_info_file(info_file)
    aev, symbols = load_aev_computer_and_symbols(info.const, device=dev)
    shifter = load_sae(info.sae, dev)
    idxs = range(info.ensemble_size) if model_index is None else [model_index]
    dirs = [model_dir_from_prefix(info.ensemble_prefix, i) for i in idxs]
    if len(dirs) == 1:
        networks: Ensemble = load_atomic_networks(dirs[0], symbols, aev.out_dim, dev)
    else:
        networks = _ensemble(dirs, symbols, aev.out_dim, dev)
    return ANI(
        potentials={"nnp": NNPotential(symbols, aev, networks)},
        energy_shifter=shifter,
        symbols=tuple(symbols),
    )


def load_model_from_info_file(
    info_file, model_index: tp.Optional[int] = None, device: DeviceArg = None
) -> ANI:
    """The reference's name of `load_model_from_info`."""
    return load_model_from_info(info_file, model_index, device)


def modules_from_info(
    info: NeurochemInfo,
    model_index: tp.Optional[int] = None,
    strategy: str = "auto",
    device: DeviceArg = None,
):
    """``(aev_computer, networks, self_energy, symbols)`` of a parsed
    ``.info``: the whole ensemble, or member ``model_index`` alone.
    ``strategy`` is the computer's (``"auto"``, ``"plain"`` or ``"cuda"``)."""
    dev = resolve_device(device)
    aev, symbols = load_aev_computer_and_symbols(info.const, device=dev, strategy=strategy)
    shifter = load_sae(info.sae, dev)
    if model_index is None:
        container = load_ensemble(symbols, info.ensemble_prefix, info.ensemble_size, dev)
    else:
        member = model_dir_from_prefix(info.ensemble_prefix, model_index)
        in_dim = _nnf_layers(member / f"ANN-{symbols[0]}.nnf")[1][0]
        container = load_atomic_networks(member, symbols, in_dim, dev)
    return aev, container, shifter, symbols


def modules_from_info_file(
    info_file,
    model_index: tp.Optional[int] = None,
    strategy: str = "auto",
    device: DeviceArg = None,
):
    """`modules_from_info` over a ``.info`` file's path."""
    dev = resolve_device(device)
    return modules_from_info(NeurochemInfo.from_info_file(info_file), model_index, strategy, dev)


def download_model_parameters(root=None, verbose: bool = True) -> None:
    """There is no download path: place the ani-model-zoo files under
    `paths.neurochem_dir` (or ``root``).  Returns where files are present,
    raises `RuntimeError` where none are."""
    root = Path(root) if root is not None else neurochem_dir()
    if root.exists() and any(root.iterdir()):
        if verbose:
            print("Found existing files in directory, assuming params present")
        return
    raise RuntimeError(
        "download_model_parameters is unavailable in this environment (no "
        f"network egress). Place the ani-model-zoo files under {root} instead."
    )


def _info_candidates(name: str) -> tp.List[Path]:
    root = neurochem_dir()
    return [
        root / f"{name}.info",
        root / name / f"{name}.info",
        root / "ani-model-zoo-ani-2x" / "resources" / f"{name}.info",
    ]


def modules_from_model_name(
    name: str, model_index: tp.Optional[int] = None, device: DeviceArg = None
):
    """`modules_from_info_file` of a published model name (e.g.
    ``ani-2x_8x``) found under `paths.neurochem_dir`."""
    for c in _info_candidates(name):
        if c.is_file():
            return modules_from_info_file(c, model_index, device=device)
    raise FileNotFoundError(
        f"No NeuroChem info file for {name!r} under {neurochem_dir()} (no network "
        "egress; place the ani-model-zoo files there manually)"
    )


def load_model_from_name(
    name: str, model_index: tp.Optional[int] = None, device: DeviceArg = None
) -> ANI:
    """`load_model_from_info` of a published model name found under
    `paths.neurochem_dir`."""
    for c in _info_candidates(name):
        if c.is_file():
            return load_model_from_info(c, model_index, device)
    raise FileNotFoundError(f"No NeuroChem info file for {name!r} under {neurochem_dir()}")
