"""The weight and state bridge: load a JAX model's arrays into the port's
model, and a JAX MD state's arrays into the port's `MDState`.

The JAX package's `ANI` is a pytree whose leaves sit at paths such as
``.potentials['nnp'].neural_networks.weights[0]`` (as
``jax.tree_util.keystr`` writes them).  The port's modules mirror those
attribute names and layouts (``(E, S, in, out)`` weight stacks, ``(E, S,
out)`` biases, the AEV constants, the self energies), so each path resolves
to one parameter or buffer here; so do the constant tables of the pair
potentials (``.potentials['dispersion_d3'].precalc_coeff6``, ``.eps``,
``.sigma``, ``.charges``, ``.eta``, ...), which the port builds from its own
resources, an `ANIq`'s charge networks and normalizer
(``.potentials['nnp'].charge_networks.weights[0]``,
``.charge_normalizer.weights``) and a stacked `GenericEnsemble`
(``.neural_networks.stacked.weights[0]``, ``.stacked.embedding``).  This module reads only numpy arrays and
never imports JAX: the caller flattens the JAX model, e.g.::

    arrays = {jax.tree_util.keystr(p): np.asarray(x)
              for p, x in jax.tree_util.tree_flatten_with_path(jax_model)[0]}

The JAX package keeps some settings as static fields, which are no leaves:
the count-class angular split, the angular capacity and the networks'
species partition.  A caller carries them by adding their paths with
integer arrays, e.g.
``arrays[".potentials['nnp'].aev_computer.angular_split"] = np.asarray(
jax_model.potentials['nnp'].aev_computer.angular_split)`` (an empty array
for None), and `load_jax_arrays` sets them.

The JAX package's ``MDState`` flattens the same way (leaves ``.coords``,
``.nbr_idx``, ``.bucket.keys`` or ``.bucket.keys_flat``,
``.pair_aux['dispersion_d3']``, ...), and `load_jax_md_state` puts the
port's `MolecularDynamics` on that cached topology, so that the two can be
compared lane for lane.
"""

import re
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg
from torchani_tpu_torch.bucket_refresh import BucketTables
from torchani_tpu_torch.bucket_refresh_packed import PackedTables
from torchani_tpu_torch.md import MDState
from torchani_tpu_torch.utils import resolve_device

__all__ = ["load_jax_arrays", "load_jax_md_state"]

_TOKEN = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def _resolve(model: torch.nn.Module, path: str) -> torch.Tensor:
    obj: tp.Any = model
    pos = 0
    for m in _TOKEN.finditer(path):
        if m.start() != pos:
            break
        attr, key, index = m.groups()
        try:
            if attr is not None:
                obj = getattr(obj, attr)
            elif key is not None:
                obj = obj[key]
            else:
                obj = obj[int(index)]
        except (AttributeError, KeyError, IndexError, TypeError):
            raise KeyError(f"path {path!r} names no tensor of the port's model") from None
        pos = m.end()
    if pos != len(path) or not isinstance(obj, torch.Tensor):
        raise KeyError(f"path {path!r} names no tensor of the port's model")
    return obj


#: static fields of the JAX model that a caller may carry over (see the
#: module docs), each a tuple of ints or None, but ``angular_capacity``, an
#: int or None
_STATIC_FIELDS = ("angular_split", "partition", "angular_capacity")
_STATIC_PATH = re.compile(r"(.*)\.(" + "|".join(_STATIC_FIELDS) + r")")


def _set_static(model: torch.nn.Module, path: str, value) -> None:
    """Set the static field that ``path`` names from an integer array."""
    m = _STATIC_PATH.fullmatch(path)
    owner: tp.Any = model
    for t in _TOKEN.finditer(m.group(1)):
        attr, key, index = t.groups()
        if attr is not None:
            owner = getattr(owner, attr)
        else:
            owner = owner[key if key is not None else int(index)]
    if not hasattr(owner, m.group(2)):
        raise KeyError(f"path {path!r} names no field of the port's model")
    value = np.asarray(value).reshape(-1)
    if not value.size:
        setattr(owner, m.group(2), None)
    elif m.group(2) == "angular_capacity":
        setattr(owner, m.group(2), int(value.item()))
    else:
        setattr(owner, m.group(2), tuple(int(x) for x in value))


def load_jax_arrays(
    model: torch.nn.Module, arrays: tp.Mapping[str, np.ndarray]
) -> torch.nn.Module:
    """Copy the JAX model's leaves into ``model`` (in place; returned), and
    the static fields that ``arrays`` carries (``angular_split``,
    ``partition``, ``angular_capacity``).

    Every path must resolve to a tensor of the same shape, and every
    parameter and buffer of ``model`` must receive a value.
    """
    loaded = set()
    with torch.no_grad():
        for path, value in arrays.items():
            if _STATIC_PATH.fullmatch(path):
                _set_static(model, path, value)
                continue
            target = _resolve(model, path)
            value = np.array(value)
            if tuple(target.shape) != value.shape:
                raise ValueError(
                    f"{path}: shape {value.shape} does not match the port's "
                    f"{tuple(target.shape)}"
                )
            target.copy_(torch.as_tensor(value, dtype=target.dtype))
            loaded.add(id(target))
    missing = [
        name
        for name, t in list(model.named_parameters()) + list(model.named_buffers())
        if id(t) not in loaded
    ]
    if missing:
        raise KeyError(f"no value given for {missing}")
    return model


#: leaves of the JAX ``MDState`` that the port's state has no field for: the
#: partner-lane map (the port's gather refresh needs none) and the PRNG key
_IGNORED_STATE_LEAVES = (".nbr_rev", ".key")
_STATE_DTYPES = {
    ".coords": torch.float32,
    ".velocities": torch.float32,
    ".forces": torch.float32,
    ".energy": torch.float32,
    ".nbr_idx": torch.int64,
    ".nbr_mask": torch.bool,
    ".nbr_shift": torch.float32,
    ".nbr_elem": torch.int64,
    ".ref_coords": torch.float32,
    ".overflow": torch.bool,
    ".nbr_perm": torch.int64,
    ".scale": torch.float32,
    ".nhc": torch.float32,
}
#: leaves that a JAX state carries only in some ensembles (NPT, Nose-Hoover)
_OPTIONAL_STATE_LEAVES = (".nbr_perm", ".scale", ".nhc")
_BUCKET_DTYPES = {
    "keys": torch.int32,
    "atom_of_slot": torch.int64,
    "slot_of_atom": torch.int64,
    "wrap_offset": torch.float32,
    "wrapshift": torch.float32,
}
_PACKED_DTYPES = {
    "keys_flat": torch.int32,
    "tile_bucket": torch.int32,
    "atom_of_row": torch.int64,
    "row_of_atom": torch.int64,
    "atom_of_slot": torch.int64,
    "slot_of_atom": torch.int64,
    "wrap_offset": torch.float32,
    "wrapshift": torch.float32,
}
_PAIR_AUX = re.compile(r"\.pair_aux\['([^']*)'\]")


def load_jax_md_state(
    arrays: tp.Mapping[str, np.ndarray], device: DeviceArg = None
) -> MDState:
    """The port's `MDState` from the leaves of a JAX ``MDState`` (numpy
    arrays keyed by ``jax.tree_util.keystr``): the cached topology, the
    bucket tables of either layout (`BucketTables` or `PackedTables`, told
    apart by their leaves) and the frozen pair channels ``pair_aux``.

    ``nbr_rev`` and ``key`` are ignored.  A JAX PRNG key does not carry
    over: the state has no Langevin generator (``generator`` is None), so
    `MolecularDynamics.step_langevin` needs one set with
    ``state.replace(generator=...)`` or its noise passed in.  The NPT cell
    scale ``scale`` and the Nose-Hoover chain ``nhc`` carry over where the
    JAX state has them.  A leaf that the port has no field for is refused.
    """
    dev = resolve_device(device)
    packed = ".bucket.keys_flat" in arrays
    bucket_dtypes = _PACKED_DTYPES if packed else _BUCKET_DTYPES
    known = set(_STATE_DTYPES) | {".rebuilds", ".step"} | set(_IGNORED_STATE_LEAVES)
    known |= {f".bucket.{name}" for name in bucket_dtypes}
    unknown = sorted(p for p in set(arrays) - known if not _PAIR_AUX.fullmatch(p))
    if unknown:
        raise KeyError(f"MD state leaves the port has no field for: {unknown}")

    def tensor(path: str, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.array(arrays[path]), device=dev).to(dtype).contiguous()

    fields = {
        path[1:]: tensor(path, dtype)
        for path, dtype in _STATE_DTYPES.items()
        if path in arrays
    }
    missing = [p for p in _STATE_DTYPES if p not in arrays and p not in _OPTIONAL_STATE_LEAVES]
    if missing:
        raise KeyError(f"no value given for {missing}")
    bucket = None
    if any(path.startswith(".bucket.") for path in arrays):
        tables = {name: tensor(f".bucket.{name}", dt) for name, dt in bucket_dtypes.items()}
        bucket = PackedTables(**tables) if packed else BucketTables(**tables)
    pair_aux = {
        m.group(1): tensor(path, torch.float32)
        for path in arrays
        if (m := _PAIR_AUX.fullmatch(path))
    }
    return MDState(
        **fields,
        rebuilds=int(arrays[".rebuilds"]),
        step=int(arrays[".step"]),
        bucket=bucket,
        pair_aux=pair_aux or None,
    )
