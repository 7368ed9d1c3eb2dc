"""The weight bridge: load a JAX model's arrays into the port's model.

The JAX package's `ANI` is a pytree whose leaves sit at paths such as
``.potentials['nnp'].neural_networks.weights[0]`` (as
``jax.tree_util.keystr`` writes them).  The port's modules mirror those
attribute names and layouts (``(E, S, in, out)`` weight stacks, ``(E, S,
out)`` biases, the AEV constants, the self energies), so each path resolves
to one parameter or buffer here.  This module reads only numpy arrays and
never imports JAX: the caller flattens the JAX model, e.g.::

    arrays = {jax.tree_util.keystr(p): np.asarray(x)
              for p, x in jax.tree_util.tree_flatten_with_path(jax_model)[0]}
"""

import re
import typing as tp

import numpy as np
import torch

__all__ = ["load_jax_arrays"]

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


def load_jax_arrays(
    model: torch.nn.Module, arrays: tp.Mapping[str, np.ndarray]
) -> torch.nn.Module:
    """Copy the JAX model's leaves into ``model`` (in place; returned).

    Every path must resolve to a tensor of the same shape, and every
    parameter and buffer of ``model`` must receive a value.
    """
    loaded = set()
    with torch.no_grad():
        for path, value in arrays.items():
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
