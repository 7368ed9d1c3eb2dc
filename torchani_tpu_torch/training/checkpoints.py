"""Checkpoint and resume (counterpart of
``torchani_tpu/training/checkpoints.py``).

`save_checkpoint` writes a training state (a `TrainState`, or any tuple,
list or dict of states, modules, optimizers, tensors and numbers) with
``torch.save`` under ``directory/step_{N:010d}/state.pt``, the JAX
package's directory layout, keeping the newest ``keep`` steps.  Modules and
optimizers are saved as their state dicts and load back into the caller's
template in place, on the template's device: a checkpoint written on the
card resumes on the CPU and back.  `merge_members` and `merge_state_dicts`
combine single-model networks or state-dict files into an ensemble.
"""

import dataclasses
import shutil
import typing as tp
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
    "merge_members",
    "merge_state_dicts",
]

_FILE = "state.pt"


def _saveable(obj: tp.Any) -> tp.Any:
    """``obj`` as plain containers of tensors and numbers (``torch.load``'s
    ``weights_only`` mode reads them back)."""
    if isinstance(obj, torch.nn.Module):
        return {k: v.detach().cpu() for k, v in obj.state_dict().items()}
    if isinstance(obj, torch.optim.Optimizer):
        return _to_cpu(obj.state_dict())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _saveable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [_saveable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _saveable(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, np.ndarray):
        return torch.as_tensor(obj)
    return obj


def _to_cpu(obj: tp.Any) -> tp.Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_cpu(x) for x in obj)
    return obj


def _restore(template: tp.Any, saved: tp.Any) -> tp.Any:
    """``saved`` in ``template``'s structure: modules and optimizers of the
    template take their state in place (on their own device), tensors go to
    the template tensor's device."""
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(saved)
        return template
    if isinstance(template, torch.optim.Optimizer):
        template.load_state_dict(saved)
        return template
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _restore(getattr(template, f.name), saved[f.name])
            for f in dataclasses.fields(template)
        })
    if isinstance(template, (tuple, list)):
        if len(template) != len(saved):
            raise ValueError("checkpoint structure does not match the template")
        return type(template)(_restore(t, s) for t, s in zip(template, saved))
    if isinstance(template, dict):
        return {k: _restore(template[k], saved[k]) for k in template}
    if isinstance(template, torch.Tensor):
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return saved.numpy()
    return saved


def save_checkpoint(directory, state, step: int, keep: int = 3) -> Path:
    """Save ``state`` under ``directory/step_{N:010d}`` and prune all but
    the newest ``keep`` steps."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"step_{step:010d}"
    path.mkdir(exist_ok=True)
    torch.save(_saveable(state), path / _FILE)
    for old in sorted(directory.glob("step_*"))[:-keep]:
        shutil.rmtree(old)
    return path


def latest_step(directory) -> tp.Optional[int]:
    steps = sorted(Path(directory).glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def load_checkpoint(directory, template, step: tp.Optional[int] = None):
    """Restore a state saved by `save_checkpoint` into ``template``'s
    structure (the newest step unless ``step`` is given); None if the
    directory holds no checkpoint.  The template's modules and optimizers
    take the saved state in place, on the template's device."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    saved = torch.load(
        directory / f"step_{step:010d}" / _FILE, map_location="cpu", weights_only=True
    )
    return _restore(template, saved)


def merge_members(containers: tp.Sequence) -> "tp.Any":
    """Merge single-model networks into an `Ensemble` (checkpoint combine)."""
    from torchani_tpu_torch.nn import Ensemble

    return Ensemble.from_members(list(containers))


def merge_state_dicts(paths: tp.Iterable) -> tp.Dict[str, np.ndarray]:
    """Merge single-model state dicts into an ensemble state dict.

    ``neural_networks.*`` keys of the j-th (sorted) file become
    ``neural_networks.{j}.*``; every other key must agree in shape across
    the files and is taken from the first.  Accepts torch ``.pt`` files
    (through `torchani_tpu_torch.convert.load_torch_state_dict`, which also
    takes the lightning layout ``{"state_dict": {"model.*": ...}}``) or
    ``.npz`` files.
    """
    paths = sorted(Path(p) for p in paths)
    if any(not p.is_file() for p in paths):
        raise ValueError("All passed paths must be existing files with state dicts")
    merged: tp.Dict[str, np.ndarray] = {}
    for j, path in enumerate(paths):
        if path.suffix == ".npz":
            sd = dict(np.load(path))
        else:
            from torchani_tpu_torch.convert import load_torch_state_dict

            sd = load_torch_state_dict(path)
        for k, v in sd.items():
            if "neural_networks" in k:
                k = k.replace("neural_networks", f"neural_networks.{j}")
            elif j > 0:
                prev = merged.get(k)
                if prev is None or prev.shape != np.shape(v):
                    raise ValueError(f"Mismatched non-network key {k!r}")
                continue
            merged[k] = np.asarray(v)
    return merged
