"""Dataset curation filters (counterpart of
``torchani_tpu/datasets/filters.py``): find, and optionally delete,
conformers with large forces or large energy errors against a model.
"""

import typing as tp

import numpy as np

import torch

from torchani_tpu_torch.datasets.anidataset import ANIDataset

__all__ = ["filter_by_high_force", "filter_by_high_energy_error"]


def filter_by_high_force(
    dataset: ANIDataset,
    threshold: float = 2.0,  # Hartree / Angstrom
    delete: bool = False,
) -> tp.List[tp.Tuple[str, int]]:
    """Find (and optionally delete) conformers with |F| above threshold."""
    flagged: tp.List[tp.Tuple[str, int]] = []
    for name, group in dataset.items():
        if "forces" not in group:
            continue
        fmax = np.abs(np.asarray(group["forces"])).max(axis=(1, 2))
        for i in np.flatnonzero(fmax > threshold):
            flagged.append((name, int(i)))
    if delete:
        by_group: tp.Dict[str, tp.List[int]] = {}
        for name, i in flagged:
            by_group.setdefault(name, []).append(i)
        for name, idxs in by_group.items():
            dataset.delete_conformers(name, np.asarray(idxs))
    return flagged


def filter_by_high_energy_error(
    dataset: ANIDataset,
    model,
    threshold: float = 0.1,  # Hartree
    delete: bool = False,
    max_batch: int = 512,
) -> tp.List[tp.Tuple[str, int]]:
    """Find conformers whose model-vs-target energy error exceeds threshold.
    ``model`` is a port model; it runs on its own device, ``max_batch``
    conformers at a time."""
    flagged: tp.List[tp.Tuple[str, int]] = []
    for name, group in dataset.items():
        if "energies" not in group:
            continue
        species = np.asarray(group["species"])
        coords = np.asarray(group["coordinates"], dtype=np.float32)
        target = np.asarray(group["energies"], dtype=np.float64)
        preds = []
        with torch.no_grad():
            for b0 in range(0, species.shape[0], max_batch):
                e = model(species[b0: b0 + max_batch], coords[b0: b0 + max_batch])
                preds.append(e.cpu().numpy())
        err = np.abs(np.concatenate(preds).astype(np.float64) - target)
        for i in np.flatnonzero(err > threshold):
            flagged.append((name, int(i)))
    if delete:
        by_group: tp.Dict[str, tp.List[int]] = {}
        for name, i in flagged:
            by_group.setdefault(name, []).append(i)
        for name, idxs in by_group.items():
            dataset.delete_conformers(name, np.asarray(idxs))
    return flagged
