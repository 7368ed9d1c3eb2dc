"""Self-energy (SAE) estimation from datasets (counterpart of
``torchani_tpu/sae_estimation.py``, whose numpy code it copies): an exact
least-squares fit of per-element self energies from molecular energies (the
design matrix counts each element's atoms per molecule), and an SGD
approximation for datasets too large to accumulate.
"""

import typing as tp

import numpy as np

__all__ = ["exact_saes", "approx_saes"]


def _design_matrix(species: np.ndarray, num_species: int) -> np.ndarray:
    """Per-molecule species counts, shape (C, S); species are element idxs."""
    c = species.shape[0]
    counts = np.zeros((c, num_species), dtype=np.float64)
    for s in range(num_species):
        counts[:, s] = (species == s).sum(axis=1)
    return counts


def exact_saes(
    batches: tp.Iterable[tp.Dict[str, np.ndarray]],
    num_species: int,
    fit_intercept: bool = False,
) -> tp.Tuple[np.ndarray, float]:
    """Exact lstsq SAE fit over an iterable of batches.

    Batches need ``species`` (element indices, -1 padding) and ``energies``.
    Returns (self_energies (S,), intercept).
    """
    ata = np.zeros(
        (num_species + fit_intercept, num_species + fit_intercept),
        dtype=np.float64,
    )
    atb = np.zeros(num_species + fit_intercept, dtype=np.float64)
    for batch in batches:
        x = _design_matrix(np.asarray(batch["species"]), num_species)
        if fit_intercept:
            x = np.concatenate([x, np.ones((x.shape[0], 1))], axis=1)
        y = np.asarray(batch["energies"], dtype=np.float64)
        ata += x.T @ x
        atb += x.T @ y
    sol = np.linalg.lstsq(ata, atb, rcond=None)[0]
    if fit_intercept:
        return sol[:-1], float(sol[-1])
    return sol, 0.0


def approx_saes(
    batches: tp.Iterable[tp.Dict[str, np.ndarray]],
    num_species: int,
    lr: float = 0.01,
    epochs: int = 1,
) -> np.ndarray:
    """SGD-approximate SAE fit (for datasets too large to accumulate)."""
    saes = np.zeros(num_species, dtype=np.float64)
    for _ in range(epochs):
        for batch in batches:
            x = _design_matrix(np.asarray(batch["species"]), num_species)
            y = np.asarray(batch["energies"], dtype=np.float64)
            pred = x @ saes
            grad = 2 * x.T @ (pred - y) / max(len(y), 1)
            saes -= lr * grad / np.maximum(x.sum(axis=0), 1.0)
    return saes
