"""The plain reference against the program's CPU path at small sizes, for
both configurations: a batch of 8 conformers and a periodic water box.

Tolerances, set from float32: forces within 2e-6 of the largest force on
molecules and 2e-5 in a periodic box, where the program's pair vectors
carry a rounding of the order of the box's length (`PERF.md`, Open
questions), 1e-4 for ANI-2dr, whose xTB repulsion at O-H bond length
amplifies that about tenfold; energies within 1e-6 of their size (float32 totals).  Both are
held against the reference's float64 form, and so is the float32 reference
itself (forces within 2e-6 of the largest, energies within 1e-7).
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import generators, weights
from benchmark.reference.model import Reference

ROOT = Path(__file__).resolve().parents[2]
ELEMENTS = [1, 6, 7, 8, 9, 16, 17]


def config(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def program(cfg: dict, sd):
    from torchani_tpu_torch import convert, models
    from torchani_tpu_torch.neighbors import parse_neighborlist

    model = getattr(models, cfg["factory"])(device="cpu")
    convert.load_state_dict(model, sd)
    model.neighborlist = parse_neighborlist("cell_list" if cfg["name"] == "ani2dr" else "adaptive")
    return model


def relative(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("name", ["ani2x", "ani2dr"])
def test_conformers(name, cpu):
    from torchani_tpu_torch.grad import energies_and_forces
    from torchani_tpu_torch.neighbors import parse_neighborlist

    cfg = config(name)
    sd = weights.random_state_dict(cfg, cfg["members"], 2**40 + 3, cpu)
    model = program(cfg, sd)
    model.neighborlist = parse_neighborlist("all_pairs")
    species, coords = generators.chain_batch(11, 0, 8, 10, 30, ELEMENTS)
    species, coords = torch.as_tensor(species), torch.as_tensor(coords)
    e, f = energies_and_forces(model, species, coords)
    er, fr = Reference(cfg, sd).batch_energies_and_forces(species, coords)
    e64, f64 = Reference(cfg, sd, "float64").batch_energies_and_forces(species, coords)
    assert relative(e, e64) < 1e-6 and relative(er, e64) < 1e-7
    assert relative(f, f64) < 2e-6 and relative(fr, f64) < 2e-6


@pytest.mark.parametrize("name,atoms,tol", [("ani2x", 90, 2e-5), ("ani2dr", 648, 1e-4)])
def test_water_box(name, atoms, tol, cpu):
    """A box over twice the largest cutoff: 90 atoms (12.4 A) for ANI-2x,
    648 (18.6 A) for ANI-2dr's D3 at 8 A."""
    from torchani_tpu_torch.grad import energies_and_forces

    cfg = config(name)
    sd = weights.random_state_dict(cfg, cfg["members"], 7, cpu)
    species, coords, box = generators.water_box(atoms, 5)
    species, coords = torch.as_tensor(species), torch.as_tensor(coords)
    cell = torch.eye(3) * box
    e, f = energies_and_forces(program(cfg, sd), species[None], coords[None], cell,
                               torch.ones(3, dtype=torch.bool))
    lengths = torch.full((3,), box)
    er, fr = Reference(cfg, sd).system_energy_and_forces(species, coords, lengths, block=64)
    e64, f64 = Reference(cfg, sd, "float64").system_energy_and_forces(species, coords, lengths)
    assert relative(e, e64) < 1e-6 and relative(er, e64) < 1e-7
    assert relative(f[0], f64) < tol and relative(fr, f64) < 2e-6


def test_tf32_rounding():
    from benchmark.reference.model import round_tf32

    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0 - 2**-12])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -3.0]
