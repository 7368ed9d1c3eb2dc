"""PyTorch port: the foundation modules against the JAX package: `utils`
(converters, `cumsum_from_zero`, `perm_gather` to the second derivative,
the masked selections), `tuples`, `paths`, `testing` (the same arrays from
the same seeds), the biweight, triweight and r2SCAN cutoffs, and the
user-extensible AEV terms.

Tolerances: integer and symbol outputs exactly; `perm_gather` and its
derivatives exactly (row moves); cutoffs atol 1e-7 (f32 of the same
formula); AEVs atol 1e-6 (f32 sums over the same lanes in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu.aev as jaev
import torchani_tpu.constants as jconst
import torchani_tpu.cutoffs as jcut
import torchani_tpu.paths as jpaths
import torchani_tpu.testing as jtesting
import torchani_tpu.tuples as jtuples
import torchani_tpu.utils as jutils
import torchani_tpu_torch.aev as paev
import torchani_tpu_torch.constants as pconst
import torchani_tpu_torch.cutoffs as pcut
import torchani_tpu_torch.paths as ppaths
import torchani_tpu_torch.testing as ptesting
import torchani_tpu_torch.tuples as ptuples
import torchani_tpu_torch.utils as putils
from torchani_tpu.neighbors import adaptive_list as j_adaptive_list
from torchani_tpu.nn import SpeciesConverter as JSpeciesConverter

torch.set_num_threads(2)
CPU = "cpu"
AEV_ATOL = 1e-6


def test_cumsum_from_zero():
    x = np.random.RandomState(0).randint(0, 9, size=(5, 7))
    for axis in (0, 1):
        np.testing.assert_array_equal(
            putils.cumsum_from_zero(torch.as_tensor(x), axis).numpy(),
            np.asarray(jutils.cumsum_from_zero(jnp.asarray(x), axis)),
        )


def test_symbol_converters():
    symbols = ("H", "C", "N", "O", "S", "F", "Cl")
    mol = ["C", "H", "H", "Cl", "O", "S"]
    np.testing.assert_array_equal(
        putils.ChemicalSymbolsToInts(symbols)(mol), jutils.ChemicalSymbolsToInts(symbols)(mol)
    )
    assert len(putils.ChemicalSymbolsToInts(symbols)) == 7
    znums = putils.ChemicalSymbolsToAtomicNumbers()(mol)
    np.testing.assert_array_equal(znums, jutils.ChemicalSymbolsToAtomicNumbers()(mol))
    padded = np.concatenate([znums, [-1, -1]])
    assert putils.AtomicNumbersToChemicalSymbols()(torch.as_tensor(padded)) == mol
    assert putils.AtomicNumbersToChemicalSymbols()(padded) == \
        jutils.AtomicNumbersToChemicalSymbols()(padded)
    idxs = np.asarray([[1, 0, -1], [6, 3, 4]])
    assert putils.IntsToChemicalSymbols(symbols)(torch.as_tensor(idxs)) == \
        jutils.IntsToChemicalSymbols(symbols)(idxs)
    assert putils.sort_by_atomic_num(("Cl", "H", "S", "C")) == \
        jutils.sort_by_atomic_num(("Cl", "H", "S", "C"))
    names = np.asarray([["C", "H", "H", "H", "H", ""], ["O", "H", "H", "", "", ""]])
    assert putils.species_to_formula(names) == jutils.species_to_formula(names)
    assert putils.species_to_formula(names[0]) == ["CH4"]
    with pytest.raises(ValueError):
        putils.species_to_formula(np.zeros((1, 1, 1), dtype=str))


def test_masses():
    znums = np.asarray([[1, 6, 8, 17, -1, 0]])
    ref = np.asarray(jutils.AtomicNumbersToMasses()(jnp.asarray(znums)))
    for fn in (putils.AtomicNumbersToMasses(), putils.atomic_numbers_to_masses):
        np.testing.assert_array_equal(fn(torch.as_tensor(znums)).numpy(), ref)


def test_download_raises():
    with pytest.raises(RuntimeError, match="fetches nothing"):
        putils.download_and_extract("https://example.invalid/x.tar", "x")
    with pytest.raises(RuntimeError):
        jutils.download_and_extract("https://example.invalid/x.tar", "x")


def test_energy_shifter_alias():
    from torchani_tpu_torch import sae

    assert putils.EnergyShifter is sae.SelfEnergy is sae.EnergyShifter
    with pytest.raises(AttributeError):
        putils.no_such_name  # noqa: B018


def test_masked_selections():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 9).astype(np.float32)
    mask = rng.rand(9) > 0.5
    np.testing.assert_array_equal(
        putils.nonzero_in_chunks(torch.as_tensor(mask), chunk_size=4).numpy(),
        np.asarray(jutils.nonzero_in_chunks(jnp.asarray(mask))),
    )
    np.testing.assert_array_equal(
        putils.fast_masked_select(torch.as_tensor(x), torch.as_tensor(mask), 1).numpy(),
        np.asarray(jutils.fast_masked_select(jnp.asarray(x), jnp.asarray(mask), 1)),
    )
    assert putils.nonzero_in_chunks(torch.zeros((0,), dtype=torch.bool)).shape == (0,)


def _perm_indices(n: int, p: int, seed: int):
    """A sentinel-padded permutation of ``n`` rows into ``p`` slots, and
    its inverse."""
    rng = np.random.RandomState(seed)
    fwd = np.full((p,), n, np.int64)
    bwd = np.full((n,), p, np.int64)
    kept = rng.permutation(n)[: min(n, p) - 1]
    slots = rng.permutation(p)[: kept.size]
    fwd[slots] = kept
    bwd[kept] = slots
    return fwd, bwd


@pytest.mark.parametrize("n,p", [(7, 9), (9, 7)])
def test_perm_gather_to_second_order(n, p):
    """Forward, gradient and the gradient of a gradient against the JAX
    primitive's (whose transpose is the inverse gather)."""
    fwd, bwd = _perm_indices(n, p, seed=n)
    rng = np.random.RandomState(1)
    x = rng.randn(n, 3).astype(np.float32)
    w = rng.randn(p, 3).astype(np.float32)

    def jloss(x):
        y = jutils.perm_gather(x, jnp.asarray(fwd), jnp.asarray(bwd))
        return jnp.sum(jnp.sin(y) * w)

    jgrad = jax.grad(jloss)
    jhvp = jax.grad(lambda x: jnp.sum(jgrad(x) ** 2))
    xt = torch.as_tensor(x).requires_grad_(True)
    y = putils.perm_gather(xt, torch.as_tensor(fwd), torch.as_tensor(bwd))
    np.testing.assert_array_equal(
        y.detach().numpy(),
        np.asarray(jutils.perm_gather(jnp.asarray(x), jnp.asarray(fwd), jnp.asarray(bwd))),
    )
    (g,) = torch.autograd.grad(torch.sum(torch.sin(y) * torch.as_tensor(w)), xt, create_graph=True)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jgrad(jnp.asarray(x))), atol=1e-7)
    (h,) = torch.autograd.grad(torch.sum(g**2), xt)
    np.testing.assert_allclose(h.numpy(), np.asarray(jhvp(jnp.asarray(x))), atol=1e-6)


def test_tuples():
    names = (
        "SpeciesAEV SpeciesCoordinates SpeciesEnergiesQBC SpeciesForces EnergiesForces "
        "AtomicStdev ForceStdev ForceMagnitudes ForceStress"
    )
    for name in names.split():
        assert getattr(ptuples, name)._fields == getattr(jtuples, name)._fields, name


def test_paths(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHANI_TPU_DATA_DIR", str(tmp_path))
    for name in ("neurochem_dir", "datasets_dir", "custom_models_dir", "state_dicts_dir"):
        d = getattr(ppaths, name)()
        assert d == getattr(jpaths, name)() and d.is_dir() and d.parent == tmp_path


def test_testing_factories_match_jax():
    np.testing.assert_array_equal(
        ptesting.make_tensor((3, 4), -1.0, 2.0, seed=5, device=CPU).numpy(),
        np.asarray(jtesting.make_tensor((3, 4), -1.0, 2.0, seed=5)),
    )
    np.testing.assert_array_equal(
        ptesting.make_elem_idxs(4, 9, seed=2, device=CPU).numpy(),
        np.asarray(jtesting.make_elem_idxs(4, 9, seed=2)),
    )
    for pbc in (False, True):
        pm = ptesting.make_reference_molecs(3, 7, 6.0, pbc, ("H", "O", "S"), seed=4, device=CPU)
        jm = jtesting.make_reference_molecs(3, 7, 6.0, pbc, ("H", "O", "S"), seed=4)
        assert pm._fields == jm._fields
        np.testing.assert_array_equal(pm.coords.numpy(), np.asarray(jm.coords))
        np.testing.assert_array_equal(pm.atomic_nums.numpy(), np.asarray(jm.atomic_nums))
        assert (pm.cell is None) == (jm.cell is None) == (not pbc)
        if pbc:
            np.testing.assert_array_equal(pm.cell.numpy(), np.asarray(jm.cell))
            np.testing.assert_array_equal(pm.pbc.numpy(), np.asarray(jm.pbc))
    one = ptesting.make_molec(5, seed=1, device=CPU)
    np.testing.assert_array_equal(
        one.coords.numpy(), np.asarray(jtesting.make_molec(5, seed=1).coords)
    )


def test_make_neighbors_matches_jax():
    pnb = ptesting.make_neighbors(12, 4.0, seed=3, device=CPU)
    jm = jtesting.make_molec(12, seed=3)
    jelem = JSpeciesConverter(("H", "C", "N", "O"))(jm.atomic_nums)
    jnb = j_adaptive_list(4.0, jelem, jm.coords)
    np.testing.assert_array_equal(pnb.mask.numpy(), np.asarray(jnb.mask))
    np.testing.assert_array_equal(
        np.where(pnb.mask.numpy(), pnb.idx.numpy(), -1),
        np.where(np.asarray(jnb.mask), np.asarray(jnb.idx), -1),
    )
    np.testing.assert_allclose(pnb.dist.numpy(), np.asarray(jnb.dist), atol=1e-6)


def test_make_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: ptesting.make_tensor((2,)),
        lambda: ptesting.make_elem_idxs(1, 2),
        lambda: ptesting.make_molec(3),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


class _Sum(ptesting.ANITestCase):
    def test_sum_on_device(self):
        x = self._setup(torch.ones(3))
        assert x.device.type == self.device.type and float(x.sum()) == 3.0


# `expand` returns the original class, skipped; it stays out of the module
assert ptesting.expand()(_Sum).__unittest_skip__
del _Sum


def test_expand_makes_a_case_per_device():
    assert not globals()["_Sum_cpu"].__unittest_skip__
    assert ("_Sum_cuda" in globals()) == torch.cuda.is_available()
    assert ptesting.TestCase is __import__("unittest").TestCase


@pytest.mark.parametrize("kind", ["biweight", "triweight"])
def test_cutoffs(kind):
    d = np.linspace(0.0, 5.2, 53, dtype=np.float32)
    pc, jc = pcut.parse_cutoff_fn(kind), jcut.parse_cutoff_fn(kind)
    assert type(pc).__name__ == type(jc).__name__
    np.testing.assert_allclose(
        pc(torch.as_tensor(d), 5.2).numpy(), np.asarray(jc(jnp.asarray(d), 5.2)), atol=1e-7
    )


def test_alt_cutoff_smooth():
    d = np.linspace(0.0, 5.3, 54, dtype=np.float32)
    np.testing.assert_allclose(
        pcut.AltCutoffSmooth()(torch.as_tensor(d), 5.2).numpy(),
        np.asarray(jcut.AltCutoffSmooth()(jnp.asarray(d), 5.2)),
        atol=1e-7,
    )


class JGauss(jaev.Radial):
    tensors = ["eta", "shifts"]

    def compute(self, d):
        return 0.25 * jnp.exp(-self.eta * (d[..., None] - self.shifts) ** 2)


class PGauss(paev.Radial):
    tensors = ["eta", "shifts"]

    def compute(self, d):
        return 0.25 * torch.exp(-self.eta * (d[..., None] - self.shifts) ** 2)


class JCosAngular(jaev.Angular):
    radial_tensors = ["eta", "shifts"]
    angles_tensors = ["zeta", "sections"]

    def compute_radial(self, a, b):
        return jnp.exp(-self.eta * ((a + b)[..., None] / 2 - self.shifts) ** 2)

    def compute_cos_angles(self, c):
        theta = jnp.arccos(0.95 * c)
        return 2 * ((1 + jnp.cos(theta[..., None] - self.sections)) / 2) ** self.zeta


class PCosAngular(paev.Angular):
    radial_tensors = ["eta", "shifts"]
    angles_tensors = ["zeta", "sections"]

    def compute_radial(self, a, b):
        return torch.exp(-self.eta * ((a + b)[..., None] / 2 - self.shifts) ** 2)

    def compute_cos_angles(self, c):
        theta = torch.arccos(0.95 * c)
        return 2 * ((1 + torch.cos(theta[..., None] - self.sections)) / 2) ** self.zeta


_RADIAL = dict(eta=19.7, shifts=[0.8 + 0.27 * i for i in range(16)])
_ANGULAR = dict(
    eta=12.5, shifts=[0.8 + 0.3375 * i for i in range(8)], zeta=14.1,
    sections=[math.pi / 8 + math.pi / 4 * i for i in range(4)],
)


def _terms(cutoff_fn: str, user: bool):
    if user:
        return (
            (JGauss.make(5.1, cutoff_fn=cutoff_fn, **_RADIAL),
             JCosAngular.make(3.5, cutoff_fn=cutoff_fn, **_ANGULAR)),
            (PGauss.make(5.1, cutoff_fn=cutoff_fn, device=CPU, **_RADIAL),
             PCosAngular.make(3.5, trainable="zeta", cutoff_fn=cutoff_fn, device=CPU, **_ANGULAR)),
        )
    return (
        (jaev.ANIRadial.like_2x(cutoff_fn), jaev.ANIAngular.like_2x(cutoff_fn)),
        (paev.ANIRadial.like_2x(cutoff_fn, CPU), paev.ANIAngular.like_2x(cutoff_fn, CPU)),
    )


@pytest.mark.parametrize(
    "cutoff_fn,user",
    [("biweight", False), ("triweight", False), ("cosine", True), ("smooth", True)],
)
def test_aev_with_new_cutoffs_and_user_terms(cutoff_fn, user):
    species, coords = jtesting.make_molecs(4, 12, seed=11)
    elem = np.where(species >= 0, np.searchsorted([1, 6, 7, 8], species), -1)
    (jr, ja), (pr, pa) = _terms(cutoff_fn, user)
    assert (pr.num_feats, pa.num_feats) == (jr.num_feats, ja.num_feats) == (16, 32)
    jaevs = jaev.AEVComputer.make(jr, ja, 4, strategy="xla")(jnp.asarray(elem), jnp.asarray(coords))
    pc = paev.AEVComputer(pr, pa, 4)
    paevs = pc(torch.as_tensor(elem), torch.as_tensor(coords))
    np.testing.assert_allclose(paevs.detach().numpy(), np.asarray(jaevs), atol=AEV_ATOL)
    # the kernel evaluates neither, as JAX's Pallas path: "auto" takes the
    # plain path and "cuda" raises
    assert not pc._kernel_evaluates()
    pc.strategy = "cuda"
    with pytest.raises(ValueError, match="ANIAngular with the cosine or default smooth"):
        pc(torch.as_tensor(elem), torch.as_tensor(coords))


def test_user_term_tensors_and_validation():
    term = PCosAngular.make(3.5, trainable=["zeta"], device=CPU, **_ANGULAR)
    assert tuple(term.shifts.shape) == (1, 8) and tuple(term.sections.shape) == (1, 4)
    assert [n for n, _ in term.named_parameters()] == ["zeta"]
    assert set(term.params) == {"eta", "shifts", "zeta", "sections"}
    assert term.num_feats == 32
    for bad in (dict(_RADIAL, extra=1.0), {"eta": 1.0}):
        for cls in (PGauss, JGauss):
            with pytest.raises(ValueError):
                cls.make(5.1, **bad) if cls is JGauss else cls.make(5.1, device=CPU, **bad)
    with pytest.raises(ValueError, match="trainable"):
        PGauss.make(5.1, trainable="zeta", device=CPU, **_RADIAL)
    assert isinstance(paev.parse_radial_term(term and PGauss.make(5.1, device=CPU, **_RADIAL)),
                      paev.BaseRadial)
    with pytest.raises(NotImplementedError):
        paev.BaseRadial(5.2, "cosine", 1)(torch.ones(2))


def test_ani_terms_route_to_the_kernel():
    for kind in ("cosine", "smooth"):
        assert paev.AEVComputer.like_2x(cutoff_fn=kind, device=CPU)._kernel_evaluates()
    assert not paev.AEVComputer.like_2x(cutoff_fn="biweight", device=CPU)._kernel_evaluates()


def test_constants_tables_and_mappings():
    """The per-element tables equal JAX's, and so do the mappings between
    {symbol: value} and atomic-number-indexed sequences (NaN at index 0)."""
    for name in ("ATOMIC_COVALENT_RADIUS", "ATOMIC_SQRT_EMPIRICAL_CHARGE",
                 "ATOMIC_XTB_REPULSION_ALPHA", "ATOMIC_XTB_REPULSION_YEFF",
                 "ATOMIC_HARDNESS", "ATOMIC_ELECTRONEGATIVITY", "ATOMIC_MASS"):
        assert getattr(pconst, name) == getattr(jconst, name), name
        assert len(getattr(pconst, name)) > 80, name
    for table in (pconst.ATOMIC_COVALENT_RADIUS, {"H": 1.0, "He": 2.5, "Li": -3.0}):
        ours = pconst.mapping_to_znumber_indexed_seq(table)
        theirs = jconst.mapping_to_znumber_indexed_seq(table)
        np.testing.assert_array_equal(ours, theirs)
        assert math.isnan(ours[0])
        assert pconst.znumber_indexed_seq_to_mapping(ours) == jconst.znumber_indexed_seq_to_mapping(
            theirs) == table
    np.testing.assert_array_equal(
        pconst.mapping_to_znumber_indexed_seq(pconst.ATOMIC_COVALENT_RADIUS)[:87],
        pconst.COVALENT_RADIUS[:87])
    for bad in ({"He": 1.0, "U": 2.0},):
        with pytest.raises(ValueError, match="missing elements"):
            pconst.mapping_to_znumber_indexed_seq(bad)
        with pytest.raises(ValueError, match="missing elements"):
            jconst.mapping_to_znumber_indexed_seq(bad)
    with pytest.raises(ValueError, match="NaN"):
        pconst.znumber_indexed_seq_to_mapping((0.0, 1.0))


def test_exact_matmul():
    """Strict f32 on the CPU: JAX's HIGHEST-precision product to f32
    rounding, and the f64 product within the rounding of a 3-term f32 sum."""
    rng = np.random.RandomState(0)
    x = (rng.randn(50, 3) * 20).astype(np.float32)
    m = rng.randn(3, 3).astype(np.float32)
    ours = putils.exact_matmul(torch.as_tensor(x), torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jutils.exact_matmul(jnp.asarray(x), jnp.asarray(m))),
                               rtol=0, atol=1e-5)
    exact = x.astype(np.float64) @ m.astype(np.float64)
    bound = 4 * 2.0**-24 * (np.abs(x).astype(np.float64) @ np.abs(m).astype(np.float64))
    assert np.all(np.abs(ours - exact) <= bound)


def _write_pdb(path, znums, coords, cell=None, resname="HOH"):
    """ATOM records (element in columns 77-78) and an optional CRYST1."""
    lines = []
    if cell is not None:
        lines.append(f"CRYST1{cell:9.3f}{cell:9.3f}{cell:9.3f}{90:7.2f}{90:7.2f}{90:7.2f} P 1\n")
    for i, (z, (x, y, w)) in enumerate(zip(znums, coords)):
        sym = pconst.PERIODIC_TABLE[int(z)]
        lines.append(f"ATOM  {i + 1:5d} {sym:<4s} {resname} A{i // 3 + 1:4d}    "
                     f"{x:8.3f}{y:8.3f}{w:8.3f}{1.0:6.2f}{0.0:6.2f}          {sym:>2s}\n")
    path.write_text("".join(lines) + "END\n")
    return path


@pytest.mark.parametrize("box,solute", [(19.0, True), (19.0, False), (6.0, True)],
                         ids=["solvated", "water_only", "small_box_warns"])
def test_make_solvated_system_matches_jax(tmp_path, box, solute):
    """PDB files written here: a 150-atom water template with its CRYST1
    cell and a 12-atom HCNO solute; species, coordinates and cell equal
    JAX's exactly, with waters within the clash distance gone."""
    wz, wc, wcell = ptesting.make_water_box(150, seed=2)
    water = _write_pdb(tmp_path / "water.pdb", wz[0], wc[0], float(wcell[0, 0]))
    sz, sc = ptesting.make_molecs(1, 12, seed=5, znums=(1, 6, 7, 8))
    real = sz[0] >= 0
    sol = _write_pdb(tmp_path / "sol.pdb", sz[0][real], sc[0][real], resname="LIG") if solute else None
    if box < 10.0:
        with pytest.warns(UserWarning, match="periodic self-overlap"):
            ours = ptesting.make_solvated_system(sol, water, box)
        with pytest.warns(UserWarning, match="periodic self-overlap"):
            theirs = jtesting.make_solvated_system(sol, water, box)
    else:
        ours = ptesting.make_solvated_system(sol, water, box)
        theirs = jtesting.make_solvated_system(sol, water, box)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    species, coords, cell = ours
    assert cell.shape == (3, 3) and float(cell[0, 0]) == box
    if solute:
        n = int(real.sum())
        np.testing.assert_array_equal(species[:n], sz[0][real])
        d = coords[n:, None, :] - coords[None, :n, :]
        d -= np.round(d / box) * box
        assert np.sqrt((d**2).sum(-1)).min() > 1.7
        assert (species[n:].reshape(-1, 3) == [8, 1, 1]).all()
    else:
        assert len(species) % 3 == 0 and (species.reshape(-1, 3) == [8, 1, 1]).all()
