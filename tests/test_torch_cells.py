"""PyTorch port: cells that are not cubic and fully periodic, against the
JAX package on the CPU, with one-member models whose weights come through
`torchani_tpu_torch.interop`.

- A triclinic 300-atom water box (liquid density, rows of the cell sheared
  by up to a fifth of its edge): ANI-2x energies and forces.
- Partly periodic cells, ``pbc`` of (T, T, F) and (F, F, T), on a cubic
  150-atom water box: ANI-2x and ANI-2dr (xTB repulsion, D3 dispersion)
  energies and forces.
- 20 NVE steps of 1 fs on a triclinic 150-atom box with a 0.2 A skin (a
  rebuild every few steps), each package from its own `init` and the same
  numpy velocities: ANI-2x through the slot-row, the atom-packed and the
  gather refresh, and ANI-2dr through the atom-packed one (its box spread
  to 25 A, the least edge of a 3 x 3 x 3 bucket grid at its build radius).

Tolerances: forces atol 1e-6 Ha/A and energies rtol 1e-6 (f32 sums over
the same neighbours in another order: a few units of the last place of
each force term); MD coordinates atol 1e-4 A (rounding grows along a
trajectory, and each rebuild sorts lanes whose distances tie within
rounding), the bound of ``tests/test_torch_md.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchani_tpu import models as jzoo
from torchani_tpu.bucket_refresh import BucketTables as JBucketTables
from torchani_tpu.bucket_refresh_packed import PackedTables as JPackedTables
from torchani_tpu.grad import energies_and_forces as j_energies_and_forces
from torchani_tpu.md import MolecularDynamics as JMolecularDynamics
from torchani_tpu_torch import models
from torchani_tpu_torch.bucket_refresh import BucketTables
from torchani_tpu_torch.bucket_refresh_packed import PackedTables
from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.interop import load_jax_arrays
from torchani_tpu_torch.md import MolecularDynamics
from torchani_tpu_torch.testing import make_water_box

torch.set_num_threads(2)
CPU = "cpu"
FORCE_ATOL, ENERGY_RTOL, MD_COORD_ATOL = 1e-6, 1e-6, 1e-4
MD_STEPS = 20


def _leaves(tree):
    return {
        jax.tree_util.keystr(p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _sheared(species, coords, cell):
    """The box with its cell's rows sheared (b += 0.2 a, c += 0.1 a + 0.15 b;
    the volume is unchanged) and each rigid molecule moved with its oxygen's
    fractional position."""
    edge = float(cell[0, 0])
    tri = np.array([[1.0, 0.0, 0.0], [0.2, 1.0, 0.0], [0.1, 0.15, 1.0]]) * edge
    xyz = coords[0].astype(np.float64).reshape(-1, 3, 3)  # molecules of O, H, H
    assert (species[0].reshape(-1, 3) == [8, 1, 1]).all()
    shift = (xyz[:, 0] / edge) @ tri - xyz[:, 0]
    moved = (xyz + shift[:, None, :]).reshape(1, -1, 3).astype(np.float32)
    return species, moved, tri.astype(np.float32)


@pytest.fixture(scope="module")
def ani2x():
    jmodel = jzoo.ANI2x(model_index=0, pretrained=False)
    return jmodel, load_jax_arrays(models.ANI2x(model_index=0, device=CPU), _leaves(jmodel))


@pytest.fixture(scope="module")
def ani2dr():
    jmodel = jzoo.ANI2dr(model_index=0, pretrained=False)
    return jmodel, load_jax_arrays(models.ANI2dr(model_index=0, device=CPU), _leaves(jmodel))


def _both_ef(pair, species, coords, cell, pbc):
    jmodel, pmodel = pair
    jcell, jpbc = jnp.asarray(cell), jnp.asarray(pbc)  # constants: the grid shape is static
    je, jf = jax.jit(lambda sp, co: j_energies_and_forces(jmodel, sp, co, jcell, jpbc))(
        jnp.asarray(species), jnp.asarray(coords)
    )
    pe, pf = energies_and_forces(pmodel, species, coords, cell, pbc)
    return (np.asarray(je), np.asarray(jf)), (pe.numpy(), pf.numpy())


def _assert_ef_close(ref, out):
    (je, jf), (pe, pf) = ref, out
    assert np.isfinite(pf).all() and np.abs(jf).max() > 0
    np.testing.assert_allclose(pe, je, rtol=ENERGY_RTOL)
    np.testing.assert_allclose(pf, jf, atol=FORCE_ATOL, rtol=0)


def test_triclinic_water_box_ani2x_matches_jax(ani2x):
    species, coords, cell = _sheared(*make_water_box(300))
    ref, out = _both_ef(ani2x, species, coords, cell, np.ones(3, bool))
    _assert_ef_close(ref, out)


@pytest.mark.parametrize("pbc", [(True, True, False), (False, False, True)],
                         ids=["TTF", "FFT"])
@pytest.mark.parametrize("which", ["ani2x", "ani2dr"])
def test_partly_periodic_cell_matches_jax(which, pbc, request):
    species, coords, cell = make_water_box(150)
    ref, out = _both_ef(request.getfixturevalue(which), species, coords, cell,
                        np.asarray(pbc, bool))
    _assert_ef_close(ref, out)


#: the MD cases: model, refresh (the ``bucket_refresh`` of both packages)
#: and the box's density in water molecules per A^3.  ANI-2dr's build radius
#: (D3 at 8 A and the skin) needs a 25 A box for the 3 x 3 x 3 bucket grid
#: below which both packages turn the bucket refresh off, so its 150 atoms
#: are spread thinner
REFRESH = {"slot": True, "packed": "packed", "gather": False}
MD_CASES = [("ani2x", "slot", 0.008), ("ani2x", "packed", 0.008), ("ani2x", "gather", 0.008),
            ("ani2dr", "packed", 0.0032)]


@pytest.mark.parametrize("which,refresh,density", MD_CASES,
                         ids=[f"{w}-{r}" for w, r, _ in MD_CASES])
def test_triclinic_md_matches_jax(which, refresh, density, request):
    """The triclinic box through each refresh: the slot-row and atom-packed
    bucket layouts (both packages' tables of the same type) and the gather
    refresh (no tables)."""
    jmodel, pmodel = request.getfixturevalue(which)
    species, coords, cell = _sheared(*make_water_box(150, density_molec_per_a3=density))
    velocities = (np.random.RandomState(6).randn(150, 3) * 0.01).astype(np.float32)
    kw = dict(cell=cell, pbc=True, skin=0.2, timestep_fs=1.0, bucket_refresh=REFRESH[refresh])
    jmd = JMolecularDynamics(jmodel, species, nn_precision="highest", **kw)
    jstart = jmd.init(coords).replace(velocities=jnp.asarray(velocities))
    jend = jmd.run_nve(jstart, MD_STEPS)
    pmd = MolecularDynamics(pmodel, species, device=CPU, **kw)
    pstart = pmd.init(coords).replace(velocities=torch.as_tensor(velocities))
    assert pmd.grid_shape == jmd.grid_shape and min(pmd.grid_shape) >= 3
    tables = {"slot": (BucketTables, JBucketTables), "packed": (PackedTables, JPackedTables),
              "gather": (type(None), type(None))}[refresh]
    assert type(pstart.bucket) is tables[0] and type(jstart.bucket) is tables[1]
    pend = pmd.run_nve(pstart, MD_STEPS)
    assert pend.rebuilds == int(jend.rebuilds) >= 3
    assert not bool(pend.overflow) and not bool(jend.overflow)
    assert type(pend.bucket) is tables[0] and type(jend.bucket) is tables[1]
    np.testing.assert_allclose(pend.coords.numpy(), np.asarray(jend.coords),
                               atol=MD_COORD_ATOL, rtol=0)
