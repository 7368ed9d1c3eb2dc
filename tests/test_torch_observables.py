"""PyTorch port: `observables` against the JAX package's, on the CPU.

MSD, VACF and the diffusion coefficient of seeded random frames within rtol
1e-5.  The RDF of a perturbed 60-atom water box on an orthorhombic cell, a
triclinic cell and no cell, each with and without ``pair``: the per-bin pair
counts equal the JAX package's, except where a pair lies within 1e-5 A of a
bin edge (the two packages' f32 minimum-image arithmetic rounds such a pair
to either side); the test finds those pairs in float64 and bounds each
differing bin by them.  The row-blocked histogram equals the one-block one.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from torchani_tpu import observables as jobs
from torchani_tpu_torch import observables
from torchani_tpu_torch.testing import make_water_box

CPU = "cpu"
R_MAX, BINS, EDGE_TOL = 6.0, 60, 1e-5


@pytest.fixture(scope="module")
def frames():
    species, coords, cell = make_water_box(60)
    rng = np.random.RandomState(5)
    f = coords + 0.2 * rng.randn(3, 60, 3).astype(np.float32)
    return species[0], f.astype(np.float32), cell


def _cells(cell):
    tri = cell.copy()
    tri[1, 0], tri[2, 0], tri[2, 1] = 0.3 * cell[0, 0], 0.2 * cell[0, 0], 0.1 * cell[0, 0]
    return {"orthorhombic": cell, "triclinic": tri, "none": None}


def _counts_from_g(centers, g, n_center, n_partner, volume, nframes):
    shell = 4.0 * np.pi * np.asarray(centers, np.float64) ** 2 * (R_MAX / BINS)
    ideal = shell * (n_partner / volume) * n_center
    return np.rint(np.asarray(g, np.float64) * ideal * nframes).astype(np.int64)


def _float64_distances(frames, cell, rows, cols):
    """Minimum-image distances (F, R, P) in float64, self pairs dropped."""
    out = []
    for c in frames.astype(np.float64):
        diff = c[cols][None] - c[rows][:, None]
        if cell is not None:
            cell64 = cell.astype(np.float64)
            frac = diff @ np.linalg.inv(cell64)
            base = (frac - np.round(frac)) @ cell64
            shifts = np.array(
                [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
                np.float64,
            ) @ cell64
            d = np.sqrt(((base[:, :, None] + shifts) ** 2).sum(-1).min(-1))
        else:
            d = np.sqrt((diff**2).sum(-1))
        d[rows[:, None] == cols[None, :]] = np.inf
        out.append(d)
    return np.stack(out)


@pytest.mark.parametrize("pair", [None, (8, 8)], ids=["all", "O-O"])
@pytest.mark.parametrize("cell_kind", ["orthorhombic", "triclinic", "none"])
def test_rdf_counts_match_jax(frames, cell_kind, pair):
    species, f, cell = frames
    cell = _cells(cell)[cell_kind]
    kw = dict(species=species, pair=pair) if pair else {}
    jc, jg = jobs.radial_distribution(jnp.asarray(f), None if cell is None else jnp.asarray(cell),
                                      R_MAX, BINS, **kw)
    pc, pg = observables.radial_distribution(f, cell, R_MAX, BINS, device=CPU, **kw)
    np.testing.assert_allclose(pc, np.asarray(jc), rtol=1e-6)
    rows = np.flatnonzero(species == pair[0]) if pair else np.arange(species.shape[0])
    cols = np.flatnonzero(species == pair[1]) if pair else np.arange(species.shape[0])
    if cell is not None:
        volume = abs(np.linalg.det(cell))
    else:
        r = np.linalg.norm(f[0] - f[0].mean(0), axis=-1).max() + 1e-6
        volume = 4.0 / 3.0 * np.pi * r**3
    norm = (len(rows), len(cols), volume, f.shape[0])
    jcounts = _counts_from_g(jc, jg, *norm)
    pcounts = _counts_from_g(jc, pg, *norm)
    d = _float64_distances(f, cell, rows, cols)
    scaled = d[np.isfinite(d)] / R_MAX * BINS
    exact = np.bincount(np.minimum(scaled.astype(np.int64), BINS), minlength=BINS + 1)[:BINS]
    assert pcounts.sum() > 100
    # pairs within EDGE_TOL of a bin edge k * r_max / bins, by k
    near = np.abs(scaled - np.rint(scaled)) * (R_MAX / BINS) < EDGE_TOL
    near_edge = np.bincount(np.rint(scaled[near]).astype(np.int64), minlength=BINS + 2)
    for counts in (pcounts, jcounts):
        off = np.flatnonzero(counts != exact)
        for k in off:
            slack = near_edge[k] + near_edge[k + 1]
            assert abs(int(counts[k]) - int(exact[k])) <= slack, (cell_kind, pair, k)
    off = np.flatnonzero(pcounts != jcounts)
    for k in off:
        assert abs(int(pcounts[k]) - int(jcounts[k])) <= near_edge[k] + near_edge[k + 1]
    np.testing.assert_allclose(pg[pcounts == jcounts], np.asarray(jg)[pcounts == jcounts], rtol=1e-6)


def test_rdf_row_blocks_equal_one_block(frames, monkeypatch):
    species, f, cell = frames
    tri = _cells(cell)["triclinic"]
    whole = observables.radial_distribution(f, tri, R_MAX, BINS, device=CPU)[1]
    # 7 center rows a block: 9 blocks of the 60 rows, the last one short
    monkeypatch.setattr(observables, "_RDF_BLOCK_BYTES", 7 * 60 * observables._RDF_PAIR_BYTES)
    blocked = observables.radial_distribution(f, tri, R_MAX, BINS, device=CPU)[1]
    np.testing.assert_array_equal(blocked, whole)


def test_msd_vacf_diffusion_match_jax():
    rng = np.random.RandomState(2)
    walk = np.cumsum(rng.randn(12, 40, 3).astype(np.float32) * 0.1, axis=0)
    vel = rng.randn(12, 40, 3).astype(np.float32)
    np.testing.assert_allclose(
        observables.mean_squared_displacement(walk, device=CPU),
        jobs.mean_squared_displacement(jnp.asarray(walk)), rtol=1e-5,
    )
    np.testing.assert_allclose(
        observables.velocity_autocorrelation(vel, device=CPU),
        jobs.velocity_autocorrelation(jnp.asarray(vel)), rtol=1e-5, atol=1e-7,
    )
    assert observables.diffusion_coefficient(walk, 5.0, device=CPU) == pytest.approx(
        jobs.diffusion_coefficient(jnp.asarray(walk), 5.0), rel=1e-5
    )
    assert isinstance(observables.mean_squared_displacement(walk, device=CPU), np.ndarray)
