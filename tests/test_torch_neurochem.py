"""PyTorch port: the NeuroChem loaders (`torchani_tpu_torch.neurochem`)
against the JAX package's, on files that each test writes into
``tmp_path``: ``.params`` files from the ANI-1x and ANI-2x constants that
both packages hold, ``sae_linfit.dat``, and ``.nnf``/``.wparam``/``.bparam``
sets written as ``tests/test_api_parity.py`` writes them (a ``XX==`` header
before the bz2 payload), with seeded random weights of small widths.

Tolerances: parsed constants, symbols, self energies and weight stacks
exactly (the same bytes read into f32); network outputs atol 1e-6 (f32
products in another order); AEVs |p - j| <= 1e-6 + 1e-5 |j|; model energies
atol 1e-6 Ha and forces atol 1e-5 Ha/A.
"""

import bz2

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchani_tpu.neurochem as jnc
import torchani_tpu.paths as jpaths
import torchani_tpu_torch.neurochem as pnc
import torchani_tpu_torch.paths as ppaths
from torchani_tpu.aev import AEVComputer as JAEVComputer
from torchani_tpu.grad import energies_and_forces as j_energies_and_forces
from torchani_tpu_torch.grad import energies_and_forces
from torchani_tpu_torch.nn import AtomicNetwork, AtomicNetworks, Ensemble
from torchani_tpu_torch.testing import make_molecs

torch.set_num_threads(2)
CPU = "cpu"
OUT_ATOL, AEV_ATOL, AEV_RTOL, E_ATOL, F_ATOL = 1e-6, 1e-6, 1e-5, 1e-6, 1e-5

#: the JAX side jitted (its eager first call compiles op by op)
_j_ef = jax.jit(lambda m, s, c: j_energies_and_forces(m, s, c))
_j_call = jax.jit(lambda m, *args: m(*args))

SYMBOLS = {"1x": ("H", "C", "N", "O"), "2x": ("H", "C", "N", "O", "S", "F", "Cl")}
#: small hidden widths per element, ragged so that the stacks zero-pad
HIDDEN = {"H": (16, 12), "C": (14, 12), "N": (12, 10), "O": (12, 10), "S": (10, 8),
          "F": (10, 8), "Cl": (10, 8)}
#: ANI-2x-like self energies (Ha) in the published file's index order
SAES = {"H": -0.5978583943827134, "C": -38.08933878049795, "N": -54.711968298621066,
        "O": -75.19106774742086, "S": -398.1577125334925, "F": -99.80348506781634,
        "Cl": -460.1681939421027}


def _f32_list(values) -> str:
    """Values as f32-exact decimals in NeuroChem's bracket list."""
    return "[" + ",".join(repr(float(np.float32(v))) for v in np.asarray(values).ravel()) + "]"


def write_params(path, kind: str):
    """A ``.params`` file from the JAX package's ANI-1x or ANI-2x constants."""
    aev = JAEVComputer.like_1x() if kind == "1x" else JAEVComputer.like_2x()
    r, a = aev.radial, aev.angular
    lines = [
        "TM = 1",
        f"Rcr = {float(r.cutoff)!r}",
        f"Rca = {float(a.cutoff)!r}",
        f"EtaR = {_f32_list(r.eta)}",
        f"ShfR = {_f32_list(r.shifts)}",
        f"Zeta = {_f32_list(a.zeta)}",
        f"ShfZ = {_f32_list(a.sections)}",
        f"EtaA = {_f32_list(a.eta)}",
        f"ShfA = {_f32_list(a.shifts)}",
        "Atyp = [" + ",".join(SYMBOLS[kind]) + "]",
    ]
    path.write_text("\n".join(lines) + "\n")
    return path


def write_sae(path, symbols):
    path.write_text("".join(f"{s},{i}={SAES[s]!r}\n" for i, s in enumerate(symbols)))
    return path


def write_network(net_dir, sym, dims, rng, activation=9):
    """One ``ANN-{sym}.nnf`` with its weight and bias files."""
    blocks = []
    for li in range(len(dims) - 1):
        w = (rng.randn(dims[li + 1], dims[li]) / np.sqrt(dims[li])).astype(np.float32)
        b = (rng.randn(dims[li + 1]) * 0.1).astype(np.float32)
        wname, bname = f"{sym}_l{li}.wparam", f"{sym}_l{li}.bparam"
        (net_dir / wname).write_bytes(w.tobytes())
        (net_dir / bname).write_bytes(b.tobytes())
        act = activation if li < len(dims) - 2 else 6
        blocks.append(
            f"layer [ nodes={dims[li + 1]}; activation={act}; "
            f"weights=FILE: {wname}[{w.size}]; biases=FILE: {bname}[{b.size}]; ]"
        )
    payload = bz2.compress(("\n".join(blocks) + "\n$\n").encode("ascii") + b"\n")
    (net_dir / f"ANN-{sym}.nnf").write_bytes(b"XX==" + payload)


def write_zoo(root, kind: str, members: int = 2, seed: int = 0, name: str = "model"):
    """A NeuroChem model directory: ``{name}.info``, the ``.params`` and
    ``sae_linfit.dat`` files and ``train{i}/networks/`` per member."""
    root.mkdir(parents=True, exist_ok=True)
    write_params(root / f"{kind}.params", kind)
    write_sae(root / "sae_linfit.dat", SYMBOLS[kind])
    in_dim = 384 if kind == "1x" else 1008
    rng = np.random.RandomState(seed)
    for m in range(members):
        net_dir = root / f"train{m}" / "networks"
        net_dir.mkdir(parents=True)
        for sym in SYMBOLS[kind]:
            write_network(net_dir, sym, (in_dim,) + HIDDEN[sym] + (1,), rng)
    info = root / f"{name}.info"
    info.write_text(f"{kind}.params\nsae_linfit.dat\ntrain\n{members}\n")
    return info


def _molecs(kind: str, seed: int = 3):
    znums = (1, 6, 7, 8) if kind == "1x" else (1, 6, 7, 8, 9, 16, 17)
    return make_molecs(3, 9, seed=seed, znums=znums)


@pytest.mark.parametrize("kind", ["1x", "2x"])
def test_params_parse_to_equal_constants_and_aevs(tmp_path, kind):
    path = write_params(tmp_path / "c.params", kind)
    jc, jsym = jnc.load_aev_constants_and_symbols(path)
    pc, psym = pnc.load_aev_constants_and_symbols(path)
    assert psym == jsym == SYMBOLS[kind]
    assert vars(pc) == vars(jc)
    jaev, _ = jnc.load_aev_computer_and_symbols(path)
    paev, _ = pnc.load_aev_computer_and_symbols(path, device=CPU)
    assert paev.out_dim == jaev.out_dim == (384 if kind == "1x" else 1008)
    like = (JAEVComputer.like_1x() if kind == "1x" else JAEVComputer.like_2x())
    for term, ref in ((paev.radial, like.radial), (paev.angular, like.angular)):
        np.testing.assert_array_equal(term.shifts.numpy(), np.asarray(ref.shifts))
    np.testing.assert_array_equal(paev.angular.sections.numpy(), np.asarray(like.angular.sections))
    species, coords = _molecs(kind)
    jconv = {z: i for i, z in enumerate((1, 6, 7, 8, 16, 9, 17))}
    elem = np.vectorize(lambda z: jconv.get(int(z), -1))(species)
    ja = np.asarray(_j_call(jaev, jnp.asarray(elem), jnp.asarray(coords)))
    pa = paev(torch.as_tensor(elem), torch.as_tensor(coords)).numpy()
    assert np.all(np.abs(pa - ja) <= AEV_ATOL + AEV_RTOL * np.abs(ja))


def test_sae_parses_to_equal_self_energies(tmp_path):
    path = tmp_path / "sae_linfit.dat"
    # written out of index order: the parser sorts by the index
    lines = [f"{s},{i}={SAES[s]!r}\n" for i, s in enumerate(SYMBOLS["2x"])]
    path.write_text("".join(lines[::-1]))
    j, p = jnc.load_sae(path), pnc.load_sae(path, device=CPU)
    assert p.symbols == tuple(j.symbols) == SYMBOLS["2x"]
    np.testing.assert_array_equal(p.self_energies.numpy(), np.asarray(j.self_energies))


def test_networks_load_to_equal_weights_and_outputs(tmp_path):
    net_dir = tmp_path / "train0" / "networks"
    net_dir.mkdir(parents=True)
    rng = np.random.RandomState(1)
    symbols = SYMBOLS["1x"]
    for sym in symbols + ("Cl",):
        write_network(net_dir, sym, (24,) + HIDDEN[sym] + (1,), rng)
    jn = jnc.load_atomic_networks(net_dir, symbols, 24)
    pn = pnc.load_atomic_networks(net_dir, symbols, 24, device=CPU)
    assert isinstance(pn, AtomicNetworks) and pn.layer_dims == tuple(jn.layer_dims)
    assert pn.activation == jn.activation == "celu"
    for pw, jw in zip(list(pn.weights) + list(pn.biases), list(jn.weights) + list(jn.biases)):
        np.testing.assert_array_equal(pw.detach().numpy(), np.asarray(jw))
    elem = rng.randint(-1, 4, (4, 11))
    aevs = rng.randn(4, 11, 24).astype(np.float32)
    jo = np.asarray(_j_call(jn, jnp.asarray(elem), jnp.asarray(aevs)))
    po = pn(torch.as_tensor(elem), torch.as_tensor(aevs)).detach().numpy()
    np.testing.assert_allclose(po, jo, atol=OUT_ATOL, rtol=0)
    # one element's MLP alone, in (in, out) layout
    jone = jnc.load_atomic_network(net_dir / "ANN-Cl.nnf")
    pone = pnc.load_atomic_network(net_dir / "ANN-Cl.nnf", device=CPU)
    assert isinstance(pone, AtomicNetwork) and pone.layer_dims == (24, 10, 8, 1)
    for pw, jw in zip(pone.weights, jone.weights):
        np.testing.assert_array_equal(pw.detach().numpy(), np.asarray(jw))
    x = rng.randn(5, 24).astype(np.float32)
    np.testing.assert_allclose(pone(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(_j_call(jone, jnp.asarray(x))), atol=OUT_ATOL, rtol=0)
    # the ensemble of one member directory, and its member path
    assert pnc.model_dir_from_prefix(tmp_path / "train", 0) == net_dir
    pens = pnc.load_ensemble(symbols, tmp_path / "train", 1, device=CPU)
    assert isinstance(pens, Ensemble) and pens.total_members_num == 1
    for pw, jw in zip(pens.weights, jn.weights):
        np.testing.assert_array_equal(pw.detach().numpy(), np.asarray(jw)[None])


@pytest.mark.parametrize("kind", ["1x", "2x"])
def test_model_from_info_matches_jax(tmp_path, kind):
    """A 2-member ensemble at the 4 x 8 (ANI-1x) and 8 x 4 (ANI-2x) AEV
    widths: energies and forces of the assembled models, the whole ensemble
    and member 1 alone, and `modules_from_info_file`'s parts."""
    info = write_zoo(tmp_path / "zoo", kind)
    species, coords = _molecs(kind)
    jm = jnc.load_model_from_info(info)
    jnets = jm.potentials["nnp"].neural_networks
    pm = pnc.load_model_from_info(info, device=CPU)
    je, jf = _j_ef(jm, jnp.asarray(species), jnp.asarray(coords))
    pe, pf = energies_and_forces(pm, species, coords)
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), atol=E_ATOL, rtol=0)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), atol=F_ATOL, rtol=0)
    assert pm.atomic_numbers == tuple(int(z) for z in jm.atomic_numbers)
    np.testing.assert_array_equal(pm.energy_shifter.self_energies.numpy(),
                                  np.asarray(jm.energy_shifter.self_energies))

    def same_member(nets, member):
        assert isinstance(nets, AtomicNetworks)
        for pw, jw in zip(list(nets.weights) + list(nets.biases),
                          list(jnets.weights) + list(jnets.biases)):
            np.testing.assert_array_equal(pw.detach().numpy(), np.asarray(jw)[member])

    same_member(pnc.load_model_from_info_file(info, 1, device=CPU).neural_networks, 1)
    parts = pnc.modules_from_info_file(info, strategy="plain", device=CPU)
    assert parts[0].strategy == "plain" and parts[3] == SYMBOLS[kind]
    assert parts[1].total_members_num == 2
    for pw, jw in zip(parts[1].weights, jnets.weights):
        np.testing.assert_array_equal(pw.detach().numpy(), np.asarray(jw))
    same_member(pnc.modules_from_info(pnc.NeurochemInfo.from_info_file(info), 0,
                                      device=CPU)[1], 0)
    zoo = tmp_path / "zoo"
    same_member(pnc.load_member(zoo / "train1", zoo / f"{kind}.params", device=CPU)[1], 1)


def test_bad_activation_raises_in_both(tmp_path):
    net_dir = tmp_path / "networks"
    net_dir.mkdir()
    write_network(net_dir, "H", (8, 6, 1), np.random.RandomState(2), activation=5)
    with pytest.raises(jnc.NeurochemParseError):
        jnc.load_atomic_networks(net_dir, ("H",), 8)
    with pytest.raises(pnc.NeurochemParseError, match="activation index 5"):
        pnc.load_atomic_networks(net_dir, ("H",), 8, device=CPU)
    with pytest.raises(pnc.NeurochemParseError):
        pnc.load_atomic_network(net_dir / "ANN-H.nnf", device=CPU)
    bad = tmp_path / "bad.params"
    bad.write_text("Rcr = 5.2\nEtaR = [16.0, 8.0]\n")
    with pytest.raises(pnc.NeurochemParseError, match="Only single EtaR"):
        pnc.load_aev_constants_and_symbols(bad)


def test_name_resolvers(tmp_path):
    """Without files the resolvers raise as JAX's do, naming the directory;
    with a zoo under `neurochem_dir` they load it."""
    ppaths.set_data_dir(tmp_path)
    jpaths.set_data_dir(tmp_path)
    try:
        root = ppaths.neurochem_dir()
        for fn in (pnc.load_model_from_name, pnc.modules_from_model_name):
            with pytest.raises(FileNotFoundError, match=str(root)):
                fn("ani-1x_8x", device=CPU)
        with pytest.raises(FileNotFoundError):
            jnc.load_model_from_name("ani-1x_8x")
        with pytest.raises(RuntimeError, match="no network"):
            pnc.download_model_parameters()
        with pytest.raises(RuntimeError, match="no network"):
            jnc.download_model_parameters()
        write_zoo(root / "ani-1x_8x", "1x", name="ani-1x_8x")
        assert pnc.download_model_parameters(verbose=False) is None
        species, coords = _molecs("1x", seed=4)
        pm = pnc.load_model_from_name("ani-1x_8x", device=CPU)
        jm = jnc.load_model_from_name("ani-1x_8x")
        np.testing.assert_allclose(
            energies_and_forces(pm, species, coords)[0].numpy(),
            np.asarray(_j_ef(jm, jnp.asarray(species), jnp.asarray(coords))[0]),
            atol=E_ATOL, rtol=0)
        parts = pnc.modules_from_model_name("ani-1x_8x", model_index=1, device=CPU)
        assert isinstance(parts[1], AtomicNetworks) and parts[3] == SYMBOLS["1x"]
    finally:
        ppaths.set_data_dir(None)
        jpaths.set_data_dir(None)


def test_loaders_default_to_cuda(tmp_path, monkeypatch):
    info = write_zoo(tmp_path / "zoo", "1x", members=1)
    params, sae = tmp_path / "zoo" / "1x.params", tmp_path / "zoo" / "sae_linfit.dat"
    member, nets = tmp_path / "zoo" / "train0", tmp_path / "zoo" / "train0" / "networks"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda d: pnc.load_model_from_info(info, device=d),
        lambda d: pnc.load_model_from_info_file(info, 0, device=d),
        lambda d: pnc.modules_from_info_file(info, device=d),
        lambda d: pnc.modules_from_info(pnc.NeurochemInfo.from_info_file(info), 0, device=d),
        lambda d: pnc.load_ensemble(SYMBOLS["1x"], tmp_path / "zoo" / "train", 1, device=d),
        lambda d: pnc.load_atomic_networks(nets, SYMBOLS["1x"], 384, device=d),
        lambda d: pnc.load_atomic_network(nets / "ANN-H.nnf", device=d),
        lambda d: pnc.load_member(member, params, device=d),
        lambda d: pnc.load_aev_computer_and_symbols(params, device=d),
        lambda d: pnc.load_sae(sae, device=d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(None)
        out = call(CPU)
        module = out[0] if isinstance(out, tuple) else out
        assert next(iter(module.buffers() if not list(module.parameters())
                         else module.parameters())).device == torch.device(CPU)
