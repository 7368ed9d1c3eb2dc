"""Plain PyTorch reference of the benchmark's ANI models.

ANI-2x (Devereux et al., JCTC 16, 4192 (2020)) and ANI-2dr (TorchANI 2.0's
``simple_ani`` networks with GFN2-xTB repulsion and D3(BJ) dispersion),
written from the published equations in float32, with no kernel, cache or
padded table.  It imports nothing of the measured program: its inputs are
the benchmark's configuration (`benchmark/configs`), a state dict in the
reference key scheme (the same tensors the program loads) and the published
constants in ``constants.json``.

- Neighbor pairs: every directed pair within a cutoff, by brute force (row
  blocks against all atoms, minimum image in an orthorhombic box).
- AEV: radial ``0.25 exp(-eta (r - Rs)^2) fc(r)`` per neighbor species;
  angular ``2 ((1 + cos(theta - theta_s)) / 2)^zeta exp(-eta ((r_j + r_k) / 2
  - Rs)^2) fc(r_j) fc(r_k)`` with ``theta = acos(0.95 cos theta_jik)``, per
  unordered species pair, shift-major and section-minor; one triple per
  unordered neighbor pair of a center.
- Networks: each element's MLP at its own widths, every member, averaged.
- xTB repulsion ``Y_ab / r exp(-sqrt(alpha_a alpha_b) r^k)`` (k = 1 for H-H,
  1.5 otherwise) and D3(BJ) two-body dispersion with the 5 x 5 reference-C6
  interpolation, each times the smooth cutoff at its own radius, half of
  each directed pair to its center.

``precision="tf32"`` is the control of the output checks: the networks'
matrix products in TF32 (on the card through cuBLAS's TF32 mode; on the CPU
by rounding both operands to TF32's 10-bit mantissa).  ``"float64"`` is a
second witness for finding where a difference comes from.
"""

import contextlib
import json
import math
import typing as tp
from pathlib import Path

import torch

Tensor = torch.Tensor

ANGSTROM_TO_BOHR = 1.8897261258369282
#: Hartree / (Angstrom amu) -> Angstrom / fs^2, and Boltzmann's constant in
#: Hartree / K (CODATA)
ACCEL_UNIT = 0.2625499785
KB_HARTREE = 3.166811563e-06


def constants() -> dict:
    with open(Path(__file__).with_name("constants.json")) as f:
        return json.load(f)


def linspace(start: float, stop: float, steps: int) -> tp.List[float]:
    """``steps`` points from ``start``, the endpoint excluded."""
    return [start + (stop - start) / steps * j for j in range(steps)]


def aev_constants(aev: dict) -> tp.Dict[str, tp.List[float]]:
    """The AEV's shifts and sections from the configuration's ``aev``."""
    rad, ang = aev["radial"], aev["angular"]
    se = ang["num_sections"]
    return {
        "radial_shifts": linspace(rad["start"], rad["cutoff"], rad["num_shifts"]),
        "angular_shifts": linspace(ang["start"], ang["cutoff"], ang["num_shifts"]),
        "sections": linspace(math.pi / se / 2, math.pi + math.pi / se / 2, se),
    }


def round_tf32(x: Tensor) -> Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, round to nearest even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, in the forward and in
    every backward product, as TF32 tensor cores compute them."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor) -> Tensor:
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g: Tensor) -> tp.Tuple[Tensor, Tensor]:
        a, b = ctx.saved_tensors
        ga = _TF32MatMul.apply(g, b.transpose(-1, -2)).sum_to_size(a.shape)
        gb = _TF32MatMul.apply(a.transpose(-1, -2), g).sum_to_size(b.shape)
        return ga, gb


def cutoff_fn(kind: str, r: Tensor, rc: float) -> Tensor:
    if kind == "cosine":
        return 0.5 * torch.cos(r * (math.pi / rc)) + 0.5
    if kind == "smooth":
        return torch.exp(1 - 1 / torch.clamp(1 - (r / rc) ** 2, min=1e-10))
    raise ValueError(f"unknown cutoff function {kind!r}")


class Pairs(tp.NamedTuple):
    """Directed pairs ``i -> j`` sorted by ``i``; ``image`` is the integer
    multiple of the box lengths added to ``x_j - x_i`` (zeros without a
    box)."""

    i: Tensor
    j: Tensor
    image: Tensor


def find_pairs(
    coords: Tensor, cutoff: float, box: tp.Optional[Tensor] = None,
    molecule: tp.Optional[Tensor] = None, block: int = 1024,
) -> Pairs:
    """Every directed pair closer than ``cutoff``: within a molecule
    (``molecule`` gives each atom's, -1 for padding) or, with ``box`` (the
    orthorhombic box's lengths, each more than twice the cutoff), between
    minimum images."""
    x = coords.detach()
    n = x.shape[0]
    found = []
    for a in range(0, n, block):
        xi = x[a:a + block]
        d = x[None, :, :] - xi[:, None, :]
        if box is not None:
            img = -torch.round(d / box)
            d = d + img * box
        r2 = (d * d).sum(-1)
        ok = r2 < cutoff * cutoff
        rows = torch.arange(a, a + xi.shape[0], device=x.device)
        ok &= rows[:, None] != torch.arange(n, device=x.device)[None, :]
        if molecule is not None:
            mi = molecule[a:a + block]
            ok &= (mi[:, None] == molecule[None, :]) & (mi[:, None] >= 0)
        ii, jj = torch.nonzero(ok, as_tuple=True)
        image = img[ii, jj] if box is not None else torch.zeros((ii.numel(), 3), device=x.device)
        found.append((ii + a, jj, image))
    return Pairs(*(torch.cat(t) for t in zip(*found)))


def pair_vectors(coords: Tensor, pairs: Pairs, box: tp.Optional[Tensor]) -> Tensor:
    d = coords.index_select(0, pairs.j) - coords.index_select(0, pairs.i)
    if box is not None:
        d = d + pairs.image * box
    return d


class Reference:
    """One configuration's model from a reference-scheme state dict.

    Species are atomic numbers throughout (-1 padding).
    `system_energy_and_forces` takes flattened atoms with the molecule of
    each (a periodic box is one molecule); the batch methods take padded
    ``(molecules, atoms)`` batches.
    """

    def __init__(self, config: dict, state_dict: tp.Mapping[str, Tensor],
                 precision: str = "float32") -> None:
        if precision not in ("float32", "tf32", "float64"):
            raise ValueError(f"precision must be float32, tf32 or float64, not {precision!r}")
        self.precision = precision
        self.dtype = dtype = torch.float64 if precision == "float64" else torch.float32
        state_dict = {k: v.to(dtype) if v.is_floating_point() else v
                      for k, v in state_dict.items()}
        self.config = config
        self.symbols = list(config["symbols"])
        consts = constants()
        elements = consts["elements"]
        dev = next(iter(state_dict.values())).device
        self.device = dev
        self.znum_to_species = torch.full((128,), -1, dtype=torch.int64, device=dev)
        for s, sym in enumerate(self.symbols):
            self.znum_to_species[elements[sym]["znumber"]] = s
        aev = config["aev"]
        pre = "potentials.nnp.aev_computer."
        self.cutoff_kind = aev["cutoff_fn"]
        self.rad_cut = float(aev["radial"]["cutoff"])
        self.ang_cut = float(aev["angular"]["cutoff"])
        self.rad_eta = state_dict[pre + "radial.eta"].reshape(())
        self.rad_shifts = state_dict[pre + "radial.shifts"].reshape(-1)
        self.ang_eta = state_dict[pre + "angular.eta"].reshape(())
        self.zeta = state_dict[pre + "angular.zeta"].reshape(())
        self.ang_shifts = state_dict[pre + "angular.shifts"].reshape(-1)
        self.sections = state_dict[pre + "angular.sections"].reshape(-1)
        s = len(self.symbols)
        iu = torch.triu_indices(s, s)
        slot = torch.empty((s, s), dtype=torch.int64)
        slot[iu[0], iu[1]] = torch.arange(iu.shape[1])
        slot[iu[1], iu[0]] = torch.arange(iu.shape[1])
        self.pair_slot = slot.reshape(-1).to(dev)
        self.num_pairs = iu.shape[1]
        self.self_energies = state_dict["energy_shifter.self_energies"].reshape(-1)
        self.act = config["activation"]
        # each element's layers, members stacked: W (E, in, out), b (E, out)
        self.layers: tp.List[tp.List[tp.Tuple[Tensor, tp.Optional[Tensor]]]] = []
        members = int(config["members"])
        net = "potentials.nnp.neural_networks."
        for sym in self.symbols:
            depth = len(config["widths"][sym]) + 1
            layers = []
            for li in range(depth):
                name = "final_layer" if li == depth - 1 else f"layers.{li}"
                keys = (
                    [f"{net}members.{e}.atomics.{sym}.{name}" for e in range(members)]
                    if members > 1 else [f"{net}atomics.{sym}.{name}"]
                )
                w = torch.stack([state_dict[k + ".weight"].transpose(0, 1) for k in keys])
                b = (torch.stack([state_dict[k + ".bias"] for k in keys])
                     if keys[0] + ".bias" in state_dict else None)
                layers.append((w, b))
            self.layers.append(layers)
        self.potentials = {p["name"]: p for p in config.get("potentials", [])}
        el = [elements[sym] for sym in self.symbols]

        def table(f) -> Tensor:
            return torch.tensor([[f(a, b) for b in el] for a in el], dtype=dtype, device=dev)

        if "repulsion_xtb" in self.potentials:
            self.rep_y = table(lambda a, b: a["xtb_repulsion_yeff"] * b["xtb_repulsion_yeff"])
            self.rep_sqrt_alpha = table(
                lambda a, b: math.sqrt(a["xtb_repulsion_alpha"] * b["xtb_repulsion_alpha"]))
            self.rep_k = table(lambda a, b: 1.0 if a["znumber"] == b["znumber"] == 1 else 1.5)
        if "dispersion_d3" in self.potentials:
            d3 = self.potentials["dispersion_d3"]
            par = consts["d3bj"][d3["functional"]]
            self.d3 = dict(par, k1=consts["d3_k1"], k2=consts["d3_k2"], k3=consts["d3_k3"])
            self.d3_rcov = table(lambda a, b: (a["covalent_radius"] + b["covalent_radius"])
                                 * ANGSTROM_TO_BOHR)
            self.d3_sqrt_q = table(
                lambda a, b: a["sqrt_empirical_charge"] * b["sqrt_empirical_charge"])

            def grid(name: str) -> Tensor:
                return torch.tensor(
                    [[consts[name][f"{a}-{b}"] for b in self.symbols] for a in self.symbols],
                    dtype=dtype, device=dev,
                ).reshape(s, s, 25)

            self.c6_ref, self.cn_ref_a, self.cn_ref_b = (
                grid("c6_ref"), grid("cn_ref_a"), grid("cn_ref_b"))


    # ---- pieces ----
    @contextlib.contextmanager
    def _matmul_mode(self):
        if self.precision == "tf32" and self.device.type == "cuda":
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                yield
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old
        else:
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                yield
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old

    def _mm(self, x: Tensor, w: Tensor) -> Tensor:
        if self.precision == "tf32" and self.device.type != "cuda":
            return _TF32MatMul.apply(x, w)
        return torch.matmul(x, w)

    def species_of(self, znums: Tensor) -> Tensor:
        return torch.where(znums >= 0, self.znum_to_species[znums.clamp(min=0)], -1)

    def max_cutoff(self) -> float:
        cut = max(self.rad_cut, self.ang_cut)
        for p in self.potentials.values():
            cut = max(cut, float(p["cutoff"]))
        return cut

    def aev(self, elem: Tensor, centers: Tensor, pairs: Pairs, d: Tensor, r: Tensor) -> Tensor:
        """AEV rows ``(len(centers), F)`` of the given centers, from their
        directed pairs (``pairs.i`` indexes ``centers``'s positions)."""
        nc = centers.shape[0]
        s = len(self.symbols)
        sj = elem.index_select(0, pairs.j)
        # radial
        rsel = r < self.rad_cut
        rr, ri, rs = r[rsel], pairs.i[rsel], sj[rsel]
        terms = 0.25 * torch.exp(-self.rad_eta * (rr[:, None] - self.rad_shifts) ** 2)
        terms = terms * cutoff_fn(self.cutoff_kind, rr, self.rad_cut)[:, None]
        nr = self.rad_shifts.numel()
        radial = torch.zeros((nc * s, nr), dtype=terms.dtype, device=terms.device)
        radial = radial.index_add(0, ri * s + rs, terms).reshape(nc, s * nr)
        # angular: each unordered pair of a center's neighbors once
        asel = torch.nonzero(r < self.ang_cut).squeeze(1)
        ai = pairs.i.index_select(0, asel)
        counts = torch.bincount(ai, minlength=nc)
        kmax = int(counts.max()) if counts.numel() else 0
        nz = self.ang_shifts.numel() * self.sections.numel()
        angular = torch.zeros((nc * self.num_pairs, nz), dtype=radial.dtype, device=radial.device)
        if kmax >= 2:
            starts = torch.cumsum(counts, 0) - counts
            rank = torch.arange(asel.numel(), device=asel.device) - starts.index_select(0, ai)
            table = torch.full((nc, kmax), -1, dtype=torch.int64, device=asel.device)
            table[ai, rank] = asel
            jj, kk = torch.triu_indices(kmax, kmax, 1, device=asel.device)
            p1, p2 = table[:, jj], table[:, kk]
            c, t = torch.nonzero((p1 >= 0) & (p2 >= 0), as_tuple=True)
            p1, p2 = p1[c, t], p2[c, t]
            d1, d2 = d.index_select(0, p1), d.index_select(0, p2)
            r1, r2 = r.index_select(0, p1), r.index_select(0, p2)
            cos = (d1 * d2).sum(-1) / (r1 * r2)
            theta = torch.acos(0.95 * cos)
            f1 = ((1 + torch.cos(theta[:, None] - self.sections)) / 2) ** self.zeta
            f2 = torch.exp(-self.ang_eta * ((r1 + r2)[:, None] / 2 - self.ang_shifts) ** 2)
            fc = (cutoff_fn(self.cutoff_kind, r1, self.ang_cut)
                  * cutoff_fn(self.cutoff_kind, r2, self.ang_cut))
            terms = 2 * f2[:, :, None] * f1[:, None, :] * fc[:, None, None]
            slot = self.pair_slot.index_select(0, sj.index_select(0, p1) * s + sj.index_select(0, p2))
            angular = angular.index_add(0, c * self.num_pairs + slot, terms.reshape(-1, nz))
        return torch.cat([radial, angular.reshape(nc, self.num_pairs * nz)], dim=1)

    def atomic_network_energies(self, elem: Tensor, aev: Tensor) -> Tensor:
        out = aev.new_zeros(elem.shape[0])
        with self._matmul_mode():
            for s, layers in enumerate(self.layers):
                rows = torch.nonzero(elem == s).squeeze(1)
                if rows.numel() == 0:
                    continue
                h = aev.index_select(0, rows)[None]
                for li, (w, b) in enumerate(layers):
                    h = self._mm(h, w)
                    if b is not None:
                        h = h + b[:, None, :]
                    if li + 1 < len(layers):
                        h = (torch.nn.functional.celu(h, alpha=0.1) if self.act == "celu"
                             else torch.nn.functional.gelu(h))
                out = out.index_add(0, rows, h[..., 0].mean(0))
        return out

    def repulsion(self, elem: Tensor, pairs: Pairs, r: Tensor) -> Tensor:
        """Half of each directed pair's energy, per pair."""
        p = self.potentials["repulsion_xtb"]
        keep = r < p["cutoff"]
        si, sj = elem.index_select(0, pairs.i), elem.index_select(0, pairs.j)
        rb = torch.clamp(r, min=1e-7) * ANGSTROM_TO_BOHR
        e = (self.rep_y[si, sj] / rb) * torch.exp(-self.rep_sqrt_alpha[si, sj] * rb ** self.rep_k[si, sj])
        e = e * cutoff_fn(p["cutoff_fn"], r, p["cutoff"])
        return torch.where(keep, 0.5 * e, 0.0)

    def dispersion(self, elem: Tensor, pairs: Pairs, r: Tensor, num_atoms: int) -> Tensor:
        """Half of each directed pair's D3(BJ) energy, per pair; the
        coordination numbers count the pairs within D3's cutoff."""
        p, c = self.potentials["dispersion_d3"], self.d3
        keep = r < p["cutoff"]
        si, sj = elem.index_select(0, pairs.i), elem.index_select(0, pairs.j)
        rb = torch.clamp(r, min=1e-7) * ANGSTROM_TO_BOHR
        count = 1.0 / (1.0 + torch.exp(-c["k1"] * (c["k2"] * self.d3_rcov[si, sj] / rb - 1.0)))
        cn = torch.zeros(num_atoms, dtype=r.dtype, device=r.device).index_add(
            0, pairs.i, torch.where(keep, count, 0.0))
        c6ref = self.c6_ref[si, sj]
        lw = torch.exp(-c["k3"] * ((cn.index_select(0, pairs.i)[:, None] - self.cn_ref_a[si, sj]) ** 2
                                   + (cn.index_select(0, pairs.j)[:, None] - self.cn_ref_b[si, sj]) ** 2))
        lw = torch.where(c6ref > 0, lw, 0.0)
        z, w = (c6ref * lw).sum(-1) + 1e-35, lw.sum(-1) + 1e-35
        c6 = torch.where(w > 1e-12, z / torch.clamp(w, min=1e-12), 1.0)
        sqrt_q = self.d3_sqrt_q[si, sj]
        c8 = 3 * c6 * sqrt_q
        damp = c["a1"] * torch.sqrt(3 * sqrt_q) + c["a2"]
        e = c["s6"] * c6 / (rb ** 6 + damp ** 6) + c["s8"] * c8 / (rb ** 8 + damp ** 8)
        e = -e * cutoff_fn(p["cutoff_fn"], r, p["cutoff"])
        return torch.where(keep, 0.5 * e, 0.0)

    # ---- whole systems ----
    def local_energies(self, elem: Tensor, coords: Tensor, pairs: Pairs,
                       box: tp.Optional[Tensor], lo: int, hi: int) -> Tensor:
        """Atomic energies of centers ``lo:hi`` from their networks and
        their pairs' repulsion (no self energies, no dispersion)."""
        a = torch.searchsorted(pairs.i, torch.tensor([lo, hi], device=pairs.i.device))
        sub = Pairs(*(t[int(a[0]):int(a[1])] for t in pairs))
        d = pair_vectors(coords, sub, box)
        r = torch.linalg.vector_norm(d, dim=-1)
        local = Pairs(sub.i - lo, sub.j, sub.image)
        centers = torch.arange(lo, hi, device=coords.device)
        e = self.atomic_network_energies(elem[lo:hi], self.aev(elem, centers, local, d, r))
        if "repulsion_xtb" in self.potentials:
            e = e.index_add(0, local.i, self.repulsion(elem, sub, r))
        return e

    def system_energy_and_forces(
        self, znums: Tensor, coords: Tensor, box: tp.Optional[Tensor] = None,
        molecule: tp.Optional[Tensor] = None, num_molecules: int = 1, block: int = 8192,
    ) -> tp.Tuple[Tensor, Tensor]:
        """Energies ``(num_molecules,)`` (summed in float64) and forces
        ``(N, 3)`` of flattened atoms (atomic numbers ``znums``, -1 padding),
        in center blocks of ``block`` atoms, each block's graph freed after
        its backward."""
        elem = self.species_of(znums)
        if molecule is None:
            molecule = torch.where(elem >= 0, 0, -1)
        x = coords.detach().to(self.dtype).requires_grad_(True)
        pairs = find_pairs(x, self.max_cutoff(), box, None if box is not None else molecule)
        valid = elem >= 0
        mol = molecule.clamp(min=0)
        # each molecule's sum in float64: a float32 total of thousands of
        # Hartree would round by more than the networks' part is compared to
        energies = torch.zeros(num_molecules, dtype=torch.float64, device=x.device)
        grad = torch.zeros_like(x)
        n = x.shape[0]
        if "dispersion_d3" in self.potentials:
            block = n  # D3's coordination numbers couple every center
        for lo in range(0, n, block):
            hi = min(n, lo + block)
            e = self.local_energies(elem, x, pairs, box, lo, hi)
            if "dispersion_d3" in self.potentials:
                d = pair_vectors(x, pairs, box)
                r = torch.linalg.vector_norm(d, dim=-1)
                e = e.index_add(0, pairs.i, self.dispersion(elem, pairs, r, n))
            e = torch.where(valid[lo:hi], e, 0.0)
            (g,) = torch.autograd.grad(e.sum(), x)
            grad += g
            energies = energies.index_add(0, mol[lo:hi], e.detach().double())
        sae = torch.where(valid, self.self_energies[elem.clamp(min=0)], 0.0)
        energies = energies.index_add(0, mol, sae.double())
        return energies, -grad

    def batch_energies_and_forces(
        self, znums: Tensor, coords: Tensor, chunk: int = 512,
    ) -> tp.Tuple[Tensor, Tensor]:
        """Energies ``(M,)`` and forces ``(M, A, 3)`` of a padded batch of
        molecules, in chunks of ``chunk`` molecules."""
        m, a = znums.shape
        energies, forces = [], []
        for lo in range(0, m, chunk):
            z = znums[lo:lo + chunk]
            c = coords[lo:lo + chunk]
            mol = torch.arange(z.shape[0], device=z.device)[:, None].expand_as(z)
            mol = torch.where(z >= 0, mol, -1)
            e, f = self.system_energy_and_forces(
                z.reshape(-1), c.reshape(-1, 3), None, mol.reshape(-1), z.shape[0])
            energies.append(e)
            forces.append(f.reshape(z.shape[0], a, 3))
        return torch.cat(energies), torch.cat(forces)

    def batch_energies_forces_graph(self, znums: Tensor, coords: Tensor,
                                    self_energies: bool = True) -> tp.Tuple[Tensor, Tensor]:
        """Energies (summed in float64; without the self energies where
        ``self_energies`` is False) and forces of a (small) padded batch
        with their graphs kept (forces by ``create_graph=True``), for a loss
        on both."""
        m, a = znums.shape
        elem = self.species_of(znums).reshape(-1)
        mol = torch.arange(m, device=znums.device)[:, None].expand(m, a).reshape(-1)
        mol = torch.where(elem >= 0, mol, -1)
        x = coords.reshape(-1, 3).detach().to(self.dtype).requires_grad_(True)
        pairs = find_pairs(x, self.max_cutoff(), None, mol)
        e = self.local_energies(elem, x, pairs, None, 0, x.shape[0])
        if "dispersion_d3" in self.potentials:
            r = torch.linalg.vector_norm(pair_vectors(x, pairs, None), dim=-1)
            e = e.index_add(0, pairs.i, self.dispersion(elem, pairs, r, x.shape[0]))
        e = torch.where(elem >= 0, e, 0.0)
        sae = torch.where((elem >= 0) & self_energies, self.self_energies[elem.clamp(min=0)], 0.0)
        energies = torch.zeros(m, dtype=torch.float64, device=e.device).index_add(
            0, mol.clamp(min=0), e.double() + sae.double())
        (g,) = torch.autograd.grad(energies.sum(), x, create_graph=True)
        return energies, -g.reshape(m, a, 3)

    def parameters(self) -> tp.List[Tensor]:
        """The networks' leaves, element by element: each layer's weight
        (E, in, out), then its bias."""
        out = []
        for layers in self.layers:
            for w, b in layers:
                out.append(w)
                if b is not None:
                    out.append(b)
        return out
