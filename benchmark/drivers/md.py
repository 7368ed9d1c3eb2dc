"""MD traffic: NVE stretches through `MolecularDynamics` from one set-up state.

Traffic keys: ``box_atoms`` and ``box_seed`` (`generators.water_box`: the
same box for every ``--seed``, so that the program's capacities, measured
from the first configuration, and with them the work, are the same in
every run), ``temperature_K`` (the velocities, drawn from ``--seed``), ``stretch_steps`` (steps a unit runs; every
stretch starts again from the state that set-up made, since random weights
heat a box until a static capacity overflows), ``reference_block`` (the
reference's center block).

The check: the plain reference integrates the same stretch from the same
coordinates and velocities (velocity Verlet, its own float32 forces at
every step); ``pos_rms_gap_A`` is the root mean square over atoms of the
distance between the end positions.  At the program's end positions the
float64 reference's forces give ``force_rms_gap``, the root mean square of
the atoms' force differences over that of the forces.  (The largest gap of
a force component is not compared: it swings with the pairs that random
weights drive together, and the control reads under three times what sound
runs do.)  A stretch that ends with non-finite forces or the overflow flag
set fails.
"""

import typing as tp

import torch

from benchmark import generators, weights, yardstick
from benchmark.drivers import Driver, synchronize
from benchmark.reference.model import ACCEL_UNIT, Reference, constants


class MD(Driver):
    unit = "steps"

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device) -> None:
        super().__init__(config, traffic, seed, device)
        species, coords, box = generators.water_box(traffic["box_atoms"], traffic["box_seed"])
        elements = constants()["elements"]
        mass = {e["znumber"]: e["mass"] for e in elements.values()}
        masses = torch.tensor([mass[int(z)] for z in species], dtype=torch.float32)
        velocities = generators.maxwell_boltzmann(seed, masses.numpy(), traffic["temperature_K"])
        self.znums = torch.as_tensor(species, device=device)
        self.x0 = torch.as_tensor(coords, device=device)
        self.v0 = torch.as_tensor(velocities, device=device)
        self.box = box
        self.masses = masses.to(device)
        self.steps_per_unit = int(traffic["stretch_steps"])
        self.dt = float(config["md"]["timestep_fs"])
        self.state_dict = weights.random_state_dict(config, config["members"], seed, device)
        radii = {"refresh": self._build_radius()}
        for p in config.get("potentials", []):
            radii[p["name"]] = float(p["cutoff"])
        self.step_work = yardstick.count_work(config, self.znums, self.x0, box, None, radii)
        self.kept: tp.Dict[str, torch.Tensor] = {}

    def _build_radius(self) -> float:
        cut = max([self.config["aev"]["radial"]["cutoff"]]
                  + [float(p["cutoff"]) for p in self.config.get("potentials", [])])
        return cut + float(self.config["md"]["skin"])

    def setup(self) -> None:
        from torchani_tpu_torch import convert, models
        from torchani_tpu_torch.md import MolecularDynamics

        model = getattr(models, self.config["factory"])(device=self.device)
        convert.load_state_dict(model, self.state_dict)
        cell = torch.eye(3, device=self.device) * self.box
        self.md = MolecularDynamics(
            model, self.znums[None], cell=cell, pbc=True, skin=self.config["md"]["skin"],
            timestep_fs=self.dt, device=self.device,
        )
        state = self.md.init(self.x0)
        self.state0 = state.replace(velocities=self.v0.clone())
        self.bad = torch.zeros((), dtype=torch.int64, device=self.device)
        self.step()  # warm-up: every shape of a stretch, a rebuild among them
        self.finish()
        self.reset()
        self.bad.zero_()

    def step(self) -> None:
        state = self.md.run_nve(self.state0, self.steps_per_unit)
        self.bad += (state.overflow | ~torch.isfinite(state.forces).all()).to(torch.int64)
        self.attempted += 1
        self.counters["rebuilds"] = (self.counters.get("rebuilds", 0)
                                     + state.rebuilds - self.state0.rebuilds)
        work = {k: v * self.steps_per_unit for k, v in self.step_work.items()}
        work["steps"] = float(self.steps_per_unit)
        self.work.append(work)
        self.last = state

    def finish(self) -> None:
        synchronize(self.device)
        self.failed = int(self.bad)

    def end_to_end(self, window_s: float) -> tp.Dict[str, float]:
        steps = self.attempted * self.steps_per_unit
        return {"ns_per_day": steps * self.dt * 1e-6 / window_s * 86400.0}

    def release(self) -> None:
        self.kept = {"coords": self.last.coords.clone(), "forces": self.last.forces.clone()}
        del self.md, self.state0, self.last

    # ---- the check ----
    def _forces(self, ref: Reference, coords: torch.Tensor) -> torch.Tensor:
        box = torch.full((3,), self.box, device=self.device)
        return ref.system_energy_and_forces(
            self.znums, coords, box, block=int(self.traffic["reference_block"]))[1]

    def _integrate(self, ref: Reference) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """The stretch by velocity Verlet with ``ref``'s forces: the end
        positions and forces."""
        inv_m = (ACCEL_UNIT / self.masses)[:, None]
        x, v = self.x0.clone(), self.v0.clone()
        f = self._forces(ref, x)
        for _ in range(self.steps_per_unit):
            v = v + 0.5 * self.dt * f * inv_m
            x = x + self.dt * v
            f = self._forces(ref, x)
            v = v + 0.5 * self.dt * f * inv_m
        return x, f

    def control(self, variant: str = "tf32") -> tp.Dict[str, torch.Tensor]:
        if variant != "tf32":
            raise ValueError(f"no {variant!r} control for MD")
        x, f = self._integrate(Reference(self.config, self.state_dict, precision="tf32"))
        return {"coords": x, "forces": f}

    def readings(self, outputs=None) -> tp.Dict[str, float]:
        out = self.kept if outputs is None else outputs
        x_ref, _ = self._integrate(Reference(self.config, self.state_dict))
        f_at = self._forces(Reference(self.config, self.state_dict, "float64"), out["coords"])
        df = out["forces"].double() - f_at
        return {
            "pos_rms_gap_A": float((out["coords"] - x_ref).norm(dim=-1).pow(2).mean().sqrt()),
            "force_rms_gap": float(df.norm(dim=-1).pow(2).mean().sqrt()
                                   / f_at.norm(dim=-1).pow(2).mean().sqrt()),
        }


DRIVER = MD
