"""Energies-and-forces traffic: one client screening batches of conformers.

Traffic keys: ``batch`` conformers of ``atoms_min`` to ``atoms_max`` atoms
(`generators.chain_batch`, the atoms split equally among ``elements``),
``pool`` distinct batches made at set-up and sent in turn,
``check_batches`` of them (drawn from the seed) whose last answers are
checked, ``reference_chunk`` molecules per reference pass.

Set-up sizes the model's angular table to the pool with the port's
`training.tune_angular_capacity`, as a data pipeline does: under the default
capacity a conformer with more neighbors within the angular cutoff comes out
NaN.

A unit sends one batch from the host to `grad.energies_and_forces` and waits
for its energies and forces on the host: the closed loop of a screening
script.  Its latency runs from the call to both results on the host.

The check: ``force_gap`` is the largest difference of a force component
from the float64 reference's over the largest reference force, over the
checked batches.  The energies are not compared: their float32 totals (up
to thousands of Hartree) round by more than the control moves them; a
batch with a non-finite energy fails.
"""

import time
import typing as tp

import numpy as np
import torch

from benchmark import generators, weights, yardstick
from benchmark.drivers import Driver, host
from benchmark.reference.model import Reference


class EnergiesForces(Driver):
    unit = "batches"

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device) -> None:
        super().__init__(config, traffic, seed, device)
        self.pool = []
        self.pool_work = []
        for k in range(int(traffic["pool"])):
            species, coords = generators.chain_batch(
                seed, 10 + k, traffic["batch"], traffic["atoms_min"], traffic["atoms_max"],
                traffic["elements"])
            sp, cr = torch.as_tensor(species), torch.as_tensor(coords)
            self.pool.append((host(sp, device), host(cr, device)))
            mol = torch.arange(sp.shape[0])[:, None].expand_as(sp)
            mol = torch.where(sp >= 0, mol, -1).reshape(-1)
            work = yardstick.count_work(config, sp.reshape(-1).to(device),
                                        cr.reshape(-1, 3).to(device), None, mol.to(device), {})
            work["batches"] = 1.0
            work["conformers"] = float(sp.shape[0])
            self.pool_work.append(work)
        picks = generators.rng(seed, 2).choice(len(self.pool), int(traffic["check_batches"]),
                                               replace=False)
        self.checked = sorted(int(k) for k in picks)
        self.state_dict = weights.random_state_dict(config, config["members"], seed, device)
        self.kept: tp.Dict[int, tp.Tuple[torch.Tensor, torch.Tensor]] = {}
        self.latencies: tp.List[float] = []

    def setup(self) -> None:
        from torchani_tpu_torch import convert, models
        from torchani_tpu_torch.grad import energies_and_forces
        from torchani_tpu_torch.training import tune_angular_capacity

        model = getattr(models, self.config["factory"])(device=self.device)
        convert.load_state_dict(model, self.state_dict)
        self.model = tune_angular_capacity(
            model, [{"species": sp, "coordinates": cr} for sp, cr in self.pool])
        self.energies_and_forces = energies_and_forces
        for _ in self.pool:  # warm-up: every batch of the pool once
            self.step()
        self.finish()
        self.reset()
        self.latencies = []

    def step(self) -> None:
        k = self.attempted % len(self.pool)
        species, coords = self.pool[k]
        t0 = time.perf_counter()
        e, f = self.energies_and_forces(self.model, species, coords)
        e, f = e.cpu(), f.cpu()
        self.latencies.append(time.perf_counter() - t0)
        self.attempted += 1
        self.failed += int(not bool(torch.isfinite(e).all()))
        self.work.append(self.pool_work[k])
        if k in self.checked:
            self.kept[k] = (e, f)

    def finish(self) -> None:
        pass  # every unit ends with its results on the host

    def end_to_end(self, window_s: float) -> tp.Dict[str, float]:
        n = self.traffic["batch"]
        return {
            "conformers_per_s": self.attempted * n / window_s,
            "ef_batch_ms_p95": float(np.percentile(np.asarray(self.latencies) * 1e3, 95)),
        }

    def release(self) -> None:
        del self.model

    def _reference(self, precision: str) -> tp.Dict[int, tp.Tuple[torch.Tensor, torch.Tensor]]:
        ref = Reference(self.config, self.state_dict, precision=precision)
        out = {}
        for k in self.checked:
            species, coords = self.pool[k]
            e, f = ref.batch_energies_and_forces(
                species.to(self.device), coords.to(self.device),
                chunk=int(self.traffic["reference_chunk"]))
            out[k] = (e.cpu(), f.cpu())
        return out

    def control(self, variant: str = "tf32") -> tp.Dict[int, tp.Tuple[torch.Tensor, torch.Tensor]]:
        if variant != "tf32":
            raise ValueError(f"no {variant!r} control for E+F")
        return self._reference("tf32")

    def readings(self, outputs=None) -> tp.Dict[str, float]:
        out = self.kept if outputs is None else outputs
        if any(k not in out for k in self.checked):
            return {"force_gap": float("nan")}
        ref = self._reference("float64")
        gaps = [float((out[k][1].double() - ref[k][1]).abs().max() / ref[k][1].abs().max())
                for k in self.checked]
        # np.max keeps a NaN, where max() would drop it
        return {"force_gap": float(np.max(gaps))}


DRIVER = EnergiesForces
