"""Force-training traffic: `training.make_train_step` over batches of conformers.

Traffic keys: ``batch``, ``atoms_min``, ``atoms_max``, ``elements`` and
``pool`` as for the E+F traffic (and the angular table sized to the pool in
the same way), ``members`` (the trained networks: one
member, as ``ANI2x(model_index=0)`` gives it), ``lr`` and ``weight_decay``
(AdamW), ``force_weight``, ``energy_sd`` and ``force_sd`` (the targets,
`generators.force_labels`), ``reference_chunk``.  The model trains with its
self energies off and the targets hold none, as ANI models are fitted to
energies with the self energies subtracted: float32 totals of thousands of
Hartree would round by more than the networks' part is compared to.

Set-up builds the one training state, runs its first three steps on three
different batches through the same step function and feed as the window,
and hands that state on: the window's steps continue from the fourth.

The check follows those three steps with the plain reference (its own
loss, gradients by autograd, AdamW written out) from the same weights and
batches.  Per leaf (an element's layer's weight or bias), it compares the
norm of the first gradient as AdamW holds it after one step (its first
moment over ``1 - beta1``) and the norm of each leaf's change after three
steps, by the gap between the two norms over the larger of the reference
leaf's norm and the median leaf's; ``loss_gap`` is the largest relative gap
of the three losses and ``loss1_gap`` the first step's; ``grad_diff`` is
the median over leaves of the norm of the first gradient's difference from
the reference's over the reference's norm, element by element.  Leaves whose reference gradient is under a
thousandth of the median leaf's (rounding noise under AdamW) are left out
of both.  A step whose loss is not finite fails.
"""

import typing as tp

import numpy as np
import torch

from benchmark import generators, weights, yardstick
from benchmark.drivers import Driver, host, synchronize
from benchmark.reference.model import Reference

#: steps the check follows
CHECKED_STEPS = 3


def relative_gaps(a: tp.Sequence[float], b: tp.Sequence[float], keep: np.ndarray) -> float:
    """The largest ``|a - b| / max(b, median(b))`` over the kept leaves."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    scale = np.maximum(b, np.median(b))
    return float(np.max(np.abs(a - b)[keep] / scale[keep]))


class Training(Driver):
    unit = "steps"

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device) -> None:
        super().__init__(config, traffic, seed, device)
        self.members = int(traffic["members"])
        self.pool, self.pool_work = [], []
        for k in range(int(traffic["pool"])):
            species, coords = generators.chain_batch(
                seed, 10 + k, traffic["batch"], traffic["atoms_min"], traffic["atoms_max"],
                traffic["elements"])
            energies, forces = generators.force_labels(
                seed, 100 + k, species, traffic["energy_sd"], traffic["force_sd"])
            batch = {
                "species": torch.as_tensor(species), "coordinates": torch.as_tensor(coords),
                "energies": torch.as_tensor(energies), "forces": torch.as_tensor(forces),
            }
            self.pool.append({k_: host(v, device) for k_, v in batch.items()})
            sp = batch["species"]
            mol = torch.where(sp >= 0, torch.arange(sp.shape[0])[:, None].expand_as(sp), -1)
            work = yardstick.count_work(config, sp.reshape(-1).to(device),
                                        batch["coordinates"].reshape(-1, 3).to(device), None,
                                        mol.reshape(-1).to(device), {})
            work["steps"] = 1.0
            work["conformers"] = float(sp.shape[0])
            self.pool_work.append(work)
        self.state_dict = weights.random_state_dict(config, self.members, seed, device)
        self.kept: tp.Dict[str, tp.Any] = {}
        self.next_batch = 0

    def _leaves(self, ws: tp.Sequence[torch.Tensor], bs: tp.Optional[tp.Sequence[torch.Tensor]]
                ) -> tp.List[torch.Tensor]:
        """The program's per-layer tensors cut into the reference's leaves
        (the port stacks each layer's elements into one zero-padded ``(S,
        in, out)`` weight and ``(S, out)`` bias)."""
        in_dim = weights.aev_length(self.config)
        out = []
        for s, sym in enumerate(self.config["symbols"]):
            dims = [in_dim] + list(self.config["widths"][sym]) + [1]
            for li in range(len(dims) - 1):
                out.append(ws[li][s, :dims[li], :dims[li + 1]])
                if bs is not None:
                    out.append(bs[li][s, :dims[li + 1]])
        return out

    def _params(self) -> tp.List[torch.Tensor]:
        nets = self.state.networks
        return self._leaves(list(nets.weights), None if nets.biases is None else list(nets.biases))

    def setup(self) -> None:
        from torchani_tpu_torch import convert, models
        from torchani_tpu_torch.training import (
            adamw_with_plateau, make_train_step, tune_angular_capacity)

        model = getattr(models, self.config["factory"])(
            model_index=0 if self.members == 1 else None, device=self.device)
        convert.load_state_dict(model, self.state_dict)
        model = tune_angular_capacity(model, self.pool)
        model.energy_shifter.enabled = False
        optimizer = adamw_with_plateau(self.traffic["lr"], self.traffic["weight_decay"])[0]
        init_fn, self.step_fn = make_train_step(
            model, optimizer, force_training=True, force_weight=self.traffic["force_weight"])
        self.state = init_fn()
        self.bad = torch.zeros((), dtype=torch.int64, device=self.device)
        start = [t.detach().clone() for t in self._params()]
        losses = []
        for k in range(CHECKED_STEPS):
            self.step()
            losses.append(self.last_loss)
            if k == 0:
                opt, nets = self.state.opt_state, self.state.networks
                beta1 = opt.param_groups[0]["betas"][0]

                def first_grad(params):
                    # a parameter the step left alone has no moment: zero
                    return [opt.state[p]["exp_avg"] / (1 - beta1) if p in opt.state
                            else torch.zeros_like(p) for p in params]

                grads = [t.detach().clone() for t in self._leaves(
                    first_grad(nets.weights),
                    None if nets.biases is None else first_grad(nets.biases))]
        changes = [float((t.detach() - s).norm()) for t, s in zip(self._params(), start)]
        self.kept = {"losses": [float(x) for x in losses], "grads": grads,
                     "grad_norms": [float(g.norm()) for g in grads], "change_norms": changes}
        self.finish()
        self.reset()
        self.bad.zero_()
        self.next_batch = CHECKED_STEPS

    def step(self) -> None:
        k = self.next_batch % len(self.pool)
        self.next_batch = k + 1
        self.state, out = self.step_fn(self.state, self.pool[k])
        self.last_loss = out["loss"]
        self.bad += (~torch.isfinite(out["loss"])).to(torch.int64)
        self.attempted += 1
        self.work.append(self.pool_work[k])

    def finish(self) -> None:
        synchronize(self.device)
        self.failed = int(self.bad)

    def end_to_end(self, window_s: float) -> tp.Dict[str, float]:
        return {"train_conformers_per_s": self.attempted * self.traffic["batch"] / window_s}

    def release(self) -> None:
        del self.state, self.step_fn

    # ---- the check ----
    def _reference_steps(self, precision: str, half_batch: bool = False,
                         unchanged: bool = False) -> tp.Dict[str, tp.Any]:
        """Three steps of the plain reference: losses, the first gradient's
        leaf norms, the leaves' change norms.  Two faults for the control
        runs: ``half_batch`` leaves out the second half of each batch (the
        mean is taken over the rest), ``unchanged`` never updates the
        state."""
        sd = {k: v.clone() for k, v in self.state_dict.items()}
        ref = Reference(dict(self.config, members=self.members), sd, precision=precision)
        leaves = ref.parameters()
        for t in leaves:
            t.requires_grad_(True)
        start = [t.detach().clone() for t in leaves]
        m = [torch.zeros_like(t) for t in leaves]
        v = [torch.zeros_like(t) for t in leaves]
        lr, wd = self.traffic["lr"], self.traffic["weight_decay"]
        b1, b2, eps = 0.9, 0.999, 1e-8
        fw = self.traffic["force_weight"]
        chunk = int(self.traffic["reference_chunk"])
        losses, first = [], []
        for t in range(1, CHECKED_STEPS + 1):
            batch = {k: x.to(self.device) for k, x in self.pool[t - 1].items()}
            if half_batch:
                batch = {k: x[:x.shape[0] // 2] for k, x in batch.items()}
            n_mol = batch["species"].shape[0]
            loss = 0.0
            grads = [torch.zeros_like(x) for x in leaves]
            for lo in range(0, n_mol, chunk):
                sl = slice(lo, lo + chunk)
                sp = batch["species"][sl]
                e, f = ref.batch_energies_forces_graph(sp, batch["coordinates"][sl],
                                                       self_energies=False)
                n = (sp >= 0).sum(1).to(torch.float32)
                e_part = ((e - batch["energies"][sl]) ** 2 / torch.sqrt(n)).sum() / n_mol
                f_part = ((f - batch["forces"][sl]) ** 2).sum((-1, -2)).div(n).sum() / n_mol
                part = e_part + fw * f_part
                # an element absent from the chunk has no gradient
                for g, d in zip(grads, torch.autograd.grad(part, leaves, allow_unused=True)):
                    if d is not None:
                        g += d
                loss += float(part.detach())
            losses.append(loss)
            if t == 1:
                first = [g.clone() for g in grads]
            if unchanged:
                continue
            with torch.no_grad():
                for p, g, m_, v_ in zip(leaves, grads, m, v):
                    p.mul_(1 - lr * wd)
                    m_.mul_(b1).add_(g, alpha=1 - b1)
                    v_.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v_.sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                    p.addcdiv_(m_, denom, value=-lr / (1 - b1 ** t))
        changes = [float((p.detach() - s).norm()) for p, s in zip(leaves, start)]
        return {"losses": losses, "grads": first, "grad_norms": [float(g.norm()) for g in first],
                "change_norms": changes}

    def control(self, variant: str = "tf32") -> tp.Dict[str, tp.Any]:
        if variant in ("half_batch", "unchanged"):
            return self._reference_steps("float32", **{variant: True})
        return self._reference_steps(variant)

    def readings(self, outputs=None) -> tp.Dict[str, float]:
        out = self.kept if outputs is None else outputs
        ref = self._reference_steps("float32")
        rg = np.asarray(ref["grad_norms"])
        keep = rg >= 1e-3 * np.median(rg)
        loss = np.asarray(out["losses"], dtype=np.float64)
        ref_loss = np.asarray(ref["losses"], dtype=np.float64)
        gaps = np.abs(loss - ref_loss) / np.abs(ref_loss)
        diffs = [float((a.reshape(-1).double() - b.reshape(-1).double()).norm() / b.norm())
                 for a, b, k in zip(out["grads"], ref["grads"], keep) if k]
        return {
            "loss1_gap": float(gaps[0]),
            "loss_gap": float(np.max(gaps)),
            "grad_diff": float(np.median(diffs)),
            "grad_gap": relative_gaps(out["grad_norms"], ref["grad_norms"], keep),
            "change_gap": relative_gaps(out["change_norms"], ref["change_norms"], keep),
        }


DRIVER = Training
