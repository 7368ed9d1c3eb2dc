"""Command line interface of the port (counterpart of
``torchani_tpu/cli.py``): ``sp`` single points from an xyz file with JSON
output, ``md`` molecular dynamics (NVE, Langevin, Nose-Hoover, Berendsen NPT,
RESPA multiple-timestep; trajectories through `MolecularDynamics.trajectory`)
and ``opt`` FIRE geometry optimization, one conformer or a batch.  The same
option names and printed lines as the JAX package's, and ``--device``
(default ``cuda``).  The dataset subcommands are not part of the port yet.

Run as ``ani-tpu-torch ...`` or ``python -m torchani_tpu_torch ...``.
"""

import argparse
import json
import sys
import typing as tp

import numpy as np
import torch

__all__ = ["main", "sp", "opt"]


def _build_model(name: str, ensemble_member: tp.Optional[int], device: str):
    """The named model on ``device``: pretrained weights where they are
    installed, else a warning and random weights."""
    from torchani_tpu_torch import models
    from torchani_tpu_torch.arch import simple_ani

    factories = {
        "ani1x": models.ANI1x,
        "ani1ccx": models.ANI1ccx,
        "ani2x": models.ANI2x,
        "ani2xr": models.ANI2xr,
        "anidr": models.ANIdr,
        "ani2dr": models.ANI2dr,
    }
    if name in factories:
        try:
            return factories[name](model_index=ensemble_member, pretrained=True, device=device)
        except FileNotFoundError as e:
            print(f"warning: {e}; using random-init weights", file=sys.stderr)
            return factories[name](model_index=ensemble_member, pretrained=False, device=device)
    if name == "simple":
        return simple_ani(("H", "C", "N", "O"), device=device)
    if name == "simple-dr":  # dispersion-bearing test model (MTS-capable)
        return simple_ani(("H", "C", "N", "O"), repulsion=True, dispersion=True, device=device)
    raise SystemExit(f"Unknown model {name!r}")


def _system(model, species: np.ndarray, cell, pbc):
    """The xyz file's species, cell and pbc as tensors on the model's device
    (converted once, not at every evaluation); pbc None unless some axis is
    periodic."""
    dev = model.device
    return (
        torch.as_tensor(species, device=dev),
        None if cell is None else torch.as_tensor(cell, device=dev),
        None if (pbc is None or not pbc.any()) else torch.as_tensor(pbc, device=dev),
    )


def cmd_sp(args) -> None:
    """Single-point energies (and optional derivatives) from an xyz file."""
    from torchani_tpu_torch.grad import single_point
    from torchani_tpu_torch.io import read_xyz

    model = _build_model(args.model, args.ensemble_member, args.device)
    species, coords, cell, pbc = read_xyz(args.xyz)
    sp_t, cell_t, pbc_t = _system(model, species, cell, pbc)
    out = single_point(
        model, sp_t, coords, cell_t, pbc_t,
        forces=args.forces, hessians=args.hessians, vibrational=args.vib,
    )
    result = {k: v.cpu().numpy().tolist() for k, v in out.items()}
    text = json.dumps(result, indent=None if args.compact else 1)
    if args.output:
        with open(args.output, "wt") as f:
            f.write(text)
    else:
        print(text)


def cmd_md(args) -> None:
    """Run MD from an xyz file and report basic observables."""
    from torchani_tpu_torch.io import read_xyz, write_xyz
    from torchani_tpu_torch.md import (
        MolecularDynamics,
        MultipleTimestepMD,
        kinetic_temperature,
    )

    model = _build_model(args.model, args.ensemble_member, args.device)
    species, coords, cell, pbc = read_xyz(args.xyz)
    periodic = cell is not None and pbc is not None and bool(np.asarray(pbc).any())
    ensemble = args.md_ensemble
    if ensemble == "npt" and not periodic:
        raise SystemExit("NPT requires a periodic cell in the xyz Lattice")
    mts_every = args.mts or 0
    box = dict(cell=cell if periodic else None, pbc=periodic, timestep_fs=args.timestep,
               device=args.device)
    if mts_every > 1:
        if args.traj:
            raise SystemExit("--traj is not supported with --mts yet")
        if ensemble not in ("nve", "nvt"):
            raise SystemExit("--mts supports NVE and Langevin NVT only")
        md = MultipleTimestepMD(model, species[:1], every=mts_every, **box)
    else:
        md = MolecularDynamics(
            model, species[:1], npt_compression=0.1 if ensemble == "npt" else 0.0, **box
        )
    state = md.init(
        coords[0], temperature=args.temperature,
        generator=torch.Generator().manual_seed(args.seed),
    )
    params = {}
    if ensemble in ("nvt", "nvt-nhc", "npt"):
        params["temperature"] = args.temperature
    if ensemble == "npt":
        params["pressure_bar"] = args.pressure
    frames = []
    chunk = max(1, min(args.steps, 50))
    if mts_every > 1:
        chunk = -(-chunk // mts_every) * mts_every
    done = 0
    while done < args.steps:
        n = min(chunk, args.steps - done)
        if mts_every > 1:
            n = (n // mts_every) * mts_every or mts_every
            state = md.run(state, n, ensemble="langevin" if ensemble == "nvt" else "nve", **params)
        elif args.traj:
            rec = max(1, min(args.record_every, n))
            n = (n // rec) * rec or rec
            state, traj = md.trajectory(state, n, record_every=rec, ensemble=ensemble, **params)
            frames.append(traj["coords"].cpu().numpy())
        elif ensemble == "nvt":
            state = md.run_langevin(state, n, **params)
        elif ensemble == "nvt-nhc":
            state = md.run_nvt_nose_hoover(state, n, **params)
        elif ensemble == "npt":
            state = md.run_npt_berendsen(state, n, **params)
        else:
            state = md.run_nve(state, n)
        done += n
        temp = float(kinetic_temperature(state.velocities, md.masses))
        scale = getattr(state, "scale", None)
        extra = f"  V/V0 = {float(scale) ** 3:.4f}" if scale is not None else ""
        print(
            f"step {done:8d}  E = {float(state.energy):14.6f} Ha  "
            f"T = {temp:8.1f} K  rebuilds = {int(state.rebuilds)}" + extra
        )
    out_cell = cell if periodic else None
    if args.traj:
        allf = np.concatenate(frames, axis=0)
        write_xyz(
            np.broadcast_to(species[:1], (allf.shape[0],) + species.shape[1:]),
            allf, args.traj, cell=out_cell,
        )
        print(f"wrote {allf.shape[0]} frames to {args.traj}")
    if args.output:
        write_xyz(species[:1], state.coords.cpu().numpy()[None], args.output, cell=out_cell)


def cmd_opt(args) -> None:
    """Geometry optimization (FIRE) from an xyz file.

    A multi-conformer file relaxes as one batch (`minimize_fire_batched`):
    every conformer keeps its own FIRE schedule and convergence flag, and
    the padding atoms of smaller conformers feel no force.
    """
    from torchani_tpu_torch.io import read_xyz, write_xyz
    from torchani_tpu_torch.optimize import minimize_fire, minimize_fire_batched

    model = _build_model(args.model, args.ensemble_member, args.device)
    species, coords, cell, pbc = read_xyz(args.xyz)
    sp_t, cell_t, pbc_t = _system(model, species, cell, pbc)

    if coords.shape[0] > 1:
        state = minimize_fire_batched(
            lambda c: model(sp_t, c, cell_t, pbc_t), coords, atom_mask=sp_t >= 0,
            max_steps=args.steps, fmax=args.fmax, device=args.device,
        )
        conv = (state.fmax <= args.fmax).cpu().numpy()
        energy, fmax = state.energy.cpu().numpy(), state.fmax.cpu().numpy()
        for i in range(coords.shape[0]):
            print(
                f"[{i}] converged={bool(conv[i])} "
                f"E={float(energy[i]):.8f} Ha "
                f"fmax={float(fmax[i]):.6f}"
            )
        print(f"steps={int(state.step)} converged {int(conv.sum())}/{len(conv)}")
        out_coords = state.coords.cpu().numpy()
    else:
        sp1 = sp_t[:1]
        state = minimize_fire(
            lambda c: torch.sum(model(sp1, c[None], cell_t, pbc_t)), coords[0],
            max_steps=args.steps, fmax=args.fmax, device=args.device,
        )
        print(
            f"converged={bool(state.fmax <= args.fmax)} steps={int(state.step)} "
            f"E={float(state.energy):.8f} Ha fmax={float(state.fmax):.6f}"
        )
        out_coords = state.coords.cpu().numpy()[None]
    if args.output:
        write_xyz(species, out_coords, args.output, cell=cell)


# ---- programmatic command functions (the reference's ``cli`` names) ----


def _paths(paths) -> tp.List[str]:
    if isinstance(paths, (str, bytes)) or hasattr(paths, "__fspath__"):
        paths = [paths]
    return [str(p) for p in paths]


def sp(
    paths,
    output_path=None,
    model_key: str = "ANI2x",
    forces: bool = False,
    hessians: bool = False,
    vib: bool = False,
    ensemble_member: tp.Optional[int] = None,
    compact: bool = False,
    device: str = "cuda",
) -> None:
    """Single points from xyz file(s), as ``sp`` on the command line."""
    for path in _paths(paths):
        cmd_sp(argparse.Namespace(
            xyz=path, model=model_key.lower(), ensemble_member=ensemble_member,
            forces=forces, hessians=hessians, vib=vib,
            output=None if output_path is None else str(output_path), compact=compact,
            device=device,
        ))


def opt(
    paths,
    output_path=None,
    model_key: str = "ANI2x",
    steps: int = 500,
    fmax: float = 0.02,
    ensemble_member: tp.Optional[int] = None,
    device: str = "cuda",
) -> None:
    """FIRE geometry optimization of xyz file(s), as ``opt`` on the command
    line."""
    for path in _paths(paths):
        cmd_opt(argparse.Namespace(
            xyz=path, model=model_key.lower(), ensemble_member=ensemble_member,
            steps=steps, fmax=fmax, output=None if output_path is None else str(output_path),
            device=device,
        ))


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="ani-tpu-torch", description="ANI models on PyTorch and CUDA"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("xyz")
        p.add_argument("-m", "--model", default="ani2x")
        p.add_argument("--ensemble-member", type=int, default=None)
        p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("sp", help="single-point calculations from an xyz file")
    common(p)
    p.add_argument("-f", "--forces", action="store_true")
    p.add_argument("--hessians", action="store_true")
    p.add_argument("--vib", action="store_true")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--compact", action="store_true")
    p.set_defaults(fn=cmd_sp)

    p = sub.add_parser("md", help="run molecular dynamics from an xyz file")
    common(p)
    p.add_argument("-n", "--steps", type=int, default=100)
    p.add_argument("--timestep", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=300.0)
    p.add_argument(
        "--nvt", dest="md_ensemble", action="store_const", const="nvt", default="nve",
        help="Langevin NVT (default: NVE)",
    )
    p.add_argument(
        "--nvt-nhc", dest="md_ensemble", action="store_const", const="nvt-nhc",
        help="Nose-Hoover chain NVT",
    )
    p.add_argument(
        "--npt", dest="md_ensemble", action="store_const", const="npt",
        help="Berendsen NPT (isotropic; periodic systems)",
    )
    p.add_argument("--pressure", type=float, default=1.0, help="bar (NPT)")
    p.add_argument(
        "--mts", type=int, default=0,
        help="RESPA multiple-timestep: evaluate long-cutoff potentials "
        "(e.g. D3 dispersion) every N steps (needs a model with such a "
        "potential, e.g. --model ani2dr)",
    )
    p.add_argument("--traj", default=None, help="write frames to this xyz")
    p.add_argument("--record-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(fn=cmd_md)

    p = sub.add_parser("opt", help="geometry optimization (FIRE)")
    common(p)
    p.add_argument("-n", "--steps", type=int, default=500)
    p.add_argument("--fmax", type=float, default=0.02)
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(fn=cmd_opt)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
