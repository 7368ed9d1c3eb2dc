"""Command line interface of the port (counterpart of
``torchani_tpu/cli.py``): ``sp`` single points from an xyz file with JSON
output, ``md`` molecular dynamics (NVE, Langevin, Nose-Hoover, Berendsen NPT,
RESPA multiple-timestep; trajectories through `MolecularDynamics.trajectory`)
and ``opt`` FIRE geometry optimization, one conformer or a batch; ``data
ls|info|convert|rm|clean|verify|pack`` dataset management (host-side, over
`torchani_tpu_torch.datasets`).  The same option names and printed lines as
the JAX package's, and ``--device`` (default ``cuda``) for the model
commands.

Run as ``ani-tpu-torch ...`` or ``python -m torchani_tpu_torch ...``.
"""

import argparse
import json
import sys
import typing as tp

import numpy as np
import torch

__all__ = [
    "main", "sp", "opt", "data_ls", "data_info", "data_pack", "data_rm", "data_clean",
    "data_pull",
]


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


def cmd_data_ls(args) -> None:
    from torchani_tpu_torch.datasets import ANIDataset

    ds = ANIDataset(args.location)
    for name, size in sorted(ds.group_sizes().items()):
        print(f"{name}\t{size}")


def cmd_data_info(args) -> None:
    from torchani_tpu_torch.datasets import ANIDataset

    ds = ANIDataset(args.location)
    info = {
        "groups": len(ds),
        "conformers": ds.num_conformers,
        "properties": sorted(ds.properties),
        "metadata": ds.store.get_metadata(),
    }
    print(json.dumps(info, indent=1))


def cmd_data_convert(args) -> None:
    from torchani_tpu_torch.datasets import ANIDataset

    ANIDataset(args.location).to_backend(args.dest)
    print(f"wrote {args.dest}")


def cmd_data_rm(args) -> None:
    from torchani_tpu_torch.datasets import ANIDataset

    ds = ANIDataset(args.location)
    for name in args.groups:
        if name not in ds:
            raise SystemExit(f"error: no group named {name!r} in {args.location}")
        ds.delete_conformers(name)
        print(f"deleted group {name}")


def cmd_data_clean(args) -> None:
    """Drop conformers with non-finite floating values; refresh a recorded
    md5 manifest after any removal."""
    from torchani_tpu_torch.datasets import ANIDataset

    ds = ANIDataset(args.location)
    total = 0
    for name in list(ds.keys()):
        group = ds.get_conformers(name)
        n = next(iter(group.values())).shape[0]
        bad = np.zeros(n, dtype=bool)
        for arr in group.values():
            if np.issubdtype(arr.dtype, np.floating):
                bad |= ~np.isfinite(arr.reshape(n, -1)).all(axis=1)
        if bad.any():
            total += int(bad.sum())
            ds.delete_conformers(name, np.nonzero(bad)[0])
            print(f"{name}: removed {int(bad.sum())}/{n}")
    print(f"removed {total} non-finite conformers")
    if total and ds.verify_checksums()["recorded"]:
        ds.record_checksums()
        print("refreshed md5 manifest")


def cmd_data_verify(args) -> None:
    """Record (``--record``) or verify the md5 manifest of a local dataset."""
    from torchani_tpu_torch.datasets import ANIDataset

    ds = ANIDataset(args.location)
    if args.record:
        sums = ds.record_checksums()
        print(f"recorded md5 manifest for {len(sums)} file(s)")
        return
    report = ds.verify_checksums()
    if not report["recorded"]:
        raise SystemExit("error: no md5 manifest recorded; run with --record first")
    for kind in ("missing", "mismatched", "untracked"):
        for f in report[kind]:
            print(f"{kind}: {f}")
    if not report["ok"]:
        raise SystemExit("error: integrity check FAILED")
    print("integrity ok")


def cmd_data_pack(args) -> None:
    from torchani_tpu_torch.datasets import create_batched_dataset

    dest = create_batched_dataset(
        args.location, args.dest, batch_size=args.batch_size, rng_seed=args.seed
    )
    print(f"wrote batched dataset to {dest}")


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


def data_ls(location) -> None:
    """List a dataset's groups and their sizes, as ``data ls``."""
    cmd_data_ls(argparse.Namespace(location=str(location)))


def data_info(location) -> None:
    cmd_data_info(argparse.Namespace(location=str(location)))


def data_pack(location, dest, batch_size: int = 2560, seed: int = 1234) -> None:
    cmd_data_pack(argparse.Namespace(
        location=str(location), dest=str(dest), batch_size=batch_size, seed=seed
    ))


def data_rm(location, groups: tp.Sequence[str]) -> None:
    cmd_data_rm(argparse.Namespace(location=str(location), groups=list(groups)))


def data_clean(location) -> None:
    cmd_data_clean(argparse.Namespace(location=str(location)))


def data_pull(*args, **kwargs) -> None:
    """Unavailable: the package downloads nothing.  Place dataset files
    locally and use the other data commands."""
    raise RuntimeError("data_pull is unavailable: this package downloads nothing")


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

    data = sub.add_parser("data", help="dataset management")
    dsub = data.add_subparsers(dest="data_command", required=True)
    p = dsub.add_parser("ls", help="list groups and sizes")
    p.add_argument("location")
    p.set_defaults(fn=cmd_data_ls)
    p = dsub.add_parser("info", help="dataset summary as JSON")
    p.add_argument("location")
    p.set_defaults(fn=cmd_data_info)
    p = dsub.add_parser("convert", help="convert between storage backends")
    p.add_argument("location")
    p.add_argument("dest")
    p.set_defaults(fn=cmd_data_convert)
    p = dsub.add_parser("rm", help="delete conformer groups")
    p.add_argument("location")
    p.add_argument("groups", nargs="+")
    p.set_defaults(fn=cmd_data_rm)
    p = dsub.add_parser("clean", help="remove conformers with non-finite values")
    p.add_argument("location")
    p.set_defaults(fn=cmd_data_clean)
    p = dsub.add_parser("verify", help="record/verify an md5 integrity manifest")
    p.add_argument("location")
    p.add_argument("--record", action="store_true", help="(re)write the manifest")
    p.set_defaults(fn=cmd_data_verify)
    p = dsub.add_parser("pack", help="create a batched dataset")
    p.add_argument("location")
    p.add_argument("dest")
    p.add_argument("--batch-size", type=int, default=2560)
    p.add_argument("--seed", type=int, default=1234)
    p.set_defaults(fn=cmd_data_pack)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
