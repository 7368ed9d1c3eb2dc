"""Random model weights in the reference key scheme, made on the device.

The rule is the one the port's seeded factories follow (`torch.nn.Linear`'s
default): every weight and bias of a layer with ``fan_in`` inputs uniform in
``(-1/sqrt(fan_in), 1/sqrt(fan_in))``.  Here all of them come from one
``torch.rand`` call on a generator on the run's device, seeded by
``--seed``, in float32 (the type they are served in).  The state dict also
carries the AEV's constants, the self energies and the xTB repulsion's
element-pair tables from the configuration, so that the program (through
`convert.load_state_dict`) and the plain reference read the same numbers.
"""

import math
import typing as tp

import torch

from benchmark.reference.model import aev_constants, constants


def aev_length(config: dict) -> int:
    s = len(config["symbols"])
    rad, ang = config["aev"]["radial"], config["aev"]["angular"]
    return s * rad["num_shifts"] + s * (s + 1) // 2 * ang["num_shifts"] * ang["num_sections"]


def layer_shapes(config: dict) -> tp.List[tp.Tuple[str, str, int, int]]:
    """``(symbol, layer name, fan_in, fan_out)`` of one member's layers."""
    in_dim = aev_length(config)
    out = []
    for sym in config["symbols"]:
        dims = [in_dim] + list(config["widths"][sym]) + [1]
        for li in range(len(dims) - 1):
            name = "final_layer" if li == len(dims) - 2 else f"layers.{li}"
            out.append((sym, name, dims[li], dims[li + 1]))
    return out


def random_state_dict(config: dict, members: int, seed: int, device: torch.device
                      ) -> tp.Dict[str, torch.Tensor]:
    """The state dict of ``members`` members (the keys of a single
    `AtomicNetworks` when ``members`` is 1)."""
    shapes = layer_shapes(config)
    bias = bool(config["bias"])
    per_member = sum(i * o + (o if bias else 0) for _, _, i, o in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    u = torch.rand(members * per_member, generator=gen, device=device, dtype=torch.float32)
    u = 2.0 * u - 1.0
    sd: tp.Dict[str, torch.Tensor] = {}
    pos = 0
    net = "potentials.nnp.neural_networks."
    for e in range(members):
        member = f"{net}members.{e}." if members > 1 else net
        for sym, name, fan_in, fan_out in shapes:
            key = f"{member}atomics.{sym}.{name}"
            scale = 1.0 / math.sqrt(fan_in)
            sd[key + ".weight"] = u[pos:pos + fan_in * fan_out].view(fan_out, fan_in) * scale
            pos += fan_in * fan_out
            if bias:
                sd[key + ".bias"] = u[pos:pos + fan_out] * scale
                pos += fan_out
    aev = config["aev"]
    consts = aev_constants(aev)

    def f32(values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=device)

    pre = "potentials.nnp.aev_computer."
    sd[pre + "radial.eta"] = f32([aev["radial"]["eta"]])
    sd[pre + "radial.shifts"] = f32(consts["radial_shifts"])
    sd[pre + "angular.eta"] = f32([aev["angular"]["eta"]])
    sd[pre + "angular.zeta"] = f32([aev["angular"]["zeta"]])
    sd[pre + "angular.shifts"] = f32(consts["angular_shifts"])
    sd[pre + "angular.sections"] = f32(consts["sections"])
    sd["energy_shifter.self_energies"] = f32([config["self_energies"][s] for s in config["symbols"]])
    names = [p["name"] for p in config.get("potentials", [])]
    if "repulsion_xtb" in names:
        el = [constants()["elements"][s] for s in config["symbols"]]
        sd["potentials.repulsion_xtb.y_ab"] = f32(
            [[a["xtb_repulsion_yeff"] * b["xtb_repulsion_yeff"] for b in el] for a in el])
        sd["potentials.repulsion_xtb.sqrt_alpha_ab"] = f32(
            [[math.sqrt(a["xtb_repulsion_alpha"] * b["xtb_repulsion_alpha"]) for b in el]
             for a in el])
        sd["potentials.repulsion_xtb.k_rep_ab"] = f32(
            [[1.0 if a["znumber"] == b["znumber"] == 1 else 1.5 for b in el] for a in el])
    return sd
