"""Radial and angular AEV expansion terms (counterparts of
``torchani_tpu/aev/terms.py``).

Terms are modules whose constants are buffers; they map masked padded
distance/angle lanes to feature lanes, and the caller applies the masks.
"""

import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.cutoffs import Cutoff, CutoffArg, parse_cutoff_fn
from torchani_tpu_torch.utils import linspace, resolve_device

__all__ = [
    "ANIRadial",
    "ANIAngular",
    "RadialArg",
    "AngularArg",
    "parse_radial_term",
    "parse_angular_term",
]


def _f32(values: tp.Sequence[float], device: torch.device) -> Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np.float32), device=device)


class ANIRadial(torch.nn.Module):
    r"""ANI radial terms: :math:`0.25 e^{-\eta (r - R_s)^2} f_c(r)`.

    Eq. (3) of the ANI paper, with the NeuroChem 0.25 coefficient.
    """

    eta: Tensor  # (1,)
    shifts: Tensor  # (R,)

    def __init__(
        self,
        eta: float,
        shifts: tp.Sequence[float],
        cutoff: float,
        cutoff_fn: CutoffArg = "cosine",
        device: DeviceArg = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cutoff = float(cutoff)
        self.cutoff_fn: Cutoff = parse_cutoff_fn(cutoff_fn)
        self.num_feats = len(shifts)
        self.register_buffer("eta", _f32([eta], dev))
        self.register_buffer("shifts", _f32(shifts, dev))

    def forward(self, distances: Tensor) -> Tensor:
        d = distances[..., None]
        terms = 0.25 * torch.exp(-self.eta * (d - self.shifts) ** 2)
        return terms * self.cutoff_fn(distances, self.cutoff)[..., None]

    @classmethod
    def cover_linearly(
        cls,
        start: float = 0.9,
        cutoff: float = 5.2,
        eta: float = 19.7,
        num_shifts: int = 16,
        cutoff_fn: CutoffArg = "cosine",
        device: DeviceArg = None,
    ) -> "ANIRadial":
        """Linear division of [start, cutoff) into num_shifts radial shifts."""
        return cls(eta, linspace(start, cutoff, num_shifts), cutoff, cutoff_fn, device)

    @classmethod
    def like_1x(cls, cutoff_fn: CutoffArg = "cosine", device: DeviceArg = None) -> "ANIRadial":
        return cls.cover_linearly(0.9, 5.2, 16.0, 16, cutoff_fn, device)

    @classmethod
    def like_2x(cls, cutoff_fn: CutoffArg = "cosine", device: DeviceArg = None) -> "ANIRadial":
        return cls.cover_linearly(0.8, 5.1, 19.7, 16, cutoff_fn, device)


class ANIAngular(torch.nn.Module):
    r"""ANI angular terms (eq. (4) of the ANI paper).

    :math:`2((1+\cos(\theta - \theta_s))/2)^\zeta
    e^{-\eta(\bar r - R_s)^2} f_c(r_{ji}) f_c(r_{jk})`
    with :math:`\theta = \arccos(0.95 \cos\theta_{ijk})`, evaluated through
    the angle-difference identity (one sqrt instead of an acos and a cos).
    The feature layout is shift-major, section-minor.
    """

    eta: Tensor  # (1,)
    zeta: Tensor  # (1,)
    shifts: Tensor  # (Sh,)
    sections: Tensor  # (Se,)

    def __init__(
        self,
        eta: float,
        zeta: float,
        shifts: tp.Sequence[float],
        sections: tp.Sequence[float],
        cutoff: float,
        cutoff_fn: CutoffArg = "cosine",
        device: DeviceArg = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cutoff = float(cutoff)
        self.cutoff_fn: Cutoff = parse_cutoff_fn(cutoff_fn)
        self.num_feats = len(shifts) * len(sections)
        self.register_buffer("eta", _f32([eta], dev))
        self.register_buffer("zeta", _f32([zeta], dev))
        self.register_buffer("shifts", _f32(shifts, dev))
        self.register_buffer("sections", _f32(sections, dev))

    def forward(self, dist_ji: Tensor, dist_jk: Tensor, cos_angles: Tensor) -> Tensor:
        factor = self.cutoff_fn(dist_ji, self.cutoff) * self.cutoff_fn(
            dist_jk, self.cutoff
        )
        mean = (dist_ji + dist_jk) / 2
        rad = torch.exp(-self.eta * (mean[..., None] - self.shifts) ** 2)
        c = 0.95 * cos_angles
        sin_theta = torch.sqrt(1.0 - c * c)
        cos_dev = c[..., None] * torch.cos(self.sections) + sin_theta[
            ..., None
        ] * torch.sin(self.sections)
        ang = 2 * ((1 + cos_dev) / 2) ** self.zeta
        terms = rad[..., :, None] * ang[..., None, :]
        terms = terms.reshape(terms.shape[:-2] + (self.num_feats,))
        return terms * factor[..., None]

    @classmethod
    def cover_linearly(
        cls,
        start: float = 0.9,
        cutoff: float = 3.5,
        eta: float = 12.5,
        zeta: float = 14.1,
        num_shifts: int = 8,
        num_sections: int = 4,
        cutoff_fn: CutoffArg = "cosine",
        device: DeviceArg = None,
    ) -> "ANIAngular":
        shifts = linspace(start, cutoff, num_shifts)
        angle_start = math.pi / num_sections / 2
        sections = linspace(angle_start, math.pi + angle_start, num_sections)
        return cls(eta, zeta, shifts, sections, cutoff, cutoff_fn, device)

    @classmethod
    def like_1x(cls, cutoff_fn: CutoffArg = "cosine", device: DeviceArg = None) -> "ANIAngular":
        return cls.cover_linearly(0.9, 3.5, 8.0, 32.0, 4, 8, cutoff_fn, device)

    @classmethod
    def like_2x(cls, cutoff_fn: CutoffArg = "cosine", device: DeviceArg = None) -> "ANIAngular":
        return cls.cover_linearly(0.8, 3.5, 12.5, 14.1, 8, 4, cutoff_fn, device)


RadialArg = tp.Union[str, ANIRadial]
AngularArg = tp.Union[str, ANIAngular]


def parse_radial_term(
    radial: RadialArg, cutoff_fn: CutoffArg = "cosine", device: DeviceArg = None
) -> ANIRadial:
    if radial in ("ani1x", "ani1ccx"):
        return ANIRadial.like_1x(cutoff_fn, device)
    if radial == "ani2x":
        return ANIRadial.like_2x(cutoff_fn, device)
    if not isinstance(radial, ANIRadial):
        raise ValueError(f"Unsupported radial term: {radial}")
    return radial


def parse_angular_term(
    angular: AngularArg, cutoff_fn: CutoffArg = "cosine", device: DeviceArg = None
) -> ANIAngular:
    if angular in ("ani1x", "ani1ccx"):
        return ANIAngular.like_1x(cutoff_fn, device)
    if angular == "ani2x":
        return ANIAngular.like_2x(cutoff_fn, device)
    if not isinstance(angular, ANIAngular):
        raise ValueError(f"Unsupported angular term: {angular}")
    return angular
