"""Radial and angular AEV expansion terms (counterparts of
``torchani_tpu/aev/terms.py``).

Terms are modules whose constants are buffers; they map masked padded
distance/angle lanes to feature lanes, and the caller applies the masks.
`BaseRadial` and `BaseAngular` wrap a subclass's expansion in the cutoff
envelope; `Radial` and `Angular` are the user-extensible terms, whose
tensors are declared by name and reachable as attributes.
"""

import math
import typing as tp

import numpy as np
import torch

from torchani_tpu_torch.annotations import DeviceArg, Tensor
from torchani_tpu_torch.cutoffs import Cutoff, CutoffArg, parse_cutoff_fn
from torchani_tpu_torch.utils import linspace, resolve_device

__all__ = [
    "BaseRadial",
    "BaseAngular",
    "ANIRadial",
    "ANIAngular",
    "Radial",
    "Angular",
    "RadialArg",
    "AngularArg",
    "parse_radial_term",
    "parse_angular_term",
]


def _f32(values: tp.Sequence[float], device: torch.device) -> Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np.float32), device=device)


class BaseRadial(torch.nn.Module):
    """Base class of 2-body expansions.

    Subclasses implement `compute`; `forward` multiplies it by the cutoff
    envelope.  ``distances`` may have any (padded) shape; the output appends
    a feature axis of length ``num_feats``.
    """

    def __init__(self, cutoff: float, cutoff_fn: CutoffArg, num_feats: int) -> None:
        super().__init__()
        self.cutoff = float(cutoff)
        self.cutoff_fn: Cutoff = parse_cutoff_fn(cutoff_fn)
        self.num_feats = int(num_feats)

    def compute(self, distances: Tensor) -> Tensor:
        raise NotImplementedError("Must be implemented by subclasses")

    def forward(self, distances: Tensor) -> Tensor:
        terms = self.compute(distances)
        return terms * self.cutoff_fn(distances, self.cutoff)[..., None]


class BaseAngular(torch.nn.Module):
    """Base class of 3-body expansions.

    ``dist_ji`` and ``dist_jk`` are the center-to-side distances and
    ``cos_angles`` the cosine at the center, all of one padded shape.
    Subclasses implement `compute_radial` (``(..., Sh)``) and
    `compute_cos_angles` (``(..., Se)``); `forward` lays their product out
    shift-major, section-minor (``num_feats = Sh * Se``) and multiplies it
    by both sides' cutoff envelopes.
    """

    def __init__(self, cutoff: float, cutoff_fn: CutoffArg, num_feats: int) -> None:
        super().__init__()
        self.cutoff = float(cutoff)
        self.cutoff_fn: Cutoff = parse_cutoff_fn(cutoff_fn)
        self.num_feats = int(num_feats)

    def compute_radial(self, dist_ji: Tensor, dist_jk: Tensor) -> Tensor:
        raise NotImplementedError("Must be implemented by subclasses")

    def compute_cos_angles(self, cos_angles: Tensor) -> Tensor:
        raise NotImplementedError("Must be implemented by subclasses")

    def forward(self, dist_ji: Tensor, dist_jk: Tensor, cos_angles: Tensor) -> Tensor:
        # the product of the two envelopes, not a prod over a stacked axis:
        # no inf or NaN from the smooth cutoff
        factor = self.cutoff_fn(dist_ji, self.cutoff) * self.cutoff_fn(
            dist_jk, self.cutoff
        )
        rad = self.compute_radial(dist_ji, dist_jk)
        ang = self.compute_cos_angles(cos_angles)
        terms = rad[..., :, None] * ang[..., None, :]
        terms = terms.reshape(terms.shape[:-2] + (self.num_feats,))
        return terms * factor[..., None]


class ANIRadial(BaseRadial):
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
        super().__init__(cutoff, cutoff_fn, len(shifts))
        dev = resolve_device(device)
        self.register_buffer("eta", _f32([eta], dev))
        self.register_buffer("shifts", _f32(shifts, dev))

    def compute(self, distances: Tensor) -> Tensor:
        d = distances[..., None]
        return 0.25 * torch.exp(-self.eta * (d - self.shifts) ** 2)

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


class ANIAngular(BaseAngular):
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
        super().__init__(cutoff, cutoff_fn, len(shifts) * len(sections))
        dev = resolve_device(device)
        self.register_buffer("eta", _f32([eta], dev))
        self.register_buffer("zeta", _f32([zeta], dev))
        self.register_buffer("shifts", _f32(shifts, dev))
        self.register_buffer("sections", _f32(sections, dev))

    def compute_radial(self, dist_ji: Tensor, dist_jk: Tensor) -> Tensor:
        mean = (dist_ji + dist_jk) / 2
        return torch.exp(-self.eta * (mean[..., None] - self.shifts) ** 2)

    def compute_cos_angles(self, cos_angles: Tensor) -> Tensor:
        c = 0.95 * cos_angles
        sin_theta = torch.sqrt(1.0 - c * c)
        cos_dev = c[..., None] * torch.cos(self.sections) + sin_theta[
            ..., None
        ] * torch.sin(self.sections)
        return 2 * ((1 + cos_dev) / 2) ** self.zeta

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


def _validate_user_kwargs(
    clsname: str,
    names_dict: tp.Dict[str, tp.Sequence[str]],
    kwargs: tp.Dict[str, tp.Any],
    trainable: tp.Sequence[str],
) -> None:
    """Check a user term's tensors against the names its class declares."""
    declared: tp.Set[str] = set()
    total = 0
    for seq in names_dict.values():
        declared |= set(seq)
        total += len(seq)
    if len(declared) != total:
        raise ValueError("tensor names must be unique")
    if set(kwargs) != declared:
        raise ValueError(
            f"Expected arguments '{', '.join(sorted(declared))}' but got "
            f"'{', '.join(kwargs)}'. Maybe you forgot \"*tensors = [..., "
            f"'argname']\" when defining {clsname}?"
        )
    for names in names_dict.values():
        seqs = [v for k, v in kwargs.items() if k in names and isinstance(v, (tuple, list))]
        if seqs and not all(len(x) == len(seqs[0]) for x in seqs):
            raise ValueError(
                f"Tuples or lists passed to {clsname} for {names} must have the same len"
            )
    if not set(trainable).issubset(declared):
        raise ValueError(f"trainable={trainable} not found in {declared}")


def _register_user_tensors(
    module: torch.nn.Module,
    kwargs: tp.Dict[str, tp.Any],
    trainable: tp.Sequence[str],
    device: torch.device,
) -> tp.Dict[str, int]:
    """Each value as a ``(1, F)`` f32 tensor: a parameter if named in
    ``trainable``, else a buffer.  Returns each tensor's ``F``."""
    widths = {}
    for name, value in kwargs.items():
        t = _f32(np.asarray(value, dtype=np.float32).reshape(-1), device).reshape(1, -1)
        if name in trainable:
            module.register_parameter(name, torch.nn.Parameter(t))
        else:
            module.register_buffer(name, t)
        widths[name] = t.shape[1]
    return widths


class Radial(BaseRadial):
    """User-extensible 2-body term.

    A subclass names its tensors in the class attribute ``tensors``,
    overrides `compute`, and is built with ``MyRadial.make(cutoff,
    name=value, ...)``: each value becomes a ``(1, F)`` tensor reachable as
    ``self.<name>`` (a parameter if named in ``trainable``, else a buffer),
    and ``num_feats`` is the largest ``F``.
    """

    tensors: tp.ClassVar[tp.List[str]] = []

    @classmethod
    def make(
        cls,
        cutoff: float,
        trainable: tp.Union[str, tp.Sequence[str]] = (),
        cutoff_fn: CutoffArg = "cosine",
        device: DeviceArg = None,
        **kwargs,
    ) -> "Radial":
        if isinstance(trainable, str):
            trainable = [trainable]
        _validate_user_kwargs(cls.__name__, {"tensors": cls.tensors}, kwargs, trainable)
        term = cls(cutoff, cutoff_fn, 1)
        widths = _register_user_tensors(term, kwargs, trainable, resolve_device(device))
        term.num_feats = max([1] + list(widths.values()))
        return term

    @property
    def params(self) -> tp.Dict[str, Tensor]:
        """The declared tensors by name (the JAX term's ``params``)."""
        return {name: getattr(self, name) for name in self.tensors}


class Angular(BaseAngular):
    """User-extensible 3-body term.

    A subclass names its tensors in ``radial_tensors`` and
    ``angles_tensors``, overrides `compute_radial` and `compute_cos_angles`,
    and is built with ``MyAngular.make(cutoff, name=value, ...)``;
    ``num_feats`` is the largest radial ``F`` times the largest angular one,
    laid out shift-major, section-minor by `BaseAngular.forward`.
    """

    radial_tensors: tp.ClassVar[tp.List[str]] = []
    angles_tensors: tp.ClassVar[tp.List[str]] = []

    @classmethod
    def make(
        cls,
        cutoff: float,
        trainable: tp.Union[str, tp.Sequence[str]] = (),
        cutoff_fn: CutoffArg = "cosine",
        device: DeviceArg = None,
        **kwargs,
    ) -> "Angular":
        if isinstance(trainable, str):
            trainable = [trainable]
        _validate_user_kwargs(
            cls.__name__,
            {"radial_tensors": cls.radial_tensors, "angles_tensors": cls.angles_tensors},
            kwargs,
            trainable,
        )
        term = cls(cutoff, cutoff_fn, 1)
        widths = _register_user_tensors(term, kwargs, trainable, resolve_device(device))
        radial_feats = max([1] + [w for k, w in widths.items() if k not in cls.angles_tensors])
        angles_feats = max([1] + [w for k, w in widths.items() if k in cls.angles_tensors])
        term.num_feats = radial_feats * angles_feats
        return term

    @property
    def params(self) -> tp.Dict[str, Tensor]:
        """The declared tensors by name (the JAX term's ``params``)."""
        return {name: getattr(self, name) for name in self.radial_tensors + self.angles_tensors}


RadialArg = tp.Union[str, BaseRadial]
AngularArg = tp.Union[str, BaseAngular]


def parse_radial_term(
    radial: RadialArg, cutoff_fn: CutoffArg = "cosine", device: DeviceArg = None
) -> BaseRadial:
    if radial in ("ani1x", "ani1ccx"):
        return ANIRadial.like_1x(cutoff_fn, device)
    if radial == "ani2x":
        return ANIRadial.like_2x(cutoff_fn, device)
    if not isinstance(radial, BaseRadial):
        raise ValueError(f"Unsupported radial term: {radial}")
    return radial


def parse_angular_term(
    angular: AngularArg, cutoff_fn: CutoffArg = "cosine", device: DeviceArg = None
) -> BaseAngular:
    if angular in ("ani1x", "ani1ccx"):
        return ANIAngular.like_1x(cutoff_fn, device)
    if angular == "ani2x":
        return ANIAngular.like_2x(cutoff_fn, device)
    if not isinstance(angular, BaseAngular):
        raise ValueError(f"Unsupported angular term: {angular}")
    return angular
