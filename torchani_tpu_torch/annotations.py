"""Shared type annotations."""

import typing as tp

import torch

#: A tensor (the port's array type)
Tensor = torch.Tensor

#: Static sequence of chemical symbols, e.g. ("H", "C", "N", "O")
Symbols = tp.Tuple[str, ...]

#: Where a model or table lives: a ``torch.device`` or its name
DeviceArg = tp.Union[str, torch.device, None]
