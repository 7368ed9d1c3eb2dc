"""Traffic drivers, one module per ``driver`` named in a traffic file.

A driver makes its inputs and weights from the seed, builds the program
under test and warms it up (`Driver.setup`), runs one unit of traffic per
`Driver.step` (an MD stretch, a batch, a training step), and afterwards
judges what the program produced against the plain reference
(`Driver.readings`).  `Driver.control` gives the same outputs from the
reference at the precision below the configuration's, for the control runs.
"""

import typing as tp

import torch


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host copy of ``t``, pinned where a card will read it."""
    t = t.detach().cpu()
    return t.pin_memory() if device.type == "cuda" else t


class Driver:
    """The interface the harness drives; see the module docstring."""

    #: the work counter that ``*_per_step`` and ``*_per_batch`` divide by
    unit = "step"

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device) -> None:
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        #: units run since set-up ended, and how many failed
        self.attempted = 0
        self.failed = 0
        #: what each unit run since set-up needed (`yardstick.count_work`
        #: keys, and the unit's own count under `unit`)
        self.work: tp.List[tp.Dict[str, float]] = []
        #: counters the program keeps, summed over the units since set-up
        self.counters: tp.Dict[str, float] = {}

    def setup(self) -> None:
        raise NotImplementedError

    def step(self) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        """Wait for the units run so far and settle ``failed``."""
        synchronize(self.device)

    def end_to_end(self, window_s: float) -> tp.Dict[str, float]:
        raise NotImplementedError

    def release(self) -> None:
        """Free the program's state, keeping its outputs for the check."""
        raise NotImplementedError

    def control(self, variant: str = "tf32") -> tp.Dict[str, tp.Any]:
        raise NotImplementedError

    def readings(self, outputs: tp.Optional[tp.Dict[str, tp.Any]] = None) -> tp.Dict[str, float]:
        raise NotImplementedError

    def reset(self) -> None:
        """Zero the counts of units at the end of set-up."""
        self.attempted = 0
        self.failed = 0
        self.work = []
        self.counters = {}
