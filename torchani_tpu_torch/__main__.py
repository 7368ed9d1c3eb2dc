"""``python -m torchani_tpu_torch``: the command line interface (see ``cli.py``)."""

from torchani_tpu_torch.cli import main

if __name__ == "__main__":
    main()
