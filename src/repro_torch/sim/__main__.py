"""Entry point: ``python -m repro_torch.sim`` (see :mod:`repro_torch.sim.cli`)."""
import sys

from repro_torch.sim.cli import main

if __name__ == "__main__":
    sys.exit(main())
