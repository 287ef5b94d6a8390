"""``python -m theanompi_torch.serving``: the port's ``tmserve``."""

from theanompi_torch.serving.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
