"""Allow ``python -m tiatoolbox_tpu_torch.cli <command>``."""

from tiatoolbox_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
