import sys

from shadow_tpu_torch.fleet.cli import main

if __name__ == "__main__":
    sys.exit(main())
