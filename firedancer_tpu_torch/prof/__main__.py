"""`python -m firedancer_tpu_torch.prof`: see prof/cli.py."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
