"""`python -m firedancer_tpu_torch.trace`: see trace/cli.py."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
