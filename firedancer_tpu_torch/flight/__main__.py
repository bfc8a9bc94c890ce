"""`python -m firedancer_tpu_torch.flight`: see flight/cli.py."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
