"""``python -m dpdfnet_tpu_torch``: the command-line interface."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
