"""``python -m lighthouse_tpu_torch bn|lcli|db ...`` (see ``cli.py``)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
