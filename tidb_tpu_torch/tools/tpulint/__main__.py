"""python -m tidb_tpu_torch.tools.tpulint [--strict] [--json] [paths]"""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
