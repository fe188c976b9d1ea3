"""Serving scenario: the paper's application as a service — build the
index once, then serve batched query streams with validation (a copy
of ``examples/serve_roadgraph.py`` over ``repro_torch.launch.serve``).

    PYTHONPATH=src python -m repro_torch.examples.serve_roadgraph \\
        [--device cpu] [any other serve flag]

The reference's arguments come first; flags given here follow them and
win.
"""
from __future__ import annotations

import sys

#: the reference's serve arguments
ARGS = ("--nodes", "6000", "--batches", "8", "--batch-size", "2048",
        "--validate", "64")


def main(argv=None) -> int:
    from ..launch import serve
    return serve.main([*ARGS, *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    sys.exit(main())
