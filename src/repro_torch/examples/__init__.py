"""The reference's examples (``examples/``) on the port, one module
each, run as ``python -m repro_torch.examples.<name> [--device cpu]``.
Each runs on the card by default and raises without one unless given
``--device cpu`` (``device="cpu"`` to ``main``)."""
