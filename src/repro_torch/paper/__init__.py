"""The paper's tables and experiments on the port.

``tables`` holds one function per paper table or experiment (a copy of
``benchmarks/paper_tables.py`` over ``repro_torch``), ``run`` the
harness entry point (``python -m repro_torch.paper.run``).
"""
