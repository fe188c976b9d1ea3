import os
import sys

# Tests run against the single default CPU device (the 512-device flag is
# dryrun.py-only, per the launch design).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    from hypothesis import settings
except ImportError:  # container without hypothesis: deterministic stub
    from _hypothesis_stub import install

    install()
    from hypothesis import settings

settings.register_profile("ci", max_examples=25, deadline=None)
settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels); "
        "skips where there is none")
