import os
import sys

# make tests/helpers.py importable regardless of invocation directory
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's hand-written kernels); "
        "skipped with a reason where torch.cuda.is_available() is false")
