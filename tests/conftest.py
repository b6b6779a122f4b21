"""Registers the marker of tests that need an NVIDIA GPU."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels have no CPU "
        "mode); skips where torch.cuda.is_available() is false")
