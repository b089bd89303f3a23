"""The benchmark's own tests (``python -m pytest benchmark/tests``).
Tests marked ``card`` need the card and skip without one; they decide so
inside the test."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
