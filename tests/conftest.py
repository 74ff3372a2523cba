import os
import sys

import pytest

# tests see the 1 real device — the 512-device override lives ONLY in
# launch/dryrun.py (spawned as a subprocess where needed).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one "
        "(on the GPU machine: `pytest -m cuda tests/test_torch_cuda.py`)")


def pytest_collection(session):
    """TIER1_REQUIRE_DEPS=1 (set by scripts/tier1.sh == CI) asserts that
    no test runs on a degraded dependency: a missing ``hypothesis`` fails
    the run outright instead of silently downgrading the property tests
    to the seeded mini-runner (tests/_hypothesis_compat.py)."""
    if os.environ.get("TIER1_REQUIRE_DEPS") == "1":
        try:
            import hypothesis  # noqa: F401
        except ImportError:
            raise pytest.UsageError(
                "TIER1_REQUIRE_DEPS=1 but hypothesis is not installed — "
                "the property tests would run on the seeded fallback "
                "runner only. Install requirements.txt (scripts/tier1.sh "
                "does) or unset TIER1_REQUIRE_DEPS.")


def pytest_report_header(config):
    """Make a missing ``hypothesis`` loud: the property tests still RUN
    (seeded mini-runner in tests/_hypothesis_compat.py — deterministic
    draws, no shrinking), but CI always uses the real hypothesis (the
    documented tier-1 flow — scripts/tier1.sh — installs
    requirements.txt first)."""
    try:
        import hypothesis
        return f"hypothesis {hypothesis.__version__}: property tests active"
    except ImportError:
        return ("WARNING: hypothesis NOT installed -> property tests run "
                "on the seeded mini-runner (deterministic, no shrinking). "
                "Documented flow: `pip install -r requirements.txt` or "
                "scripts/tier1.sh — CI always runs with hypothesis.")
