"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU; sharding correctness is validated on
host-platform virtual devices. The card itself is exercised by
`python chip_smoke.py` (and `--four` for the sharded paths).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from flobaroid_tpu.utils.cli import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import pathlib  # noqa: E402
import signal  # noqa: E402

import pytest  # noqa: E402

# Per-test wall-clock cap, mirroring the reference's 60 s pytest-timeout
# (/root/reference/pyproject.toml [tool.pytest.ini_options]).  pytest-timeout
# is not installed in this image, so the cap is enforced with SIGALRM around
# the call phase (fixture setup is exempt: module-scoped scenario builders
# legitimately pay one cold XLA compile).  Individual tests that genuinely
# need more relax it with @pytest.mark.timeout(N); FLOBAROID_TEST_TIMEOUT=0
# disables the cap (used when measuring durations).
DEFAULT_TEST_TIMEOUT = float(os.environ.get("FLOBAROID_TEST_TIMEOUT", 60))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "timeout(seconds): relax/tighten the per-test wall-clock cap")
    config.addinivalue_line(
        "markers", "slow: long-running test, excluded from the fast tier (-m 'not slow')")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    marker = item.get_closest_marker("timeout")
    seconds = float(marker.args[0]) if marker and marker.args else DEFAULT_TEST_TIMEOUT
    if seconds > 0 and hasattr(signal, "SIGALRM"):
        def _on_timeout(signum, frame):
            raise TimeoutError(
                f"{item.nodeid} exceeded the {seconds:g}s per-test timeout "
                f"(relax with @pytest.mark.timeout)")
        old = signal.signal(signal.SIGALRM, _on_timeout)
        signal.setitimer(signal.ITIMER_REAL, seconds)
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)
    else:
        yield

REFERENCE = pathlib.Path("/root/reference")
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="session")
def reference_model_dir():
    d = REFERENCE / "model"
    if not d.exists():
        pytest.skip("reference model dir not available")
    return d


@pytest.fixture(scope="session")
def threelinks_urdf(reference_model_dir):
    return str(reference_model_dir / "threeLinks.urdf")


@pytest.fixture(scope="session")
def kuka_urdf(reference_model_dir):
    return str(reference_model_dir / "kuka_lwr4.urdf")
