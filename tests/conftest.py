"""Test configuration.

Default (the CPU suite): everything runs on the CPU backend with 8 virtual
devices, so the sharded paths are exercised without a multi-GPU host
(SURVEY.md §4: the "fake backend" the reference lacks).  Pallas kernels run
in the interpreter wherever a test names a kernel method.

GPU mode (``ICP_TESTS_GPU=1``, set by ``chip_smoke.py`` on the card): the
real backend stays in place and float64 stays off, so the ``gpu``-marked
tests (``tests/test_hw.py``) run the compiled Triton kernels.  Whether a card
is present is decided inside the ``gpu_device`` fixture, never while a
module is imported, so every xdist worker collects the same tests.
"""

import os

# Subprocess-spawning tests (CLI contract, distributed bring-up, bench
# supervisor) run `python -m icp_tpu...` from other working directories;
# make the package importable there even when it is not pip-installed.
# Must happen at import time: test modules snapshot `os.environ` into their
# own ENV dicts.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["PYTHONPATH"] = _REPO_ROOT + (
    os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else ""
)

GPU_MODE = os.environ.get("ICP_TESTS_GPU") == "1"

if not GPU_MODE:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if not GPU_MODE:
    jax.config.update("jax_platforms", "cpu")
    # Float64 available for oracle-parity tests (library code always passes
    # explicit dtypes, so this does not change the f32 fast paths under
    # test).
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The GPU the compiled-kernel tests run on; skips without one."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU: compiled Triton kernels have no "
                    "CPU route (run by chip_smoke.py on the card)")
    return devices[0]


DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def data_path(name: str) -> str:
    return os.path.join(DATA_DIR, name)


@pytest.fixture
def rng():
    """A fresh, fixed-seed generator per test: no test's data depends on
    which tests ran before it in the same worker."""
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def cow_pair():
    from icp_tpu.io.csv import load_matrix

    ref = load_matrix(data_path("cow_ref.txt"))
    tr1 = load_matrix(data_path("cow_tr1.txt"))
    return ref, tr1


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Uniform random rotation via QR of a gaussian matrix."""
    A = rng.standard_normal((3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q @ np.diag(np.sign(np.diag(R)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q
