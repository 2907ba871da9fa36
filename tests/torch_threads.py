"""Torch's thread count for the port's CPU tests that drive whole serving
or training stacks. Under ``pytest -n`` several workers share the host's
cores, and torch's default of one thread a core then makes these tests
wait on each other's threads (a cluster CLI case took 96 s beside five
busy torch processes with the default threads and 9.6 s with one, 2 s
alone). A module imports the fixtures it uses and names them in
``pytestmark`` or in a test's arguments."""
import pytest

torch = pytest.importorskip("torch")

DEFAULT_THREADS = torch.get_num_threads()   # torch's own choice here


def _threads(n):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    return before


@pytest.fixture
def one_torch_thread(monkeypatch):
    """One torch thread, here and in the processes the test starts. It
    also fixes the order of each CPU product's sums, whatever the core
    count."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    before = _threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def default_torch_threads(monkeypatch):
    """Torch's default threads for one test of a module that runs on
    ``one_torch_thread``: for a test whose measured stage seconds drive a
    wall-clock calibrator, whose straggler checks a single thread's times
    under the other workers' load tripped (the analytic twin trips none)."""
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    before = _threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(before)
