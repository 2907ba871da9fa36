"""``launch/serve.py --stream --cluster`` of the port against the
reference's: the documented cluster, fleet and governor commands
(docs/cluster.md, heterogeneity.md, fleet.md, energy.md) print the same
lines but the wall ones, the learned profiles on the torch backend lose no
request, and the flag checks and the host-profile parser agree; two of
the documented commands on ``--backend torch --device cpu`` print what
the analytic backend prints. The CLI runs in process
(``cluster_harness._cli``, cached per process: the documented "learn"
command's analytic run serves two tests here)."""
import pytest

torch = pytest.importorskip("torch")

from cluster_harness import (BASE, DOCUMENTED, _cli, _minus,
                             cli_torch_cpu_cluster_matches_analytic,
                             ref_serve_cli, serve_cli)
from torch_threads import (default_torch_threads,  # noqa: F401
                           one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# the CLI: serve --stream --cluster, the documented commands
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(DOCUMENTED))
def test_cli_documented_command_matches_reference(name, tmp_path):
    argv = BASE + DOCUMENTED[name]
    if name == "kill":
        argv = argv + ["--record-cluster-events", str(tmp_path / "e.jsonl")]
    port = _cli("repro_torch", tuple(argv))
    ref = _cli("repro", tuple(argv))
    assert port[0] == ref[0] == \
        "[serve] backend=cluster max_cells=2 dispatch=async"
    assert _minus(port) == _minus(ref)
    assert any(line.startswith("[serve] cluster: 2 workers") for line in port)
    assert any("event t=" in line for line in port)
    done = next(line for line in port if line.startswith("[serve] completed="))
    assert "dropped=0" in done


def test_cli_learned_profiles_on_torch_lose_no_request():
    """The learned-profile command on the torch backend learns from real
    seconds, so what it publishes may differ from the analytic run (ROADMAP
    C); no request is lost either way."""
    argv = BASE + DOCUMENTED["learn"]
    out = _cli("repro_torch", tuple(argv + ["--backend", "torch",
                                            "--device", "cpu"]))
    analytic = _cli("repro_torch", tuple(argv))
    done = [next(line for line in lines
                 if line.startswith("[serve] completed=")).split()[1:3]
            for lines in (out, analytic)]
    assert done[0] == done[1] and done[0][1] == "dropped=0"
    assert any(line.startswith(("[serve] learned profile",
                                "[serve] learned profiles:"))
               for line in out)


def test_cli_kill_worker_on_one_worker_raises_as_the_reference():
    argv = BASE + ["--cluster", "1", "--kill-worker", "40"]
    with pytest.raises(SystemExit, match="empty the fleet"):
        _cli("repro", tuple(argv))
    with pytest.raises(SystemExit, match="empty the fleet"):
        _cli("repro_torch", tuple(argv))


@pytest.mark.parametrize("extra", [
    ["--kill-worker", "40"], ["--steal"], ["--learn-profiles"],
    ["--replicate-hot", "2"], ["--governor"],
    ["--cluster", "2", "--replicate-hot", "2"],
    ["--power-cap-w", "700"], ["--cluster", "2", "--host-profiles", "w1"],
])
def test_cli_flag_checks_match_reference(extra, capsys):
    argv = BASE + extra
    for root in ("repro", "repro_torch"):
        with pytest.raises(SystemExit) as e:
            _cli(root, tuple(argv))
        assert e.value.code == 2
    errors = [line.split("error:")[1]
              for line in capsys.readouterr().err.splitlines()
              if "error:" in line]
    assert len(errors) == 2 and errors[0] == errors[1]


def test_cli_cluster_torch_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve_cli.main(BASE + ["--cluster", "2", "--backend", "torch"])


def test_parse_host_profiles_matches_reference():
    spec = "w1=4, w2=2:0.5,"
    got = serve_cli.parse_host_profiles(spec)
    want = ref_serve_cli.parse_host_profiles(spec)
    assert {k: v.to_dict() for k, v in got.items()} == \
        {k: v.to_dict() for k, v in want.items()}
    for bad in ("w1", "=4", "w1=0", "w1=x"):
        with pytest.raises(ValueError, match="bad --host-profiles entry"):
            serve_cli.parse_host_profiles(bad)

@pytest.mark.parametrize("name", ["replicate", "autoscale"])
def test_cli_torch_cpu_cluster_matches_analytic(name, tmp_path,
                                                default_torch_threads):
    """``cluster_harness.cli_torch_cpu_cluster_matches_analytic``: the
    torch CLI against the analytic one, for the replicate and autoscale
    commands; the others are in test_torch_cluster.py and
    test_torch_cluster_torch.py."""
    cli_torch_cpu_cluster_matches_analytic(name, tmp_path)
