"""Port pipeline executors on the CPU vs the sequential stage chain (the
reference's own check, tests/test_dynamic_runtime.py), and the serving
driver vs the reference gcn_forward (max error 1e-3, the limit of
examples/serve_pipeline.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.models.gnn import gcn_forward
from repro.data import table1_graph as ref_table1_graph
from repro_torch.launch.serve_pipeline import main, serve
from repro_torch.runtime import (GroupedPipelineExecutor, PipelineExecutor,
                                 pipeline_round_count)


def _chain(n_stages, seed=0):
    rng = np.random.default_rng(seed)
    ws = torch.from_numpy(rng.normal(size=(n_stages, 16, 16))
                          .astype(np.float32) * 0.1)
    calls = [0] * n_stages

    def make(s):
        def fn(p, x):
            calls[s] += 1
            return x @ p["w"] + 1.0
        return fn
    return [make(s) for s in range(n_stages)], {"w": ws}, calls


def _sequential(fns, params, micro):
    exp = micro
    for s, fn in enumerate(fns):
        exp = torch.stack([fn({"w": params["w"][s]}, x) for x in exp])
    return exp


@pytest.mark.parametrize("m,s", [(1, 1), (3, 4), (8, 4), (5, 2)])
def test_pipeline_executor_matches_sequential_chain(m, s):
    fns, params, calls = _chain(s)
    micro = torch.from_numpy(np.random.default_rng(1).normal(
        size=(m, 8, 16)).astype(np.float32))
    out = PipelineExecutor(fns, params, (8, 16), device="cpu")(micro)
    assert calls == [m] * s          # bubbles are skipped, not computed
    exp = _sequential(fns, params, micro)
    torch.testing.assert_close(out, exp, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("groups", [(2, 1, 1), (1, 2, 1, 3)])
def test_grouped_executor_matches_sequential_chain(m, groups):
    fns, params, calls = _chain(len(groups), seed=2)
    micro = torch.from_numpy(np.random.default_rng(m).normal(
        size=(m, 8, 16)).astype(np.float32))
    ex = GroupedPipelineExecutor(fns, params, (8, 16), groups, device="cpu")
    out = ex(micro)
    assert ex.n_devices == sum(groups)
    assert ex.heads == tuple(np.cumsum((0,) + groups[:-1]))
    assert calls == [m] * len(groups)
    torch.testing.assert_close(out, _sequential(fns, params, micro),
                               atol=1e-5, rtol=1e-5)


def test_round_order_follows_gpipe():
    """Stage s handles microbatch r - s in round r; the last stage emits
    microbatch r - (s-1); there are m + s - 1 rounds."""
    m, s = 4, 3
    log = []

    def make(st):
        def fn(p, x):
            log.append((st, int(x[0, 0])))
            return x + 100.0
        return fn
    micro = torch.arange(m, dtype=torch.float32)[:, None, None] \
        .expand(m, 1, 2).contiguous()
    out = PipelineExecutor([make(i) for i in range(s)], {}, (1, 2),
                           device="cpu")(micro)
    assert pipeline_round_count(m, s) == 6
    expected = []
    for r in range(pipeline_round_count(m, s)):
        for st in range(s):
            if 0 <= r - st < m:
                expected.append((st, r - st + 100 * st))
    assert log == expected
    torch.testing.assert_close(out, micro + 100.0 * s)


def test_executor_rejects_wrong_activation_shape():
    fns, params, _ = _chain(2)
    ex = PipelineExecutor(fns, params, (8, 16), device="cpu")
    with pytest.raises(ValueError):
        ex(torch.zeros((2, 8, 15)))
    with pytest.raises(ValueError):
        GroupedPipelineExecutor(fns, params, (8, 16), (1,), device="cpu")


def test_serve_pipeline_matches_reference_gcn():
    """V = 1024 ogbn-arxiv-shaped graph, 8 requests, on the CPU."""
    res = serve("OA", 8, scale=0.006024, device="cpu")
    assert res.out.shape == (8, 1024, 128)
    assert res.max_err < 1e-3
    params = [{"theta": jnp.asarray(p["theta"].numpy())} for p in res.params]
    g = ref_table1_graph("OA", scale=0.006024, seed=0)
    np.testing.assert_array_equal(np.asarray(g.indices),
                                  res.graph.indices.numpy())
    micro = res.micro.numpy()
    exp = np.stack([np.asarray(gcn_forward(params, g, jnp.asarray(x)))
                    for x in micro])
    assert float(np.abs(res.out.numpy() - exp).max()) < 1e-3
    assert res.schedule and res.rescheduled
    assert np.isfinite(res.inf_per_s) and res.inf_per_s > 0


def test_serve_pipeline_cli_on_cpu(capsys):
    main(["--scale", "0.006024", "--micro", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[dype] schedule" in text and "[dype] drift" in text
    assert "[done]" in text
