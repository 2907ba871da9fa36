"""The port's boundary: nothing under src/repro_torch/ (nor chip_smoke.py)
imports jax or the JAX package, and every entry point refuses to run on the
CPU unless the caller asks for it."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(REPO / "src")!r})
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = [n for n in sys.modules
       if n.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK" in r.stdout


def _entry_points():
    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.data import table1_graph
    from repro_torch.kernels import BlockedEll, CsrOperand, ssd_chunked
    from repro_torch.cluster import LocalCluster
    from repro_torch.configs import get_smoke
    from repro_torch.core import paper_system
    from repro_torch.launch import serve as serve_stream
    from repro_torch.launch import serve_prefill as prefill
    from repro_torch.launch.serve_pipeline import main, serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import (init_params, lm_params_from_numpy,
                                    model_decls)
    from repro_torch.models.lm import init_cache
    from repro_torch.models.mla import init_mla_cache
    from repro_torch.models import (gcn_params_from_numpy, init_gcn_params,
                                    init_gin_params)
    from repro_torch.runtime import (GroupedPipelineExecutor,
                                     PipelineExecutor)
    from repro_torch.sparse import csr_from_dense, random_graph_csr

    a = np.eye(16, dtype=np.float32)
    lm = get_smoke("qwen3-4b")
    return {
        "resolve_device": lambda: resolve_device(),
        "random_graph_csr": lambda: random_graph_csr(32, 64),
        "csr_from_dense": lambda: csr_from_dense(a),
        "table1_graph": lambda: table1_graph("OA", scale=1e-4),
        "BlockedEll.from_numpy": lambda: BlockedEll.from_numpy(
            a.reshape(1, 1, 16, 16), np.zeros((1, 1), np.int32), 16),
        "CsrOperand.from_csr": lambda: CsrOperand.from_csr(
            csr_from_dense(a, device="cpu")),
        "CsrOperand.from_blocked_ell": lambda: CsrOperand.from_blocked_ell(
            a.reshape(1, 1, 16, 16), np.zeros((1, 1), np.int32), 16),
        "init_gcn_params": lambda: init_gcn_params(8, 8),
        "init_gin_params": lambda: init_gin_params(8, 8),
        "gcn_params_from_numpy": lambda: gcn_params_from_numpy(
            [{"theta": a}]),
        "PipelineExecutor": lambda: PipelineExecutor(
            [lambda p, x: x], {}, (2, 2)),
        "GroupedPipelineExecutor": lambda: GroupedPipelineExecutor(
            [lambda p, x: x], {}, (2, 2), (1,)),
        "serve": lambda: serve("OA", 1, scale=0.006024),
        "serve_pipeline.main": lambda: main(["--scale", "0.006024"]),
        "init_params": lambda: init_params(model_decls(lm)),
        "lm_params_from_numpy": lambda: lm_params_from_numpy(
            {"embedding": np.zeros((lm.padded_vocab, lm.d_model))}, lm),
        "make_prefill_step": lambda: make_prefill_step(lm),
        "serve_prefill": lambda: prefill.serve_prefill(
            smoke=True, prompt_len=256, window=128),
        "serve_prefill.main": lambda: prefill.main(
            ["--smoke", "--prompt-len", "256", "--window", "128"]),
        "ssd_chunked": lambda: ssd_chunked(
            *(torch.zeros(s, device=resolve_device()) for s in
              ((1, 64, 2, 64), (1, 64, 2), (1, 64, 64), (1, 64, 64), (2,),
               (2,))), chunk=64),
        "serve_prefill mamba2": lambda: prefill.serve_prefill(
            "mamba2-780m", shape="prefill_32k", smoke=True, prompt_len=256),
        "LocalCluster torch": lambda: LocalCluster(
            paper_system("pcie4"), 2, backend="torch"),
        "serve --stream --cluster 2 --backend torch": lambda:
            serve_stream.main(["--stream", "--duration", "5", "--day", "5",
                               "--cluster", "2", "--backend", "torch"]),
        "serve --stream --tenants --backend torch": lambda:
            serve_stream.main(["--stream", "--duration", "5", "--day", "5",
                               "--tenants", "gold:0:1:2.5,bronze:2:9:15",
                               "--backend", "torch"]),
        "serve --stream --cluster 2 --dashboard --backend torch": lambda:
            serve_stream.main(["--stream", "--duration", "5", "--day", "5",
                               "--cluster", "2", "--dashboard",
                               "--backend", "torch"]),
        "serve_prefill.main mamba2": lambda: prefill.main(
            ["--arch", "mamba2-780m", "--shape", "prefill_32k", "--smoke",
             "--prompt-len", "256"]),
        "serve_prefill.main zamba2": lambda: prefill.main(
            ["--arch", "zamba2-7b", "--shape", "prefill_32k", "--smoke",
             "--prompt-len", "64"]),
        "make_serve_step": lambda: make_serve_step(lm),
        "init_cache": lambda: init_cache(lm, 1, 8),
        "serve decode mode": lambda: serve_stream.main(
            ["--arch", "gemma-2b", "--smoke", "--batch", "2",
             "--prompt-len", "8", "--gen", "8"]),
        "serve decode mode --int8 zamba2": lambda: serve_stream.main(
            ["--arch", "zamba2-7b", "--smoke", "--int8"]),
        "make_prefill_step deepseek": lambda: make_prefill_step(
            get_smoke("deepseek-v2-236b")),
        "make_prefill_step seamless": lambda: make_prefill_step(
            get_smoke("seamless-m4t-large-v2")),
        "init_mla_cache": lambda: init_mla_cache(
            get_smoke("deepseek-v2-236b"), 1, 8),
        "serve_prefill paligemma": lambda: prefill.serve_prefill(
            "paligemma-3b", smoke=True, prompt_len=256, window=128),
        "serve decode mode deepseek": lambda: serve_stream.main(
            ["--arch", "deepseek-v2-236b", "--smoke"]),
        "serve decode mode seamless": lambda: serve_stream.main(
            ["--arch", "seamless-m4t-large-v2", "--smoke"]),
        "serve decode mode paligemma": lambda: serve_stream.main(
            ["--arch", "paligemma-3b", "--smoke"]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _entry_points()[name]()
