"""The port's dry run (``launch/dryrun.py``) and its parts, on the CPU.

  (a) ``launch/steps.py:input_specs`` against the reference's, every cell
      of ``configs.ARCHS`` x ``SHAPES`` on the production meshes (16, 16)
      and (2, 16, 16): each argument leaf's global shape, dtype and shard
      shape (the reference's from one subprocess with 512 forced host
      devices), which covers ``abstract_quantize_params`` and
      ``_cache_sharding_tree``;
  (b) a config with full attention and no hand-written kernel (gemma-2b
      smoke) on a (1, 1) mesh: the dry run's ``dot_flops`` on meta tensors
      equal ``FlopCounterMode`` over the same step on real CPU tensors;
  (c) the collective tally against a gloo world: in tests/test_torch_dist.py
      (``test_dry_run_tally_matches_the_gloo_world``), whose (2, 2) world
      counts it;
  (d) each kernel's work formula at a tiny shape against a count by hand,
      and, on meta tensors, the route's name in the tally against
      ``_route`` and ``_bwd_route`` and its wrappers' workspaces; real
      tensors untouched by the tally;
  (e) the reference's skip rule, and decode cells traced, one token;
  (f) ``argument_bytes`` equal to ``dist.per_card_bytes`` of the
      parameters and the AdamW state plus the batch.

Each fake world is set up and torn down inside the call that needs it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_threads import one_torch_thread  # noqa: F401

from repro_torch import configs as tconfigs
from repro_torch import tally
from repro_torch.configs import LONG_SKIP, SHAPES, ShapeSpec
from repro_torch.kernels import ssd, swa
from repro_torch.launch import dist, dryrun
from repro_torch.launch.steps import abstract_leaves, input_specs
from repro_torch.models import lm
from repro_torch.models.common import AxisEnv, axis_env_for_mesh
from repro_torch.optim import AdamWConfig, opt_state_decls

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}

REF_SPECS = r"""
import json, sys
import jax
from jax.tree_util import DictKey, FlattenedIndexKey
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import input_specs

def key(kp):
    out = ""
    for k in kp:
        if isinstance(k, DictKey):
            out += f"['{k.key}']"
        elif isinstance(k, FlattenedIndexKey):     # QuantizedArray (q, s)
            out += ".q" if k.key == 0 else ".s"
        else:
            out += f"[{k.idx}]"
    return out

out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in ARCHS:
        for s in SHAPES:
            args = input_specs(get_config(arch), SHAPES[s], mesh)
            cell = {}
            for i, a in enumerate(args):
                for kp, l in jax.tree_util.tree_flatten_with_path(a)[0]:
                    sh = l.sharding
                    cell[f"{i}{key(kp)}"] = (
                        list(l.shape), l.dtype.name,
                        list(sh.shard_shape(l.shape) if sh is not None
                             else l.shape))
            out[f"{arch}|{s}|{int(mp)}"] = cell
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("specs") / "ref.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512",
           "PYTHONPATH": os.pathsep.join([str(REPO / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, "-W", "ignore", "-c", REF_SPECS,
                        str(path)], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


def _port_cell(arch, shape, mesh_shape):
    mesh = dryrun.meta_mesh(mesh_shape, dryrun.production_axes(mesh_shape))
    args = input_specs(tconfigs.get_config(arch), SHAPES[shape], mesh)
    return {f"{i}{path}": (list(leaf.shape), str(leaf.dtype).split(".")[-1],
                           list(leaf.local.shape))
            for i, a in enumerate(args) for path, leaf in abstract_leaves(a)}


# ---------------------------------------------------------------------------
# (a) the abstract inputs against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_input_specs_match_reference(ref_specs, arch, mesh):
    for shape in SHAPES:
        want = ref_specs[f"{arch}|{shape}|{int(mesh == '2x16x16')}"]
        got = _port_cell(arch, shape, MESHES[mesh])
        assert got.keys() == want.keys(), (shape, sorted(
            got.keys() ^ want.keys())[:6])
        bad = {k: (got[k], tuple(want[k])) for k in want
               if tuple(got[k]) != tuple(want[k])}
        assert not bad, (shape, dict(list(bad.items())[:6]))


def test_int8_serving_leaves_match_reference():
    """``abstract_quantize_params``: a cell of a config that serves int8
    (gemma-2b with ``serve_quant="int8"``, beside the reference's own):
    the codes cut like their leaf, the scale whole on every rank."""
    import repro.configs as rconfigs  # noqa: F401  (jax is importable)
    cfg = tconfigs.get_config("gemma-2b").replace(serve_quant="int8")
    mesh = dryrun.meta_mesh((16, 16), ("data", "model"))
    params = input_specs(cfg, SHAPES["decode_32k"], mesh)[0]
    leaves = dict(abstract_leaves(params))
    q, s_ = leaves["['layers']['ffn']['wi'].q"], \
        leaves["['layers']['ffn']['wi'].s"]
    assert q.dtype == torch.int8 and s_.dtype == torch.float32
    assert q.local.shape == (18, 2048 // 16, 2 * 16384 // 16)
    assert s_.local.shape == s_.shape == (18, 1, 1)
    assert "['embedding']" in leaves          # never quantized


# ---------------------------------------------------------------------------
# (b) meta dot_flops against real CPU tensors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", ["train", "prefill"])
def test_dot_flops_equal_a_real_cpu_step(step):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models.common import init_params
    from repro_torch.optim import adamw_init
    cfg = tconfigs.get_smoke("gemma-2b")
    assert cfg.attention == "full"
    B, S = 2, 128
    rec = dryrun.evaluate(cfg, ShapeSpec("t", S, B, step), (1, 1))
    assert rec["status"] == "ok" and rec["kernel_calls"] == {}
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu", cfg.pdtype)
    toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    with FlopCounterMode(display=False) as fc:
        if step == "train":
            make_train_step(cfg, device="cpu")(
                params, adamw_init(params, AdamWConfig()), batch)
        else:
            with torch.no_grad():
                make_prefill_step(cfg, device="cpu")(params, batch)
    assert fc.get_total_flops() > 0
    assert rec["dot_flops"] == rec["aten_dot_flops"] == fc.get_total_flops()


# ---------------------------------------------------------------------------
# (d) the kernels' work formulas, and the kernels on meta tensors
# ---------------------------------------------------------------------------
def test_swa_work_by_hand():
    # S 4, window 2: rows see 1, 2, 2, 2 keys -> 7 pairs a (batch, head)
    assert swa.band_pairs(4, 2) == 7
    nbytes, flops = swa.work(1, 2, 1, 4, 8, 2, 2)
    assert flops == 2 * (2 * 8) * 7 * 2           # q.k and p.v, 2 heads
    assert nbytes == (2 * 2 + 2 * 1) * 4 * 8 * 2  # q, o; k, v
    nbytes, flops = swa.bwd_work(1, 2, 1, 4, 8, 2, 2)
    assert flops == 5 * 2 * 8 * 7 * 2
    qsz, kvsz, row = 2 * 4 * 8 * 2, 4 * 8 * 2, 2 * 4 * 4
    assert nbytes == 2 * qsz + 2 * kvsz + 2 * row + qsz + 2 * kvsz


def test_ssd_work_by_hand():
    # b 1, L 2, H 1, P 1, N 1, chunk 2: C B^T's triangle (3 pairs), W x on
    # it, C S^T and the state update (Q P N each), 2 FLOPs a product
    nbytes, flops = ssd.work(1, 2, 1, 1, 1, 2, 2, dt_bytes=4, param_bytes=4)
    assert flops == 2 * (3 + 3 + 2 + 2)
    assert nbytes == 2 * 2 * 2 + 2 * 2 * 2 + 4 + 4 + 4    # x, y; B, C; ...
    nbytes, flops = ssd.bwd_work(1, 2, 1, 1, 1, 2, 2)
    assert flops == (2 * 2 + 3 + 2 * (3 * 3 + (2 * 3 + 4 * 2)))
    assert nbytes == 3 * 4 + 4 * 4 + 4 * 8 + 4 + 4


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=True)


def _peak_of(fn):
    """(fn's result, the peak of the meta memory it allocated)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    mt = MemTracker()
    with mt:
        out = fn()
    return out, mt.get_tracker_snapshot("peak")[torch.device("meta")]["Total"]


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 64)])
def test_swa_meta_route(dtype, D):
    """On meta tensors the route's own wrappers run up to the launch: the
    route that ``_route``/``_bwd_route`` names in the tally with its work,
    the wrappers' allocations (the backward's peak: lse and delta, dk and
    dv, then the wgmma dk/dv launch's float32 sums, freed before dq), and
    no launch counted."""
    from repro_torch.kernels.ops import swa_attention_op
    B, S, H, KV, W = 1, 256, 4, 2, 128
    q, k, v = (_meta(B, S, n, D, dtype=dtype) for n in (H, KV, KV))
    counters = [swa.swa_attention, *swa._KERNELS.values(),
                *swa._BWD_ENTRY_FNS.values()]
    before = [f.launches for f in counters]
    with tally.counting() as t:
        o = swa_attention_op(q, k, v, window=W, scale=0.1)
        o.float().sum().backward()
    assert o.shape == q.shape and q.grad.shape == q.shape
    fwd, bwd = swa._route(dtype, D), swa._bwd_route(dtype, D)
    es = q.element_size()
    work, bwork = (f(B, H, KV, S, D, W, es) for f in (swa.work,
                                                      swa.bwd_work))
    assert t.kernels == {
        f"swa_attention_{fwd}": {"calls": 1, "flops": work[1],
                                 "bytes": work[0]},
        f"swa_attention_bwd_{bwd}": {"calls": 1, "flops": bwork[1],
                                     "bytes": bwork[0]}}
    qh, kh = (torch.empty(B, n, S, D, dtype=dtype, device="meta")
              for n in (H, KV))
    grads, peak = _peak_of(lambda: swa.swa_attention_bwd(
        qh, kh, kh, qh, qh, window=W, scale=0.1))
    sums = 2 * kh.numel() * 4 if bwd == "wgmma" else 0
    assert peak == 2 * B * H * S * 4 + 2 * _nbytes(kh) + max(sums,
                                                             _nbytes(qh))
    assert [g.shape for g in grads] == [qh.shape, kh.shape, kh.shape]
    assert [f.launches for f in counters] == before
    bad = _meta(B, 200, H, D, dtype=dtype)
    with pytest.raises(ValueError, match="multiples of 128"):
        swa.swa_attention(bad.transpose(1, 2), bad.transpose(1, 2)[:, :2],
                          bad.transpose(1, 2)[:, :2], window=100, scale=1.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_meta_route(dtype):
    """As for SWA: the routes' wrappers up to the launch, the tally's
    calls and work, the forward under grad keeping la and the entering
    states, and the backward's peak the outputs and its launches'
    workspaces (R, which the scan overwrites with g; the scan's dle (FMA)
    or slices of <g, S> (tc); on the tc route dGs and the row sums qc and
    xg; D's partial sums)."""
    b, L, H, P, N, Q = 2, 512, 3, 64, 128, 256
    x, dt = _meta(b, L, H, P, dtype=dtype), _meta(b, L, H, dtype=dtype)
    B, C = _meta(b, L, N, dtype=dtype), _meta(b, L, N, dtype=dtype)
    A, D = _meta(H, dtype=dtype), _meta(H, dtype=dtype)
    counters = [ssd.ssd_chunked, ssd.ssd_chunked_bwd, *ssd._KERNELS.values(),
                *ssd._STAGE_FNS.values(), *ssd._BWD_ENTRY_FNS.values()]
    before = [f.launches for f in counters]
    with tally.counting() as t:
        y, _ = ssd.ssd_chunked(x, dt, B, C, A, D, chunk=Q)
        y.float().sum().backward()
        with torch.no_grad():
            ssd.ssd_chunked(x, dt, B, C, A, D, chunk=Q)
    route, broute = ssd._route(dtype, P, N, Q), ssd._bwd_route(dtype, P, N, Q)
    assert route == broute == ("tc" if dtype == torch.bfloat16 else "fma")
    assert set(t.kernels) == {f"ssd_chunked_{route}",
                              f"ssd_chunked_bwd_{broute}"}
    assert t.kernels[f"ssd_chunked_{route}"]["calls"] == 2
    assert t.kernels[f"ssd_chunked_{route}"]["flops"] == 2 * ssd.work(
        b, L, H, P, N, Q, x.element_size(), dt_bytes=0, param_bytes=0)[1]
    assert t.kernels[f"ssd_chunked_bwd_{broute}"] == {
        "calls": 1, "flops": ssd.bwd_work(b, L, H, P, N, Q,
                                          x.element_size())[1],
        "bytes": ssd.bwd_work(b, L, H, P, N, Q, x.element_size())[0]}
    assert x.grad.shape == x.shape and A.grad.shape == A.shape
    nc = L // Q
    with torch.no_grad():
        dts, da = ssd._discretize(dt, A)
        _, _, la, s_in = ssd.ssd_chunked_fwd(x, dts, da, B, C, D, chunk=Q)
        assert (la.shape, s_in.shape) == ((b, L, H), (b, nc, H, P, N))
        dy = torch.empty_like(x)
        out, peak = _peak_of(lambda: ssd.ssd_chunked_bwd(
            x, dts, la, B, C, D, s_in, dy, chunk=Q))
    ws = b * nc * H * P * N + b * nc * H + (
        b * nc * H * P * N // ssd.BWD_SLICE + b * nc * Q * Q
        + 2 * (N // ssd.BWD_BOX) * b * L * H if broute == "tc"
        else b * nc * H)
    assert peak == _nbytes(*out) + 4 * ws
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="no SSD kernel"):
        ssd.ssd_chunked(_meta(b, L, H, 16, dtype=dtype), dt, B, C, A, D,
                        chunk=Q)


def test_real_tensors_keep_their_routes():
    """A CPU tensor takes the plain version and counts nothing, inside a
    tally too."""
    q = torch.randn(1, 2, 256, 64)
    with tally.counting() as t:
        out = swa.swa_attention(q, q, q, window=128, scale=0.1)
    assert t.kernels == {}
    torch.testing.assert_close(out, swa.swa_attention_plain(
        q, q, q, window=128, scale=0.1), rtol=0, atol=0)


def test_fake_world_refuses_an_existing_group():
    with dryrun.fake_world(1, 0):
        with pytest.raises(RuntimeError, match="already exists"):
            with dryrun.fake_world(1, 0):
                pass
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# (e) skipped and decode cells
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(LONG_SKIP))
def test_long_500k_skips_full_attention_archs(arch):
    rec = dryrun.run_cell(arch, "long_500k", False, save=False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == ("full-attention arch; long_500k requires "
                             "sub-quadratic attention (DESIGN.md §4)")


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_decode_cells_record_their_arguments(shape, multi_pod):
    """A decode cell traces one serve step of its rank (the sharded
    decode), with and without int8 weights: ``ok``, its argument bytes
    the specs' (int8 below plain), the cache donated, and the step's
    FLOPs, bytes and collectives over ``model`` recorded."""
    for quant in ("", "int8"):
        cfg = tconfigs.get_config("qwen3-4b").replace(serve_quant=quant)
        rec = dryrun.run_cell("qwen3-4b", shape, multi_pod, save=False,
                              override_cfg=cfg)
        assert rec["status"] == "ok" and "reason" not in rec
        assert rec["dot_flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["collectives_by_axis"]["model"]["all-reduce"]["count"]
        assert 0 < rec["memory"]["alias_bytes"] < rec["memory"][
            "argument_bytes"] <= rec["memory"]["peak_bytes"]
        grid = (2, 16, 16) if multi_pod else (16, 16)
        mesh = dryrun.meta_mesh(grid, dryrun.production_axes(grid))
        assert rec["memory"]["argument_bytes"] == sum(
            leaf.nbytes for a in input_specs(cfg, SHAPES[shape], mesh)
            for _, leaf in abstract_leaves(a))
        if quant:
            assert rec["memory"]["argument_bytes"] < plain
        plain = rec["memory"]["argument_bytes"]


# ---------------------------------------------------------------------------
# (f) argument bytes from the specs
# ---------------------------------------------------------------------------
def _spec_bytes(cfg, shape, ax):
    decls = lm.model_decls(cfg, ax)
    n = dist.per_card_bytes(decls, ax, cfg.pdtype)
    if shape.step == "train":
        n += dist.per_card_bytes(opt_state_decls(decls, AdamWConfig(
            state_dtype=cfg.opt_state_dtype)), ax, torch.float32)
    rows = shape.global_batch // ax.size(ax.dp) \
        if shape.global_batch % ax.size(ax.dp) == 0 else shape.global_batch
    S_txt = shape.seq_len - (cfg.prefix_tokens if cfg.family == "vlm" else 0)
    n += 2 * rows * S_txt * 4
    if cfg.family == "vlm":
        n += rows * cfg.prefix_tokens * cfg.frontend_dim * 2
    if cfg.family == "encdec":
        n += rows * shape.seq_len * cfg.d_model * 2
    return n


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_argument_bytes_are_per_card_bytes(arch):
    cfg = tconfigs.get_config(arch)
    for grid in MESHES.values():
        mesh = dryrun.meta_mesh(grid, dryrun.production_axes(grid))
        ax = axis_env_for_mesh(mesh)
        for name in ("train_4k", "prefill_32k"):
            got = sum(leaf.nbytes for a in input_specs(cfg, SHAPES[name],
                                                       mesh)
                      for _, leaf in abstract_leaves(a))
            assert got == _spec_bytes(cfg, SHAPES[name], ax), (grid, name)


def test_run_cell_on_a_callers_mesh_saves_under_its_tag(tmp_path,
                                                       monkeypatch):
    """``run_cell``'s ``mesh_shape`` and ``tag``: a smoke config's cell on
    a (2, 2) mesh, its record saved beside the production ones under the
    tag."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    cfg = tconfigs.get_smoke("qwen3-4b")
    rec = dryrun.run_cell("qwen3-4b", "prefill_32k", False, override_cfg=cfg,
                          tag="smoke", mesh_shape=(2, 2))
    assert rec["status"] == "ok"
    assert (rec["mesh"], rec["n_devices"], rec["rank"]) == ("2x2", 4, 3)
    assert json.loads((tmp_path / "qwen3-4b__prefill_32k_smoke.json"
                       ).read_text()) == rec
    with pytest.raises(AssertionError):
        dryrun.run_cell("qwen3-4b", "prefill_32k", True, save=False,
                        override_cfg=cfg, mesh_shape=(2, 2))


def test_a_run_records_the_argument_bytes():
    """A smoke run on a fake (2, 2) world: the record's argument bytes
    are the specs', and the state it made is what the tracker holds
    beside the temporaries."""
    cfg = tconfigs.get_smoke("qwen3-4b")
    shape = ShapeSpec("t", 128, 4, "train")
    rec = dryrun.evaluate(cfg, shape, (2, 2))
    ax = AxisEnv(sizes={"data": 2, "model": 2})
    mem = rec["memory"]
    assert mem["argument_bytes"] == _spec_bytes(cfg, shape, ax)
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["alias_bytes"] == mem["argument_bytes"] - 2 * 2 * 128 * 4
    assert rec["coords"] == {"data": 1, "model": 1} and rec["rank"] == 3
    assert rec["collectives"]["all-gather"]["count"] > 0
    assert np.isfinite(rec["bytes_accessed"]) and rec["trace_s"] >= 0
