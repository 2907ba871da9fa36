"""The port's SPMD training path (``launch/dist.py``, ``lm_loss`` and
``make_train_step`` with a mesh) against the reference on its own (2, 2)
mesh, on the CPU.

One gloo world of 4 CPU processes on a (2, 2) ("data", "model") mesh,
spawned once for the module, one torch thread each; the reference's values
from one subprocess with 4 forced host devices (tests/dist_harness.py says
how each side runs). Every model copy is float32 with ``fsdp=True`` on the
same seeded numpy parameters:

  * every collective's forward and gradient against whole-tensor sums,
    over data and over model;
  * gemma-2b smoke (vocab 512): the vocab-parallel loss and its gradients
    against the reference's vp path, and against the port's unsharded
    loss;
  * deepseek-v3 smoke: expert parallelism (4 experts a model rank, the
    capacity from each shard's tokens, the aux loss averaged over data)
    against the reference, under the near-tie rule of
    tests/test_torch_zoo.py;
  * zamba2 (the shared attention block gathered at each use), seamless
    (the encoder, the frames cut over data) and paligemma (the prefix,
    ``vision_proj``): loss and gradients against the reference, and
    against the port's unsharded loss;
  * mamba2-780m smoke: two ``make_train_step`` steps over two
    microbatches against the reference's jitted ``make_train_step(cfg,
    ax, mesh)``: losses, ``grad_norm``s and every updated parameter,
    gathered; gemma-2b smoke the same with int8 AdamW moments, whose
    codes and scales keep the reference's global 256-blocks;
  * a (1, 1) world: the mesh path's train step equal to the unsharded one
    bit for bit;
  * ``launch/train.py --mesh 2x2 --device cpu``: the loss lines of
    ``--mesh 1x1``;
  * every case's prefill step on the mesh (``make_prefill_step(mesh=)``)
    against the reference's ``make_prefill_step`` on its (2, 2) mesh;
  * the dry run (``launch/dryrun.py``): the collectives that one rank of
    a fake (2, 2) world counts on meta tensors for gemma-2b's int8 train
    step equal those that the gloo world's ranks counted in the same
    step.

Bounds as tests/test_torch_train.py: the loss within 1e-5 relative, each
gradient within 1e-4 of its leaf's largest element; updated parameters
within 1e-5 of each leaf's largest; the prefill logits as
tests/test_torch_lm.py's float32 prefill step, 1e-4.
"""
import os
import pickle
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_threads import one_torch_thread  # noqa: F401

import dist_harness as dh
from repro_torch import configs as tconfigs
from repro_torch.launch import dist, dryrun
from repro_torch.models import lm
from repro_torch.models.common import AxisEnv, tree_from_leaves, tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4
PARAM_SHARE = 1e-5
PREFILL_TOL = 1e-4
TIMEOUT = 300                     # seconds for each of the subprocesses
CLI = ["-m", "repro_torch.launch.train", "--arch", "qwen3-4b", "--smoke",
       "--steps", "2", "--device", "cpu", "--mesh"]


def _inputs():
    out = {}
    for i, name in enumerate(dh.CASES):
        cfg = dh.case_config(tconfigs, name)
        rng = np.random.default_rng(100 + i)
        toks = rng.integers(0, cfg.vocab_size,
                            (dh.B, dh.S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = rng.normal(size=(
                dh.B, cfg.prefix_tokens, cfg.frontend_dim)).astype(np.float32)
        if cfg.family == "encdec":
            batch["src_frames"] = rng.normal(
                size=(dh.B, dh.S, cfg.d_model)).astype(np.float32)
        out[name] = {"params": dh.numpy_params(lm.model_decls(cfg),
                                               tree_leaves, seed=i),
                     "batch": batch}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference, the port's two worlds and the two CLI runs, as
    subprocesses one after another (one at a time keeps the burst of
    processes small beside the other test workers), each under
    ``TIMEOUT``."""
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    harness = str(Path(dh.__file__))
    cmds = {side: [harness, side, str(d / "in.pkl"), str(d / f"{side}.pkl")]
            for side in ("ref", "port")}
    cmds.update({m: CLI + [m] for m in ("2x2", "1x1")})
    out = {"inputs": inp}
    for k, c in cmds.items():
        r = subprocess.run([sys.executable, "-W", "ignore", *c], env=env,
                           cwd=REPO, text=True, capture_output=True,
                           timeout=TIMEOUT)
        assert r.returncode == 0, f"{k}: {r.stderr[-3000:]}"
        out[k] = r.stdout
    for side in ("ref", "port"):
        with open(d / f"{side}.pkl", "rb") as f:
            out[side] = pickle.load(f)
    return out


def _hold_grads(got, want):
    assert got.keys() == want.keys()
    for k, r in want.items():
        t = got[k]
        assert t.shape == r.shape, k
        assert np.abs(t - r).max() <= GRAD_SHARE * np.abs(r).max() + 1e-12, \
            (k, float(np.abs(t - r).max()), float(np.abs(r).max()))


def _ranks(runs, name):
    ranks = [r[name] for r in runs["port"]["2x2"]]
    # the loss is the global mean, the same on every rank
    assert len({r["loss"] for r in ranks}) == 1
    return ranks


GROUPS = {"data": lambda r: [r % 2, 2 + r % 2],
          "model": lambda r: [r - r % 2, r - r % 2 + 1]}


@pytest.mark.parametrize("axis", ["data", "model"])
def test_collectives_forward_and_gradient(runs, axis):
    """x_r and the cotangent weight c_r as tests/dist_harness.py makes
    them; each forward and gradient against the sums over the rank's
    group, whole."""
    x = [r + np.array([0.0, 0.5, 1.0]) for r in range(4)]
    c = [1 + r * np.array([1.0, 2.0, 3.0]) for r in range(4)]
    for r, res in enumerate(runs["port"]["2x2"]):
        col = res["collectives"]
        g = GROUPS[axis](r)
        assert col["coords"] == {"data": r // 2, "model": r % 2}
        assert col["axis_index"][axis] == g.index(r)
        want = {
            "psum": (sum(x[i] for i in g), c[r]),
            "enter": (x[r], sum(c[i] for i in g)),
            "pmean": (sum(x[i] for i in g) / 2, c[r] / 2),
            # over data the ranks computed on other rows: the gather's
            # backward sums; over model it takes the rank's own slice
            "gather0": (np.concatenate([x[i] for i in g]),
                        sum(c[i] for i in g) if axis == "data" else c[r]),
        }
        want["gather1"] = want["gather0"]
        for name, (fwd, grad) in want.items():
            got_f, got_g = col[f"{name}/{axis}"]
            np.testing.assert_allclose(got_f, fwd, rtol=0, atol=1e-6)
            np.testing.assert_allclose(got_g, grad, rtol=0, atol=1e-6)
        mx, needs_grad = col[f"pmax/{axis}"]
        np.testing.assert_allclose(mx, np.maximum(*(x[i] for i in g)))
        assert not needs_grad


def test_vocab_parallel_loss_matches_reference(runs):
    """gemma-2b (tied embeddings, V 512 cut over model): the vp path on
    every rank against the reference's vp path on its (2, 2) mesh, and
    against the port's unsharded loss and gradients."""
    ranks = _ranks(runs, "gemma")
    assert all(r["vp_pmax_calls"] > 0 for r in ranks)
    ref = runs["ref"]["gemma"]
    assert ranks[0]["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    for r in ranks:
        _hold_grads(r["grads"], ref["grads"])
    loss, grads = _unsharded(runs, "gemma", dh.B)
    assert ranks[0]["loss"] == pytest.approx(loss, rel=LOSS_RTOL)
    _hold_grads(ranks[0]["grads"], grads)


def _unsharded(runs, name, rows):
    """The port's loss and gradients on one device, on the first ``rows``
    rows of the case's batch."""
    cfg = dh.case_config(tconfigs, name)
    inp = runs["inputs"][name]
    tp = lm.lm_params_from_numpy(tree_from_leaves(lm.model_decls(cfg),
                                                  inp["params"]), cfg,
                                 device="cpu")
    for _, t in tree_leaves(tp):
        t.requires_grad_(True)
    loss = lm.lm_loss(tp, {k: torch.from_numpy(v[:rows]) for k, v in
                           inp["batch"].items()}, cfg)
    loss.backward()
    return float(loss.detach()), {k: t.grad.numpy()
                                  for k, t in tree_leaves(tp)}


OTHER_FAMILIES = ["zamba2", "seamless", "paligemma"]


@pytest.mark.parametrize("name", OTHER_FAMILIES)
def test_other_families_match_reference(runs, name):
    """zamba2, seamless and paligemma on every rank against the
    reference's loss and gradients on its own (2, 2) mesh."""
    ref = runs["ref"][name]
    for r in _ranks(runs, name):
        assert r["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
        _hold_grads(r["grads"], ref["grads"])


@pytest.mark.parametrize("name", OTHER_FAMILIES)
def test_other_families_match_the_unsharded_port(runs, name):
    """zamba2 (the shared attention block gathered at each of its uses),
    seamless (the encoder's layers, the frames cut over data) and
    paligemma (the prefix embeddings cut over data, vision_proj): the
    loss and gradients of the unsharded port, itself held to the
    reference by tests/test_torch_train.py."""
    ranks = _ranks(runs, name)
    loss, grads = _unsharded(runs, name, dh.B)
    for r in ranks:
        assert r["loss"] == pytest.approx(loss, rel=LOSS_RTOL)
        _hold_grads(r["grads"], grads)


def test_a_batch_that_does_not_divide_is_replicated(runs):
    """3 rows over 2 data ranks: every rank computes every row (so the
    vocab-parallel loss, which needs the cut batch, is off), and the loss
    and gradients are the unsharded ones."""
    ranks = _ranks(runs, "gemma_rows3")
    loss, grads = _unsharded(runs, "gemma", 3)
    for r in ranks:
        assert r["vp_pmax_calls"] == 0
        assert r["loss"] == pytest.approx(loss, rel=LOSS_RTOL)
        _hold_grads(r["grads"], grads)


def test_expert_parallel_moe_matches_reference(runs):
    """deepseek-v3 (8 experts, 4 a model rank, capacity factor 1.25, aux
    weight 0.001) against the reference on (2, 2). Each shard's router
    probabilities at the top-k boundary lie more than ``TIE_ULPS`` apart
    at these inputs, so no token's choice can go either way and the
    gradients are held whole (tests/test_torch_zoo.py's rule)."""
    ranks = _ranks(runs, "deepseek")
    for r in ranks:
        assert min(r["router_margin_ulps"]) > dh.TIE_ULPS
    ref = runs["ref"]["deepseek"]
    assert ranks[0]["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    for r in ranks:
        _hold_grads(r["grads"], ref["grads"])


@pytest.mark.parametrize("name", dh.TRAIN)
def test_train_step_matches_reference(runs, name):
    """mamba2-780m (two microbatches a step) and gemma-2b with int8
    moments, two steps: each loss, each grad_norm (the whole tree's, on
    every rank) and every parameter after the second step."""
    ranks = _ranks(runs, name)
    ref = runs["ref"][name]
    for r in ranks:
        assert r["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
        assert r["grad_norm"] == pytest.approx(ref["grad_norm"],
                                               rel=LOSS_RTOL)
        assert r["params"].keys() == ref["params"].keys()
        for k, want in ref["params"].items():
            err = np.abs(r["params"][k] - want).max()
            assert err <= PARAM_SHARE * np.abs(want).max(), (k, err)


def test_int8_moments_keep_the_global_blocks(runs):
    """gemma-2b's int8 AdamW moments after two steps on (2, 2): each
    rank's codes and scales have the local shapes of ``opt_state_decls``'
    specs (the last dim cut over data or model: the padded full row's
    slice, and the full row's scales), and, gathered, they are the
    reference's: every scale within one bfloat16 step (2**-8, relative)
    and every code within one, since a gradient that differs in its last
    float32 bits can round a bfloat16 moment to its neighbour. Blocks cut
    by the shards would give other scales and other shapes."""
    ref = runs["ref"]["gemma_int8"]["state"]
    for r in _ranks(runs, "gemma_int8"):
        bad = {p: s for p, s in r["state_shapes"].items() if s[0] != s[1]}
        assert not bad, bad
        assert r["state"].keys() == ref.keys()
        for k, want in ref.items():
            got = r["state"][k]
            assert got.shape == want.shape, k
            if k.endswith("['scale']"):
                np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                                           atol=0, err_msg=k)
            elif k.endswith("['codes']"):
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1, (k, int(diff.max()))
    # the case cuts last dims over both groups, each shard narrower than
    # a block
    ax = AxisEnv(sizes={"data": 2, "model": 2})
    cut = {d.spec[-1] for _, d in tree_leaves(lm.model_decls(
        dh.case_config(tconfigs, "gemma_int8"), ax))
        if len(d.spec) == len(d.shape) and d.shape[-1] < 2 * 256}
    assert {"data", "model"} <= cut


@pytest.mark.parametrize("name", list(dh.CASES))
def test_one_device_mesh_equals_the_unsharded_step(runs, name):
    """On a (1, 1) world every gather and psum is an identity and vp is
    off: each step's loss and grad_norm and every parameter after the
    last step bit for bit."""
    got, want = (runs["port"]["1x1"][f"{name}/{k}"] for k in
                 ("mesh", "plain"))
    assert np.array_equal(got["loss"], want["loss"])
    assert np.array_equal(got["grad_norm"], want["grad_norm"])
    for k, w in want["params"].items():
        assert np.array_equal(got["params"][k], w), k


@pytest.mark.parametrize("name", list(dh.CASES) + ["gemma_rows3"])
def test_prefill_step_on_a_mesh_matches_reference(runs, name):
    """``make_prefill_step(cfg, mesh=)`` on every rank (the rows of the
    rank's data shard, gathered; every row on every rank for the 3 rows
    that do not divide) against the reference's ``make_prefill_step(cfg,
    ax, mesh)`` on its (2, 2) mesh; the 3-row case against the first 3
    rows of gemma's (each row's logits are its own)."""
    want = runs["ref"]["gemma" if name == "gemma_rows3" else name][
        "prefill"]
    for r in runs["port"]["2x2"]:
        got = r[name]["prefill"]
        np.testing.assert_allclose(got, want[:got.shape[0]],
                                   atol=PREFILL_TOL, rtol=PREFILL_TOL)


def test_dry_run_tally_matches_the_gloo_world(runs):
    """One rank of a fake (2, 2) world on meta tensors
    (``dryrun.evaluate``) counts the collectives that every rank of the
    gloo world counted in the same train step of gemma-2b with int8
    moments (the vocab-parallel loss, FSDP gathers and reduce-scatters,
    the moments' row gathers, the norm's sums): kind, group, count and
    bytes."""
    from repro_torch.configs import ShapeSpec
    cfg = dh.case_config(tconfigs, "gemma_int8")
    rec = dryrun.evaluate(cfg, ShapeSpec("case", dh.S, dh.B, "train"),
                          (2, 2))
    assert rec["collectives_by_axis"]["model"]["all-reduce"]["count"] > 0
    for r in runs["port"]["2x2"]:
        assert r["gemma_int8"]["tally"] == rec["collectives_by_axis"]


def _loss_lines(stdout):
    return [(int(s), float(l), float(g)) for s, l, g in re.findall(
        r"\[train\] step\s+(\d+) loss ([\d.]+) gnorm ([\d.]+)", stdout)]


def test_train_cli_mesh_matches_one_device(runs):
    assert "params on 4 devices" in runs["2x2"]
    assert "params on 1 devices" in runs["1x1"]
    four, one = _loss_lines(runs["2x2"]), _loss_lines(runs["1x1"])
    assert [s for s, _, _ in four] == [0, 1] == [s for s, _, _ in one]
    for (_, l4, g4), (_, l1, g1) in zip(four, one):
        assert l4 == pytest.approx(l1, rel=LOSS_RTOL)
        assert g4 == pytest.approx(g1, rel=LOSS_RTOL)


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError,
                       match=r"(?s)rank 1 of mesh .*rank one fails"):
        dist.launch(dh.raises_on_rank_one, (1, 2), ("data", "model"),
                    device="cpu", timeout=120)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_under_torchrun_runs_this_rank():
    """With ``RANK`` and ``WORLD_SIZE`` set (``torchrun``'s environment)
    ``launch`` runs this process's slot and spawns nothing."""
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "PYTHONPATH": os.pathsep.join([str(REPO / "src"),
                                          str(REPO / "tests")])}
    code = ("from repro_torch.launch import dist; "
            "import dist_harness as dh; "
            "print(dist.launch(dh.raises_on_rank_one, (1, 1), "
            "device='cpu'))")
    r = subprocess.run([sys.executable, "-W", "ignore", "-c", code],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[0]"


def test_no_fallback():
    """More slots than cards raises (the mesh names no CPU); a checkpoint
    directory with --mesh raises with its reason."""
    from repro_torch.launch import train
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA device"):
        dist.launch(dh.raises_on_rank_one, (1, have + 1),
                    ("data", "model"))
    with pytest.raises(ValueError, match="sharded checkpoint"):
        train.main(["--arch", "qwen3-4b", "--smoke", "--mesh", "2x2",
                    "--device", "cpu", "--ckpt-dir", "/nonexistent"])


def test_ax_must_be_the_mesh_axes():
    """The port's mesh carries its axis environment; an ``ax`` beside it
    (the reference's signature) must be that one, and is refused without
    a mesh."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import CPU_AXES
    cfg = tconfigs.get_smoke("qwen3-4b")
    with pytest.raises(ValueError, match="axis environment"):
        make_train_step(cfg, ax=CPU_AXES, device="cpu")
    with pytest.raises(ValueError, match="axis environment"):
        lm.lm_loss({}, {}, cfg, CPU_AXES)
