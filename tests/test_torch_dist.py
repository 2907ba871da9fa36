"""The port's SPMD training path (``launch/dist.py``, ``lm_loss`` and
``make_train_step`` with a mesh) against the reference on its own (2, 2)
mesh, on the CPU.

One gloo world of 4 CPU processes on a (2, 2) ("data", "model") mesh,
spawned once for the module, one torch thread each; the reference's values
from one subprocess with 4 forced host devices (tests/dist_harness.py says
how each side runs). Every model copy is float32 with ``fsdp=True`` on the
same seeded numpy parameters:

  * every collective's forward and gradient against whole-tensor sums,
    over data and over model, those of tensor parallelism too (``take``'s
    all-to-all, ``allsum``, ``own``);
  * gemma-2b smoke (vocab 512): the vocab-parallel loss and its gradients
    against the reference's vp path, and against the port's unsharded
    loss;
  * deepseek-v3 smoke: expert parallelism (4 experts a model rank, the
    capacity from each shard's tokens, the aux loss averaged over data)
    against the reference, under the near-tie rule of
    tests/test_torch_zoo.py;
  * zamba2 (the shared attention block gathered at each use), seamless
    (the encoder, the frames cut over data), paligemma (the prefix,
    ``vision_proj``) and qwen3-8b (GQA, qk-norm, one KV head a model
    rank): loss and gradients against the reference, and against the
    port's unsharded loss;
  * tensor parallelism over ``model`` (``models/tp.py``) in every case:
    each model rank's FLOPs of the loss and its gradients within 1.3x of
    the unsharded step's on its rows over tp (gemma, qwen3), and no leaf
    of a layer gathered over ``model`` (each layer's heads, d_ff and SSM
    heads divide at tp 2);
  * mamba2-780m smoke: two ``make_train_step`` steps over two
    microbatches against the reference's jitted ``make_train_step(cfg,
    ax, mesh)``: losses, ``grad_norm``s and every updated parameter,
    gathered; gemma-2b smoke the same with int8 AdamW moments, whose
    codes and scales keep the reference's global 256-blocks;
  * a (1, 1) world: the mesh path's train step equal to the unsharded one
    bit for bit;
  * ``launch/train.py --mesh 2x2 --device cpu``: the loss lines of
    ``--mesh 1x1``; with ``--ckpt-dir``, a run stopped after its step-2
    checkpoint and restarted replays an uninterrupted run's step-4 line
    and its step-4 checkpoint bit for bit, and the checkpoint restores on
    one device through ``train``;
  * checkpoints crossing: gemma-2b's int8 state saved by the reference's
    ``save_pytree`` restores on the (2, 2) world, and the world's own
    saved state restores in the reference's ``restore_pytree``, every
    leaf equal, the int8 codes and scales included;
  * every case's prefill step on the mesh (``make_prefill_step(mesh=)``)
    against the reference's ``make_prefill_step`` on its (2, 2) mesh;
  * the dry run (``launch/dryrun.py``): the collectives that one rank of
    a fake (2, 2) world counts on meta tensors for gemma-2b's int8 train
    step, and for gemma-2b's serve step, equal those that the gloo
    world's ranks counted in the same step;
  * the sharded decode (``lm.decode_step(mesh=)``): every ``DECODE`` case
    of tests/dist_harness.py at B 4 (the batch cut over data) and B 1
    (the caches' slots cut over data), fed the reference's tokens: each
    step's logits and the final caches against the reference's decode on
    its (2, 2) mesh (deepseek at B 1 against its unsharded decode, which
    the reference's expert-parallel ``shard_map`` needs), the greedy
    tokens equal outside near ties; no cache leaf gathered over any axis;
    the (1, 1) world equal to the unsharded decode bit for bit; int8
    serving weights quantized on the mesh equal to the reference's
    ``quantize`` of each whole leaf; ``launch/serve.py --mesh 2x2`` prints
    the sample of ``--mesh 1x1`` and of one device.

Bounds as tests/test_torch_train.py: the loss within 1e-5 relative, each
gradient within 1e-4 of its leaf's largest element; updated parameters
within 1e-5 of each leaf's largest; the prefill logits as
tests/test_torch_lm.py's float32 prefill step, 1e-4; the decode's logits
and caches as tests/test_torch_decode.py's float32 decode, 2e-5.
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
# the checkpointed runs on (2, 2): (steps, directory); the restart reuses
# the stopped run's directory
CKPT_CLI = ["-m", "repro_torch.launch.train", "--arch", "qwen3-4b",
            "--smoke", "--device", "cpu", "--mesh", "2x2", "--ckpt-every",
            "2"]
CKPT_RUNS = {"whole": (5, "whole"), "stopped": (3, "cut"),
             "restarted": (5, "cut")}
FLOPS_SHARE = 1.3
F32 = {"atol": 2e-5, "rtol": 2e-5}  # tests/test_torch_decode.py's float32
SERVE_CLI = ["-m", "repro_torch.launch.serve", "--arch", "qwen3-4b",
             "--smoke", "--device", "cpu"]


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
                     "batch": batch,
                     "prompt": rng.integers(0, cfg.vocab_size, (
                         max(dh.DECODE_BATCHES), max(
                             dh.decode_lengths(n)[0] for n in dh.DECODE))
                     ).astype(np.int32)}
        dcfg = dh.decode_config(tconfigs, name)
        if lm.model_decls(dcfg) != lm.model_decls(cfg):
            out[name]["decode_params"] = dh.numpy_params(
                lm.model_decls(dcfg), tree_leaves, seed=50 + i)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference, the port's two worlds and the five CLI runs, as
    subprocesses one after another (one at a time keeps the burst of
    processes small beside the other test workers), each under
    ``TIMEOUT``."""
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    inp["ckpt"] = {side: str(d / f"ckpt_{side}") for side in ("ref", "port")}
    inp["ref_out"] = str(d / "ref.pkl")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    harness = str(Path(dh.__file__))
    cmds = {side: [harness, side, str(d / "in.pkl"), str(d / f"{side}.pkl")]
            for side in ("ref", "port")}
    cmds.update({m: CLI + [m] for m in ("2x2", "1x1")})
    cmds.update({f"serve {m}": SERVE_CLI + (["--mesh", m] if m else [])
                 for m in ("2x2", "1x1", "")})
    cmds.update({k: CKPT_CLI + ["--steps", str(n), "--ckpt-dir",
                                str(d / sub)]
                 for k, (n, sub) in CKPT_RUNS.items()})
    out = {"inputs": inp, "dir": d}
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


@pytest.mark.parametrize("axis", ["data", "model"])
def test_tp_collectives_forward_and_gradient(runs, axis):
    """``take`` (one all-to-all of asked columns, overlapping and
    repeated; its backward adds each rank's cotangent into the owner's
    columns), ``allsum`` (a sum whose backward sums) and ``own`` (the
    rank's slice of a replicated tensor; its backward gathers), as
    tests/dist_harness.py's ``tp_collectives`` runs them, against sums
    over the rank's group."""
    x = [r + np.array([0.0, 0.5, 1.0]) for r in range(4)]
    c = [1 + r * np.arange(1.0, 10.0) for r in range(4)]
    for r, res in enumerate(runs["port"]["2x2"]):
        col = res["tp_collectives"]
        g = GROUPS[axis](r)
        i = g.index(r)
        full = np.concatenate([x[k] for k in g])
        taken = [np.concatenate([np.arange(a, b) for a, b in rj])
                 for rj in dh.TAKE_RANGES]
        grad = np.zeros(6)
        for j, cols in enumerate(taken):
            np.add.at(grad, cols, c[g[j]][:len(cols)])
        want = {"take": (full[taken[i]], grad[3 * i:3 * i + 3]),
                "allsum": (sum(x[k] for k in g),
                           sum(c[k][:3] for k in g)),
                # own: the rank's 3 of (x_r, 1 + x_r); the ranks'
                # cotangents of their slices, gathered, reach both halves
                "own": (np.concatenate([x[r], 1 + x[r]])[3 * i:3 * i + 3],
                        sum(c[k][:3] for k in g))}
        for name, (fwd, grad_want) in want.items():
            got_f, got_g = col[f"{name}/{axis}"]
            np.testing.assert_allclose(got_f, fwd, rtol=0, atol=1e-6,
                                       err_msg=name)
            np.testing.assert_allclose(got_g, grad_want, rtol=0, atol=1e-6,
                                       err_msg=name)


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


OTHER_FAMILIES = ["zamba2", "seamless", "paligemma", "qwen3"]


@pytest.mark.parametrize("name", OTHER_FAMILIES)
def test_other_families_match_reference(runs, name):
    """zamba2, seamless, paligemma and qwen3 on every rank against the
    reference's loss and gradients on its own (2, 2) mesh."""
    ref = runs["ref"][name]
    for r in _ranks(runs, name):
        assert r["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
        _hold_grads(r["grads"], ref["grads"])


@pytest.mark.parametrize("name", OTHER_FAMILIES)
def test_other_families_match_the_unsharded_port(runs, name):
    """zamba2 (the shared attention block gathered at each of its uses),
    seamless (the encoder's layers, the frames cut over data), paligemma
    (the prefix embeddings cut over data, vision_proj) and qwen3 (q_norm
    and k_norm replicated over model, each rank its own KV head): the
    loss and gradients of the unsharded port, itself held to the
    reference by tests/test_torch_train.py."""
    ranks = _ranks(runs, name)
    loss, grads = _unsharded(runs, name, dh.B)
    for r in ranks:
        assert r["loss"] == pytest.approx(loss, rel=LOSS_RTOL)
        _hold_grads(r["grads"], grads)


def _unsharded_flops(runs, name, rows):
    """FlopCounterMode's FLOPs of the port's unsharded loss and its
    gradients on the first ``rows`` rows of the case's batch."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dh.case_config(tconfigs, name)
    inp = runs["inputs"][name]
    tp = lm.lm_params_from_numpy(tree_from_leaves(lm.model_decls(cfg),
                                                  inp["params"]), cfg,
                                 device="cpu")
    for _, t in tree_leaves(tp):
        t.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        lm.lm_loss(tp, {k: torch.from_numpy(v[:rows]) for k, v in
                        inp["batch"].items()}, cfg).backward()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["gemma", "qwen3"])
def test_model_rank_flops_are_the_unsharded_over_tp(runs, name):
    """Each rank of (2, 2) computes its data shard's rows (B/2) on its
    model rank's heads and FFN columns: its FLOPs of the loss and the
    gradients within ``FLOPS_SHARE`` of the unsharded step's on B/2 rows
    over tp = 2 (at least the share itself: replicated compute would
    give 2x). gemma's one KV head is projected on both model ranks."""
    want = _unsharded_flops(runs, name, dh.B // 2) / 2
    for r in _ranks(runs, name):
        assert want <= r["flops"] <= FLOPS_SHARE * want, (r["flops"], want)


@pytest.mark.parametrize("name", list(dh.CASES))
def test_no_layer_leaf_is_gathered_over_model(runs, name):
    """At tp 2 every layer of every case splits its products over
    ``model``: a layer's leaves are gathered over the data axes only (the
    rank's own columns come from the stored shard or ``take``'s
    all-to-all), so the only leaves gathered over ``model`` are those
    outside the layer stacks that the forward reads whole (the
    embedding)."""
    stacks = ("layers", "dense_layers", "moe_layers", "shared_attn",
              "enc_layers", "dec_layers", "mamba")
    for r in _ranks(runs, name):
        assert None not in r["model_gathers"]
        bad = [p for p in r["model_gathers"]
               if p.split("']")[0].strip("['").startswith(stacks)]
        assert not bad, bad
        assert "['embedding']" in r["model_gathers"]


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


def test_dry_run_tally_of_the_serve_step_matches_the_gloo_world(runs):
    """The same for gemma-2b's serve step at B 4 (the embedding looked up
    by vocabulary rows, the heads' exchange and the score sums over
    ``model``, the row-parallel sums, the next token gathered over
    data): one rank of a fake (2, 2) world on meta tensors counts what
    each rank of the gloo world counted in one step."""
    from repro_torch.configs import ShapeSpec
    cfg = dh.decode_config(tconfigs, dh.TALLY_CASE)
    P, G = dh.decode_lengths(dh.TALLY_CASE)
    rec = dryrun.evaluate(cfg, ShapeSpec("case", P + G, 4, "decode"), (2, 2))
    assert rec["status"] == "ok"
    assert rec["collectives_by_axis"]["model"]["all-reduce"]["count"] > 0
    for r in runs["port"]["2x2"]:
        assert r["decode_tally"] == rec["collectives_by_axis"]


DECODE_RUNS = [f"{n}/{b}" for n in dh.DECODE for b in dh.DECODE_BATCHES]


def _ulps_apart(logits):
    """The gap of each row's two largest logits in float32 ulps of the
    largest."""
    top = np.sort(logits, axis=-1)[..., -2:]
    return (top[..., 1] - top[..., 0]) / np.spacing(np.abs(top[..., 1]))


@pytest.mark.parametrize("run", DECODE_RUNS)
def test_mesh_decode_matches_reference(runs, run):
    """Each rank of the (2, 2) world fed the reference's tokens: every
    step's logits (all rows, gathered over data) and every cache leaf
    after the run (gathered) within ``F32`` of the reference's decode on
    its (2, 2) mesh (deepseek at B 1: its unsharded decode); the greedy
    token of each step (the reference's next fed token) equal wherever
    the reference's two largest logits lie more than ``TIE_ULPS`` apart;
    the router's top-k margins at least that wide."""
    ref = runs["ref"]["decode"][run]
    P = dh.decode_lengths(run.split("/")[0])[0]
    far = _ulps_apart(ref["logits"]) > dh.TIE_ULPS
    for r in runs["port"]["2x2"]:
        got = r["decode"][run]
        np.testing.assert_allclose(got["logits"], ref["logits"], **F32)
        want = ref["logits"].argmax(-1)
        assert np.array_equal(got["logits"].argmax(-1)[far], want[far])
        assert np.array_equal(want[:, P - 1:-1], ref["fed"][:, P:])
        assert got["cache"].keys() == ref["cache"].keys()
        for k, w in ref["cache"].items():
            np.testing.assert_allclose(got["cache"][k], w, err_msg=k, **F32)
        assert all(m > dh.TIE_ULPS for m in got["margins"])


@pytest.mark.parametrize("name", dh.DECODE)
def test_mesh_decode_gathers_no_cache_leaf(runs, name):
    """Every mixer computes in the cut its cache has: no collective of the
    decode steps takes a cache leaf but ``take``'s fetch of the conv
    cache's three rows (the channels a rank convolves), at B 4 and B 1."""
    for r in runs["port"]["2x2"]:
        for b in dh.DECODE_BATCHES:
            seen = r["decode"][f"{name}/{b}"]["cache_collectives"]
            bad = [(k, p) for k, p in seen
                   if not (k == "take" and p.endswith("['conv']"))]
            assert not bad, bad
            if dh.decode_config(tconfigs, name).ssm_state:
                assert any(k == "take" for k, _ in seen)


@pytest.mark.parametrize("run", DECODE_RUNS)
def test_one_device_mesh_decode_equals_the_unsharded_decode(runs, run):
    """On the (1, 1) world the mesh decode (``lm.decode_step(mesh=)``) is
    the unsharded one: every step's logits and the final caches bit for
    bit."""
    got, want = (runs["port"]["1x1"][f"decode/{k}"][run]
                 for k in ("mesh", "plain"))
    assert np.array_equal(got["logits"], want["logits"])
    assert got["cache"].keys() == want["cache"].keys()
    for k, w in want["cache"].items():
        assert np.array_equal(got["cache"][k], w), k


def test_int8_weights_on_the_mesh_keep_the_global_scale(runs):
    """gemma-2b's widened copy quantized on each rank of (2, 2)
    (``quantize_params(mesh=)``; wq cut over both groups): each leaf's
    codes, gathered, and its whole scale are the reference's ``quantize``
    of the whole leaf, bit for bit."""
    ref = runs["ref"]["decode"]["gemma_int8/quantized"]
    for r in runs["port"]["2x2"]:
        got = r["quantized"]
        assert len(got) >= 4 and "['layers']['attn']['wq']" in got
        for p, (q, s) in got.items():
            np.testing.assert_array_equal(q, ref[f"{p}[<flat index 0>]"],
                                          err_msg=p)
            np.testing.assert_array_equal(s, ref[f"{p}[<flat index 1>]"],
                                          err_msg=p)


def test_serve_cli_mesh_matches_one_device(runs):
    """``launch/serve.py --arch qwen3-4b --smoke --mesh 2x2 --device cpu``
    prints the lines of ``--mesh 1x1`` and of one device: the same
    sample of greedy tokens."""
    outs = [runs[f"serve {m}"] for m in ("2x2", "1x1", "")]
    samples = [re.findall(r"\[serve\] sample: (\[.*\])", o) for o in outs]
    assert len(samples[0]) == 1 and samples[0] == samples[1] == samples[2]
    for o in outs:
        assert re.search(r"\[serve\] 4 seqs x 32 tokens in ", o), o


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


def _ckpt_tree(runs, cfg, params, state):
    """The nested {"opt", "params", "step"} tree of flat (path -> array)
    parameters and AdamW state of ``cfg``, as one device's tree."""
    from repro_torch.optim import AdamWConfig, opt_state_decls
    decls = lm.model_decls(cfg)
    odecls = opt_state_decls(decls, AdamWConfig(
        state_dtype=cfg.opt_state_dtype))
    return {"opt": tree_from_leaves(odecls, state),
            "params": tree_from_leaves(decls, params), "step": dh.STEPS}


def test_reference_checkpoint_restores_on_the_mesh(runs):
    """The reference's ``save_pytree`` of gemma-2b's state after its two
    train steps (float32 parameters and moments' scales, int8 codes, the
    int32 step), restored on every rank of the (2, 2) world into its
    shards (each leaf in the template's dtype, device and local shape)
    and gathered: every leaf equal to the reference's."""
    ref = runs["ref"][dh.CKPT_CASE]
    want = {f"['params']{k}": v for k, v in ref["params"].items()}
    want.update({f"['opt']{k}": v for k, v in ref["state"].items()})
    for r in _ranks(runs, dh.CKPT_CASE):
        assert r["ref_ckpt_step"] == dh.STEPS
        assert r["ref_ckpt_like_template"]
        got = r["ref_ckpt"]
        assert int(got.pop("['step']")) == dh.STEPS
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_mesh_checkpoint_restores_in_the_reference(runs):
    """The (2, 2) world's own checkpoint of the same case, written by
    rank 0 one gathered leaf at a time, restored by the reference's
    ``restore_pytree`` in this process: every leaf equal to the world's
    gathered state, the int8 moments' codes (the padded full rows) and
    scales (the full rows') included."""
    from repro import checkpoint as ref_ckpt
    cfg = dh.case_config(tconfigs, dh.CKPT_CASE)
    r = _ranks(runs, dh.CKPT_CASE)[0]
    tree = _ckpt_tree(runs, cfg, r["params"], r["state"])
    out = ref_ckpt.restore_pytree(tree, runs["inputs"]["ckpt"]["port"],
                                  dh.STEPS)
    got, want = dict(tree_leaves(out)), dict(tree_leaves(tree))
    assert got.keys() == want.keys()
    assert any(k.endswith("['codes']") for k in want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_train_cli_mesh_restart_replays_bit_for_bit(runs):
    """``launch/train.py --mesh 2x2 --ckpt-dir``: a run stopped after its
    step-2 checkpoint, restarted to step 5, resumes from step 2 and
    replays the uninterrupted run: the step-4 line (loss and grad norm)
    and the step-4 checkpoint, parameters and AdamW state, bit for
    bit."""
    d = runs["dir"]
    assert "resumed from committed step 2" in runs["restarted"]
    assert "resumed" not in runs["whole"] + runs["stopped"]
    whole_lines = dict((s, (l, g)) for s, l, g in _loss_lines(runs["whole"]))
    again = dict((s, (l, g)) for s, l, g in _loss_lines(runs["restarted"]))
    assert sorted(again) == [4] and again[4] == whole_lines[4]
    whole, cut = d / "whole" / "step_00000004", d / "cut" / "step_00000004"
    files = sorted(p.name for p in whole.glob("arr_*.npy"))
    assert files and files == sorted(p.name for p in cut.glob("arr_*.npy"))
    assert (cut / "COMMIT").exists()
    for f in files:
        a, b = np.load(whole / f), np.load(cut / f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_mesh_checkpoint_restores_on_one_device(runs, tmp_path):
    """The mesh run's step-2 checkpoint, alone in a directory, restores
    through ``train`` on one device (the CLI's qwen3-4b smoke config and
    sizes): it resumes at step 3 and holds every saved leaf, parameters
    and AdamW state, in the one-device layout."""
    import shutil
    from repro_torch.launch import train
    src = runs["dir"] / "cut" / "step_00000002"
    shutil.copytree(src, tmp_path / src.name)
    res = train.train(tconfigs.get_smoke("qwen3-4b"), steps=3,
                      ckpt_dir=tmp_path, device="cpu")
    assert res.start == 3 and not res.losses
    leaves = list(tree_leaves({"opt": res.opt, "params": res.params,
                               "step": 0}))
    for i, (p, t) in enumerate(leaves[:-1]):
        saved = np.load(src / f"arr_{i}.npy")
        got = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert got.shape == saved.shape and np.array_equal(got, saved), p
    assert int(np.load(src / f"arr_{len(leaves) - 1}.npy")) == 2


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


def test_no_fallback(tmp_path):
    """More slots than cards raises (the mesh names no CPU); a checkpoint
    whose leaves do not cut into a rank's shards raises with its reason
    (a (3,) leaf over 2 model ranks; a saved leaf of another shape), as
    does a mesh checkpointer without specs."""
    from repro_torch.checkpoint import (Checkpointer, restore_pytree,
                                        save_pytree)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA device"):
        dist.launch(dh.raises_on_rank_one, (1, have + 1),
                    ("data", "model"))
    save_pytree({"w": torch.ones(3)}, tmp_path, 1)
    rank = dist.ProcessMesh(None, AxisEnv(sizes={"data": 1, "model": 2}), 0,
                            {"data": 0, "model": 1}, torch.device("cpu"), {})
    with pytest.raises(ValueError, match="does not divide"):
        restore_pytree({"w": torch.zeros(1)}, tmp_path, 1,
                       specs={"w": ("model",)}, mesh=rank)
    with pytest.raises(ValueError, match="saved shape"):
        restore_pytree({"w": torch.zeros(1)}, tmp_path, 1,
                       specs={"w": (None,)}, mesh=rank)
    with pytest.raises(ValueError, match="mesh and specs"):
        Checkpointer(tmp_path, mesh=rank)


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
