"""The seed makes the inputs; the frozen counts reproduce the bounds the
SSD kernels were held to; the weight layout is the program's."""
import numpy as np
import pytest
import torch

import counts
import harness
import weights
from conftest import configs


def test_same_seed_same_batches_other_seed_other():
    a = weights.token_pool(2 ** 40 + 7, 3, 2, 64, 50280, "cpu")
    b = weights.token_pool(2 ** 40 + 7, 3, 2, 64, 50280, "cpu")
    c = weights.token_pool(2 ** 40 + 8, 3, 2, 64, 50280, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert len({tuple(x.flatten().tolist()) for x in a}) == 3


def test_same_seed_same_weights():
    cfg = harness.load_cell("mamba2-780m.prefill-20x32k").as_run
    small = dict(cfg, n_layers=2, d_model=64, vocab_size=300,
                 ssm_state=16, ssm_head_dim=16)
    a = weights.make(small, 5, "cpu")
    b = weights.make(small, 5, "cpu")
    c = weights.make(small, 6, "cpu")
    la, lb, lc = (dict(weights.leaves(t)) for t in (a, b, c))
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert not torch.equal(la["layers/mix/in_proj"], lc["layers/mix/in_proj"])
    assert la["layers/mix/in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("config", configs(), ids=lambda c: c["name"])
def test_layout_is_the_programs(config):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import model_decls
    from repro_torch.models.common import tree_leaves
    want = {p.strip("[]'").replace("']['", "/"): tuple(d.shape)
            for p, d in tree_leaves(model_decls(get_config(config["name"])))}
    got = {p: tuple(s) for p, (s, _) in
           weights.leaves(weights.layout(config["as_run"]))}
    assert got == want


def test_counts_reproduce_the_ssd_bounds():
    ms = lambda w: counts.least_s(*w) * 1e3               # noqa: E731
    assert ms(counts.ssd_fwd(4, 32768, 48, 64, 128, 256)) == \
        pytest.approx(0.506, abs=5e-4)
    assert ms(counts.ssd_fwd(2, 8192, 112, 64, 64, 256)) == \
        pytest.approx(0.1437, abs=5e-5)
    assert ms(counts.ssd_bwd(16, 4096, 48, 64, 128, 256)) == \
        pytest.approx(0.523, abs=5e-4)


def test_model_flops_count_the_products():
    cfg = harness.load_cell("mamba2-780m.prefill-20x32k").as_run
    n = sum(int(np.prod(s)) for _, (s, _) in
            weights.leaves(weights.layout(cfg)))
    # a forward is ~2 FLOPs a weight a token, plus the scan
    per_tok = counts.forward_flops(cfg, 1, 4096, 4096) / 4096
    emb = cfg["d_model"] * weights.padded_vocab(cfg)
    assert 2 * n < per_tok < 2 * n + 2 * emb
    mix = {"kind": "train", "batch": 2, "seq_len": 4096}
    assert counts.step_flops(cfg, mix) == \
        pytest.approx(3 * 2 * per_tok * 4096)
