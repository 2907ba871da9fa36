"""The port's sharding specs against the reference's, leaf for leaf: every
arch of ``configs.ARCHS`` at full size, the parameter tree and the AdamW
state tree (float32 and int8 moments), at the axis layouts of the
production mesh (16, 16), the multi-pod mesh (2, 16, 16), the four-card
mesh (2, 2) and one device (1, 1). Both sides build their ``AxisEnv`` from
the same sizes; no device is touched. Also ``dist.shard``/``unshard``
round trips and the per-card bytes that the specs give."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_threads import one_torch_thread  # noqa: F401

import repro.configs as rconfigs
import repro.models.common as rcommon
from repro.models import model_decls as ref_model_decls
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import opt_state_decls as ref_opt_state_decls
from repro_torch import configs as tconfigs
from repro_torch.launch import dist
from repro_torch.models import model_decls
from repro_torch.models.common import (CPU_AXES, AxisEnv, ParamDecl,
                                       param_specs, tree_leaves)
from repro_torch.optim import AdamWConfig, opt_state_decls

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LAYOUTS = {
    "16x16": (("data",), {"data": 16, "model": 16}),
    "2x16x16": (("pod", "data"), {"pod": 2, "data": 16, "model": 16}),
    "2x2": (("data",), {"data": 2, "model": 2}),
    "1x1": (("data",), {"data": 1, "model": 1}),
}


def _ref_specs(decls):
    is_decl = lambda x: isinstance(x, rcommon.ParamDecl)      # noqa: E731
    flat, _ = jax.tree_util.tree_flatten_with_path(decls, is_leaf=is_decl)
    return {jax.tree_util.keystr(kp): (tuple(d.shape), tuple(d.spec))
            for kp, d in flat}


def _port_specs(decls):
    return {k: (tuple(d.shape), tuple(d.spec))
            for k, d in tree_leaves(decls)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_and_opt_state_specs_match_reference(arch, layout):
    data, sizes = LAYOUTS[layout]
    rax = rcommon.AxisEnv(data=data, model="model", sizes=sizes)
    ax = AxisEnv(data=data, model="model", sizes=sizes)
    rcfg, cfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    rdecls, decls = ref_model_decls(rcfg, rax), model_decls(cfg, ax)
    want, got = _ref_specs(rdecls), _port_specs(decls)
    assert got == want
    for state in ("float32", "int8"):
        assert _port_specs(opt_state_decls(
            decls, AdamWConfig(state_dtype=state))) == _ref_specs(
            ref_opt_state_decls(rdecls, RefAdamWConfig(state_dtype=state)))


def test_default_axes_are_one_device():
    """Every decls function defaults to ``CPU_AXES``: the current callers'
    trees, whose specs name axes of size 1 only."""
    cfg = tconfigs.get_config("qwen3-8b")
    assert _port_specs(model_decls(cfg)) == _port_specs(
        model_decls(cfg, CPU_AXES))
    assert CPU_AXES == AxisEnv(sizes={"data": 1, "model": 1})
    assert dist.local_shape((8, 6), ("data", "model"), CPU_AXES) == (8, 6)


def test_axis_env_for_mesh_matches_reference():
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import axis_env_for_mesh
    cpu = torch.device("cpu")
    for shape, axes in (((2, 2), ("data", "model")),
                        ((2, 1, 2), ("pod", "data", "model"))):
        ax = axis_env_for_mesh(make_mesh(shape, axes,
                                         devices=[cpu] * int(np.prod(shape))))
        assert ax.data == axes[:-1] and ax.model == "model"
        assert ax.sizes == dict(zip(axes, shape))
        assert ax.dp == (axes[0] if len(axes) == 2 else axes[:-1])


SHARD_CASES = [
    ((8, 6), ("data", "model"), {"data": 2, "model": 2}, ("data",)),
    ((3, 8, 6), (None, "model", "data"), {"data": 2, "model": 2},
     ("data",)),
    ((4, 16), (None, ("pod", "data")), {"pod": 2, "data": 2, "model": 2},
     ("pod", "data")),
    ((5,), (), {"data": 2, "model": 2}, ("data",)),
]


@pytest.mark.parametrize("shape,spec,sizes,data", SHARD_CASES,
                         ids=["2d", "stacked", "pod", "replicated"])
def test_shard_and_unshard_round_trip(shape, spec, sizes, data):
    """Every rank's ``shard`` of a full tensor, put together by
    ``unshard``, is the tensor; each shard has ``local_shape``."""
    ax = AxisEnv(data=data, model="model", sizes=sizes)
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    names = (*data, "model")
    grid = [sizes[n] for n in names]
    coords = [dict(zip(names, c)) for c in np.ndindex(*grid)]
    shards = [dist.shard(full, spec, ax, c) for c in coords]
    for s in shards:
        assert tuple(s.shape) == dist.local_shape(shape, spec, ax)
    assert torch.equal(dist.unshard(shards, coords, spec, ax), full)


def test_local_shape_raises_on_an_uneven_split():
    ax = AxisEnv(sizes={"data": 2, "model": 4})
    with pytest.raises(ValueError, match="divide"):
        dist.local_shape((6, 8), ("model", None), ax)


def test_per_card_bytes_from_specs():
    """qwen3-8b at (2, 2) with fsdp: every large leaf is cut four ways, so
    a card holds a quarter of the bf16 parameters and of the float32
    moments, plus the replicated norms."""
    cfg = tconfigs.get_config("qwen3-8b")
    ax = AxisEnv(sizes={"data": 2, "model": 2})
    decls = model_decls(cfg, ax)
    per = dist.per_card_bytes(decls, ax, cfg.pdtype)
    total = sum(np.prod(d.shape) * 2 for _, d in tree_leaves(decls))
    repl = sum(np.prod(d.shape) * 2 for _, d in tree_leaves(decls)
               if not any(d.spec))
    assert per == (total - repl) // 4 + repl
    ocfg = AdamWConfig()
    st = dist.per_card_bytes(opt_state_decls(decls, ocfg), ax,
                             torch.float32)
    assert st == 4 * per + 4          # the moments, and the int32 step
    assert isinstance(decls["final_norm"], ParamDecl)
    assert param_specs(decls)["final_norm"] == ()
