"""AdamW with selectable state precision.

State dtypes:
  float32  — standard.
  bfloat16 — halves optimizer memory.
  int8     — blockwise-quantized moments (256-element blocks along the last
             axis, float32 absmax scales), ~4x optimizer-memory saving; the
             update math then runs in bfloat16.

Quantized codes keep every leading axis of the parameter (only the last axis
is padded to the block size), so a state leaf can be cut along its leading
axis with its parameter. On a mesh whose group cuts a leaf's last axis the
blocks stay the reference's global ones: a rank holds its slice of the
padded full row's codes and the full row's scales (``opt_state_decls``'
specs), and the update gathers the row over that group to read and to
requantize it (``_Row``).

The arithmetic is the JAX package's (``optim/adamw.py``) op by op: each op
rounds to its dtype, and Python constants meet a bfloat16 operand as
bfloat16 (JAX's weak types) — so the int8 codes and scales come out equal to
the reference's evaluated op by op. Unlike the reference, the update is in
place: parameters and moments are overwritten a piece at a time (one layer
of a stacked leaf, or at most ``PIECE`` elements of another leaf), so that
the float32 temporaries stay small beside the state (one float32 copy of
qwen3-4b's stacked FFN leaf is 3.6 GB). The update is elementwise, so the
pieces give the same bits as the whole.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..models.common import ParamDecl, tree_leaves, tree_map
from ..tally import span

BLOCK = 256
PIECE = 1 << 26            # elements of a 2-D leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # float32 | bfloat16 | int8


# ---------------------------------------------------------------------------
# int8 blockwise quantization (blocks along the last axis)
# ---------------------------------------------------------------------------
def _pad_last(n: int) -> int:
    return ((n + BLOCK - 1) // BLOCK) * BLOCK


def quantize_blockwise(x, *, round_up: bool = False):
    """(..., n) -> codes (..., n_pad) int8, scales (..., n_pad/BLOCK) fp32.

    ``round_up`` quantizes magnitudes with ceil instead of nearest — used
    for the second moment: nearest-rounding a small nu entry to code 0
    makes Adam's denominator collapse to eps and the update explode; ceil
    keeps every nonzero denominator >= one scale unit. Nearest rounds half
    to even, as ``jnp.round`` does."""
    *lead, n = x.shape
    xf = F.pad(x.float(), (0, _pad_last(n) - n))
    blocks = xf.reshape(*lead, -1, BLOCK)
    scale = blocks.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    q = blocks / scale[..., None]
    q = torch.sign(q) * torch.ceil(q.abs()) if round_up else torch.round(q)
    codes = q.clamp(-127, 127).to(torch.int8)
    return codes.reshape(*lead, -1), scale


def dequantize_blockwise(codes, scale, shape):
    *lead, n = shape
    blocks = codes.reshape(*lead, -1, BLOCK).float() * scale[..., None]
    return blocks.reshape(*lead, -1)[..., :n]


# ---------------------------------------------------------------------------
# State declaration / init
# ---------------------------------------------------------------------------
def _state_dtype(cfg: AdamWConfig):
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def _moment_decl(decl: ParamDecl, cfg: AdamWConfig):
    if cfg.state_dtype == "int8":
        *lead, n = decl.shape
        npad = _pad_last(n)
        spec = tuple(decl.spec)
        spec += (None,) * (len(decl.shape) - len(spec))
        # codes keep the param's full spec: the padded last dim is a multiple
        # of BLOCK=256, hence divisible by any power-of-two mesh axis.
        return {"codes": ParamDecl(tuple(lead) + (npad,), spec,
                                   init="zeros", dtype=torch.int8),
                "scale": ParamDecl(tuple(lead) + (npad // BLOCK,),
                                   (*spec[:-1], None), init="zeros",
                                   dtype=torch.float32)}
    return ParamDecl(decl.shape, decl.spec, init="zeros",
                     dtype=_state_dtype(cfg))


def opt_state_decls(param_decls, cfg: AdamWConfig):
    mk = lambda d: _moment_decl(d, cfg)                      # noqa: E731
    return {"mu": tree_map(mk, param_decls), "nu": tree_map(mk, param_decls),
            "step": ParamDecl((), init="zeros", dtype=torch.int32)}


def adamw_init(params, cfg: AdamWConfig, *, specs=None, mesh=None):
    """Zero moments beside ``params`` (on their devices), step 0. On a
    mesh (``launch/dist.ProcessMesh``, ``specs`` the leaves' specs) the
    leaves are this rank's shards and each int8 moment has the local shape
    of ``opt_state_decls``' leaf."""
    def mk(x, spec=None):
        if cfg.state_dtype == "int8":
            *lead, n = x.shape
            k = _Row.of(x, spec, mesh).k
            npad = _pad_last(n * k)
            return {"codes": torch.zeros(tuple(lead) + (npad // k,),
                                         dtype=torch.int8, device=x.device),
                    "scale": torch.zeros(tuple(lead) + (npad // BLOCK,),
                                         dtype=torch.float32,
                                         device=x.device)}
        return torch.zeros(x.shape, dtype=_state_dtype(cfg), device=x.device)
    dev = next(t for _, t in tree_leaves(params)).device
    trees = (params,) if specs is None else (params, specs)
    return {"mu": tree_map(mk, *trees), "nu": tree_map(mk, *trees),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


class _Row:
    """How an int8 moment's rows lie on a mesh: ``k`` ranks of a group
    cut a leaf's last dim (``k`` 1 off a mesh or when no group cuts it).
    The codes of rank ``j`` are its slice of the padded full row's, the
    scales the full row's, so ``whole`` gathers a row piece over the group
    and ``own`` takes the rank's slice of a full one."""

    def __init__(self, mesh=None, key=None):
        self.mesh, self.key = mesh, key
        self.k = 1 if key is None else mesh.size(key)
        self.j = 0 if key is None else mesh.axis_index(key)

    @classmethod
    def of(cls, x, spec, mesh):
        last = (None if mesh is None or len(spec or ()) < x.dim()
                else spec[x.dim() - 1])
        return cls(mesh, None if last is None else mesh.key(last))

    def whole(self, x):
        return x if self.k == 1 else self.mesh.all_gather(
            x, self.key, x.dim() - 1)

    def own(self, x, width: int):
        return x if self.k == 1 else x.narrow(-1, self.j * width, width)


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------
def _pieces(x):
    """Slices of the leading axis that the update takes at once: one layer
    of a stacked leaf (3-D and up), at most ``PIECE`` elements of a 2-D
    one, the whole of a smaller one."""
    if x.dim() < 2:
        return [slice(None)]
    rows = 1 if x.dim() >= 3 else max(1, PIECE // max(1, x[0].numel()))
    return [slice(r, r + rows) for r in range(0, x.shape[0], rows)]


def global_norm(tree, specs=None, mesh=None):
    """sqrt of the sum of squares: each square in the leaf's dtype, the sums
    in float32 (a piece at a time, so no float32 copy of a leaf is made).

    On a mesh (``launch/dist.ProcessMesh``, ``specs`` the leaves' specs)
    ``tree`` holds this rank's shards: each piece's sum is summed over
    the groups that cut its leaf (one all-reduce for all the pieces of a
    kind), a replicated leaf counts once, and the pieces are then added in
    the unsharded order, so every rank gets the whole tree's norm (on one
    rank, bit for bit the unsharded one)."""
    pieces = []
    spec_of = dict(tree_leaves(specs)) if mesh is not None else {}
    for path, x in tree_leaves(tree):
        axes = mesh.spec_axes(spec_of[path]) if mesh is not None else ()
        for sl in _pieces(x):
            pieces.append((axes, x[sl].square().sum(dtype=torch.float32)))
    vals = [v for _, v in pieces]
    for axes in sorted({a for a, _ in pieces if a}):
        at = [i for i, (a, _) in enumerate(pieces) if a == axes]
        v = torch.stack([vals[i] for i in at])
        with torch.no_grad():
            for axis in axes:
                v = mesh.psum(v, axis)
        for j, i in enumerate(at):
            vals[i] = v[j]
    total = 0
    for v in vals:
        total = total + v
    return torch.sqrt(total)


def _math_dtype(cfg):
    # int8-state models also do the update math in bf16: a single f32 copy of
    # a 671B model's per-device shard is 10.5 GB — it would not fit.
    return torch.bfloat16 if cfg.state_dtype == "int8" else torch.float32


def _load(state, shape, cfg, row: _Row):
    if cfg.state_dtype == "int8":
        *lead, n = shape
        full = dequantize_blockwise(row.whole(state["codes"]), state["scale"],
                                    (*lead, n * row.k))
        return row.own(full, n).to(_math_dtype(cfg))
    return state.float()


def _store(dst, val, cfg, row: _Row, *, round_up: bool = False):
    """Write a moment piece into its (sliced) state in place."""
    if cfg.state_dtype == "int8":
        codes, scale = quantize_blockwise(row.whole(val), round_up=round_up)
        dst["codes"].copy_(row.own(codes, dst["codes"].shape[-1]))
        dst["scale"].copy_(scale)
    else:
        dst.copy_(val)


def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0, *,
                 specs=None, mesh=None):
    """One AdamW step, in place: overwrites the leaves of ``params`` and of
    ``state``'s moments, and replaces ``state["step"]``. Returns (params,
    state, grad_norm). On a mesh the leaves are this rank's shards, the
    clip reads the whole tree's norm (``global_norm``) and int8 moments
    keep the global blocks (``_Row``)."""
    step = state["step"] + 1
    dev = step.device
    with span("rt.adamw.norm"):
        gn = global_norm(grads, specs, mesh)
        clip = torch.clamp(torch.div(torch.tensor(cfg.grad_clip, device=dev),
                                     gn.clamp_min(1e-12)), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(torch.tensor(b1, device=dev), step.float())
    c2 = 1.0 - torch.pow(torch.tensor(b2, device=dev), step.float())
    lr = cfg.lr * lr_scale
    mdt = _math_dtype(cfg)

    def const(v):
        # a Python constant meets the math dtype as that dtype (JAX's weak
        # typing); PyTorch would keep a float32 opmath scalar otherwise
        return torch.tensor(v, dtype=mdt, device=dev)

    def upd(p, g, mu_s, nu_s, row):
        g = g.to(mdt) * clip.to(mdt)
        mu = (const(b1) * _load(mu_s, p.shape, cfg, row)
              + const(1 - b1) * g).to(mdt)
        nu = (const(b2) * _load(nu_s, p.shape, cfg, row)
              + const(1 - b2) * g.square()).to(mdt)
        delta = ((mu.float() / c1) / (torch.sqrt(nu.float() / c2) + cfg.eps)
                 + cfg.weight_decay * p.float()).to(mdt)
        p.copy_((p.to(mdt) - (lr * delta.float()).to(mdt)).to(p.dtype))
        _store(mu_s, mu, cfg, row)
        _store(nu_s, nu, cfg, row, round_up=True)

    def piece(s, sl):
        return {k: v[sl] for k, v in s.items()} if isinstance(s, dict) \
            else s[sl]

    def one(p, g, spec, mu_s, nu_s):
        row = _Row.of(p, spec, mesh)
        for sl in _pieces(p):
            upd(p[sl], g[sl], piece(mu_s, sl), piece(nu_s, sl), row)

    if specs is None:
        specs = tree_map(lambda _: None, params)
    _zip_leaves(one, params, grads, specs, state["mu"], state["nu"])
    state["step"] = step
    return params, state, gn


def _zip_leaves(fn, params, *trees):
    """fn(param, *the same leaf of each tree) over the parameter tree; a
    tree's leaf may be a {"codes", "scale"} dict (int8 moments)."""
    if isinstance(params, dict):
        for k, v in params.items():
            _zip_leaves(fn, v, *(t[k] for t in trees))
    else:
        fn(params, *trees)
