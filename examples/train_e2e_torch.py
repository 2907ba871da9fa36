"""End-to-end LM training on the PyTorch port, with checkpoint/restart.

The port of ``examples/train_e2e.py``: trains a small gemma-family model on
the synthetic token pipeline with the port's train step (AdamW, cosine
schedule), saving async checkpoints, then simulates a crash at
``steps // 2`` and restarts from the newest committed checkpoint. The
restart replays the steps between that checkpoint and the crash; their
losses must equal the first run's bit for bit (printed as ``restart replay
exact``), and the loss must fall.

Defaults are CPU-sized (``--preset small``, 4.3M params, 60 steps);
``--preset 100m --steps 300`` is the full configuration for a card. Without
``--device`` it runs on the card (and raises when there is none).

Run:  PYTHONPATH=src python examples/train_e2e_torch.py \\
          [--preset small|100m] [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.models import model_decls, param_count


PRESETS = {
    # (layers, d_model, heads, kv, head_dim, d_ff, vocab, batch, seq)
    "small": (4, 256, 4, 1, 64, 1024, 2048, 8, 128),
    "100m": (8, 768, 12, 4, 64, 3072, 32768, 32, 512),
}


def build(preset: str):
    L, d, h, kv, hd, ff, vocab, batch, seq = PRESETS[preset]
    cfg = get_config("gemma-2b").replace(
        n_layers=L, d_model=d, n_heads=h, n_kv_heads=kv, head_dim=hd,
        d_ff=ff, vocab_size=vocab, fsdp=False, grad_accum=1,
        loss_chunk=min(seq, 512), attn_block_k=128)
    return cfg, batch, seq


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is no card)")
    args = ap.parse_args(argv)

    cfg, batch, seq = build(args.preset)
    print(f"[cfg] {cfg.name}-{args.preset}: "
          f"{param_count(model_decls(cfg)) / 1e6:.1f}M params, "
          f"batch={batch} seq={seq}")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="dype_e2e_")
    kw = dict(batch=batch, seq=seq, ckpt_dir=ckpt_dir,
              ckpt_every=args.ckpt_every, device=args.device)

    crash_at = args.steps // 2
    first = train(cfg, steps=crash_at, **kw)

    # ---- simulated crash + restart ---------------------------------------
    print(f"[crash] simulated failure at step {crash_at}; restarting...")
    replay = train(cfg, steps=args.steps, **kw)
    if replay.start == 0:
        raise SystemExit("no committed checkpoint found")
    print(f"[restart] resumed at step {replay.start}")

    # loss continuity: every replayed step of the first run, bit for bit
    overlap = [s for s in replay.losses if s in first.losses]
    for s in overlap:
        if replay.losses[s] != first.losses[s]:
            raise SystemExit(f"restart replay differs at step {s}: "
                             f"{replay.losses[s]!r} != {first.losses[s]!r}")
    start, last = first.losses[0], replay.losses[args.steps - 1]
    print(f"[done] loss {start:.4f} -> {last:.4f} "
          f"(restart replay exact on {len(overlap)} overlap steps)")
    if not last < start:
        raise SystemExit("loss did not decrease")


if __name__ == "__main__":
    main()
