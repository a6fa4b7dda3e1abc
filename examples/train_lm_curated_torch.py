"""End-to-end example: train an LM with submodular data curation, on the
PyTorch/CUDA port.

The twin of ``examples/train_lm_curated.py``: trains a small qwen3-family
model on a synthetic topic-skewed corpus twice — once on raw (redundant)
batches, once with the exemplar-coreset curation pipeline selecting
topic-diverse examples — and compares loss trajectories. On the card the
curation's greedy rounds run the ``gain_eval`` kernel
(``EvalConfig(backend="cuda")``); on the CPU that backend runs its plain
version.

CPU-scale by default (~1M params, 60 steps). ``--full`` requests the
~100M-param / 300-step configuration intended for the card.

Run: PYTHONPATH=src python examples/train_lm_curated_torch.py
         [--steps N] [--full] [--ckpt-dir DIR] [--device cpu]
(without ``--device`` it trains on ``cuda`` and fails with no card)
"""
import argparse

from repro_torch.configs import get_reduced_config, replace
from repro_torch.core import EvalConfig
from repro_torch.data.pipeline import CurationConfig, token_batches
from repro_torch.data.synthetic import TopicTokenStream
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import TrainConfig, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--full", action="store_true",
                    help="~100M params / 300 steps (accelerator scale)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu to train on the CPU (default: cuda)")
    args = ap.parse_args()

    cfg = get_reduced_config("qwen3-0.6b")
    if args.full:
        cfg = replace(cfg, name="qwen3-100m", num_layers=12, d_model=640,
                      num_heads=10, num_kv_heads=5, d_ff=1792, head_dim=64,
                      vocab_size=50304, max_seq_len=1024)
        args.steps = max(args.steps, 300)
    else:
        cfg = replace(cfg, num_layers=4, d_model=128, num_heads=4,
                      num_kv_heads=2, head_dim=32, d_ff=384, vocab_size=2048)
    print(f"model: {cfg.name}  params ≈ {cfg.approx_params()/1e6:.1f}M  "
          f"device: {args.device or 'cuda'}")

    B, S = (8, 256) if args.full else (8, 64)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)

    results = {}
    for label, curation in [
        ("raw", None),
        ("curated", CurationConfig(window=4 * B, select=B)),
    ]:
        stream = TopicTokenStream(cfg.vocab_size, n_topics=12, seed=0)
        batches = token_batches(cfg.vocab_size, B, S, steps=args.steps,
                                seed=0, curation=curation, topic_skew=6.0,
                                stream=stream,
                                eval_cfg=EvalConfig(backend="cuda"),
                                device=args.device)
        tc = TrainConfig(steps=args.steps, log_every=10,
                         ckpt_every=max(args.steps // 2, 1),
                         ckpt_dir=(f"{args.ckpt_dir}/{label}"
                                   if args.ckpt_dir else None))
        _, hist = train(cfg, tc, opt, batches, device=args.device)
        results[label] = hist
        print(f"\n== {label} ==")
        for h in hist:
            print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
                  f"({h['step_time_s']:.2f}s/step)")

    raw_last = results["raw"][-1]["loss"]
    cur_last = results["curated"][-1]["loss"]
    print(f"\nfinal loss — raw: {raw_last:.4f}  curated: {cur_last:.4f}  "
          f"(Δ {raw_last - cur_last:+.4f}; curated batches are "
          f"topic-diverse exemplar coresets)")


if __name__ == "__main__":
    main()
