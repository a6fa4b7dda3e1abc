"""Batched serving demo on the PyTorch port: prefill a prompt batch, then
decode greedily.

The twin of ``examples/serve_lm.py``: the same flags, plus ``--device``
(``cuda`` unless named; there is no fallback to the CPU). A reduced model
of the chosen architecture, drawn from a seeded generator, is served
through the port's prefill and serve steps; the generated tokens stay on
the device until the loop ends.

Run: PYTHONPATH=src python examples/serve_lm_torch.py [--arch hymba-1.5b]
     [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.models.model import init_model
from repro_torch.train.step import make_prefill_step, make_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args()

    cfg = get_reduced_config(args.arch)
    model = init_model(cfg, 0, device=args.device)
    dev = model.embed["w"].device
    B, P, N = args.batch, args.prompt_len, args.new_tokens
    cache_len = P + N + (cfg.frontend_len if cfg.family == "vlm" else 0)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    if cfg.family in ("encdec", "vlm"):
        gen.manual_seed(2)
        batch["frontend"] = torch.randn(
            (B, cfg.frontend_len, cfg.d_model), generator=gen, device=dev,
            dtype=torch.float32)

    prefill = make_prefill_step(cfg, cache_len=cache_len)
    decode = make_serve_step(cfg)

    t0 = time.perf_counter()
    next_tok, caches = prefill(model, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [next_tok]
    offset = P + (cfg.frontend_len if cfg.family == "vlm" else 0)
    t0 = time.perf_counter()
    for i in range(N - 1):
        next_tok, caches = decode(
            model, {"tokens": next_tok, "caches": caches, "pos": offset + i})
        out.append(next_tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen_toks = torch.cat(out, dim=1).cpu()
    prompts = prompts.cpu()
    print(f"arch={args.arch} batch={B} prompt={P} new={N} device={dev}")
    print(f"prefill: {t_prefill*1e3:.1f} ms   decode: "
          f"{t_decode/max(N-1,1)*1e3:.1f} ms/token")
    for b in range(min(B, 2)):
        print(f"  seq{b}: {prompts[b, -6:].tolist()} => "
              f"{gen_toks[b, :10].tolist()}...")


if __name__ == "__main__":
    main()
