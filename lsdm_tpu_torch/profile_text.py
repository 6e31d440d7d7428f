"""Where the time of the text towers goes, on a CUDA device.

    python -m lsdm_tpu_torch.profile_text [--batch 1 8 32] [--reps 20]

Builds the full-width CLIP text tower (vocab 49408, context 77, width 512,
12 layers) and BERT-base with seeded weights (``init_clip_weights``,
``init_bert_weights``), float32 with TF32 off, and for each batch size
times one forward on seeded token rows with CUDA events (mean of
``--reps`` after a warm-up): CLIP on (B, 77) rows of 12 tokens, BERT on
(B, 32) rows of 12 tokens and their attention mask, as ``TextEncoder``
gives them for short prompts.  For the largest batch it then traces one
forward of each tower with ``torch.profiler`` and prints the device time
by kernel, the busy share (summed kernel time over the traced wall) and
the rate of the matrix products: the float32 operations of the tower's
products (``tower_flops``) over the time of the GEMM kernels.  The last
line is one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lsdm_tpu_torch.models.bert import BertModel, init_bert_weights
from lsdm_tpu_torch.models.text import CLIPTextTransformer, init_clip_weights
from lsdm_tpu_torch.profile_sampling import _kernel_times

PROMPT_TOKENS = 12


def token_rows(tower: str, batch: int, seed: int, dev):
    """The forward's arguments for ``batch`` prompts of PROMPT_TOKENS
    tokens: CLIP's [SOT] body [EOT] rows zero-padded to 77; BERT's
    [CLS] body [SEP] rows padded to 32, with their mask."""
    rng = np.random.RandomState(seed)
    if tower == "CLIP":
        ids = np.zeros((batch, 77), np.int64)
        ids[:, 0], ids[:, PROMPT_TOKENS + 1] = 49406, 49407
        ids[:, 1:PROMPT_TOKENS + 1] = rng.randint(1, 49406, (batch, PROMPT_TOKENS))
        return (torch.from_numpy(ids).to(dev),)
    ids = np.zeros((batch, 32), np.int64)
    ids[:, 0], ids[:, PROMPT_TOKENS + 1] = 101, 102
    ids[:, 1:PROMPT_TOKENS + 1] = rng.randint(1000, 30522, (batch, PROMPT_TOKENS))
    return torch.from_numpy(ids).to(dev), torch.from_numpy((ids > 0).astype(np.int64)).to(dev)


def tower_flops(model, args) -> int:
    """Float32 operations of one forward's matrix products, from the
    shapes: 2 per multiply-add of every linear layer on every token (the
    projection and the pooler on one token a row), and the attention's
    two products over every (query, key) pair of every head."""
    B, L = args[0].shape
    if isinstance(model, CLIPTextTransformer):
        width = model.positional_embedding.shape[1]
        per_token = sum(m.weight.numel() for m in model.modules()
                        if isinstance(m, torch.nn.Linear))
        per_token += sum(b.attn.in_proj_weight.numel() for b in model.transformer.resblocks)
        layers, once = len(model.transformer.resblocks), model.text_projection.numel()
    else:
        width = model.cfg.hidden_size
        pooler = model.pooler.dense.weight.numel()
        per_token = sum(m.weight.numel() for m in model.modules()
                        if isinstance(m, torch.nn.Linear)) - pooler
        layers, once = model.cfg.num_hidden_layers, pooler
    attention = 2 * L * L * width  # q k^T and p v over the heads' widths
    return 2 * (B * L * per_token + B * once + layers * B * attention)


def forward_ms(model, args, reps: int, dev) -> float:
    model(*args)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        model(*args)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def profile(batches, reps: int, seed: int) -> dict:
    dev = torch.device("cuda", 0)
    towers = {"CLIP": init_clip_weights(CLIPTextTransformer(), seed),
              "BERT": init_bert_weights(BertModel(), seed)}
    result = {"card": torch.cuda.get_device_name(0), "towers": {}}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for tower, model in towers.items():
        model = model.to(dev).eval()
        rec = result["towers"][tower] = {"ms": {}}
        for b in batches:
            rec["ms"][b] = forward_ms(model, token_rows(tower, b, seed, dev), reps, dev)
            print(f"{tower} batch {b}: {rec['ms'][b]:.3f} ms a forward "
                  f"({rec['ms'][b] / b:.4f} ms a prompt)")
        args = token_rows(tower, batches[-1], seed, dev)
        torch.cuda.synchronize(dev)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            model(*args)
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = sorted(_kernel_times(prof).items(), key=lambda kv: -kv[1][0])
        busy = sum(ms for ms, _ in dict(kernels).values())
        gemm = sum(ms for n, (ms, _) in kernels if "gemm" in n.lower())
        flops = tower_flops(model, args)
        print(f"{tower} traced batch {batches[-1]}: wall {wall_ms:.3f} ms, summed "
              f"kernel time {busy:.3f} ms, busy share {busy / wall_ms:.3f}, "
              f"{sum(c for _, c in dict(kernels).values())} kernel launches; GEMM "
              f"kernels {gemm:.3f} ms for {flops / 1e9:.1f} GFLOP of products, "
              f"{flops / gemm / 1e9:.1f} TFLOP/s")
        for name, (ms, calls) in kernels[:10]:
            print(f"  {ms:9.3f} ms {100 * ms / max(busy, 1e-9):5.1f}%  "
                  f"{calls:5d} calls  {name[:90]}")
        rec["trace"] = {"batch": batches[-1], "wall_ms": wall_ms, "kernel_ms": busy,
                        "busy_share": busy / wall_ms, "gemm_ms": gemm, "flops": flops,
                        "kernels": {n: {"ms": ms, "calls": c} for n, (ms, c) in kernels}}
        del model
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_text: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        result = profile(sorted(args.batch), args.reps, args.seed)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
