"""End-to-end training on the PyTorch / CUDA port: the reference example's
qwen3-family model (80M params) for a few hundred steps, with
checkpointing and an injected failure + automatic restart; or, with
``--arch``, any other family's smoke config (moe, vlm, audio, hybrid,
ssm) on the same loop.

    PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] \
        [--arch zamba2-7b] [--device cpu]

Twin of ``examples/train_lm.py``: drives the port's launcher
(``repro_torch.launch.train``), the same code path its command line
runs, and takes ``--arch`` as that launcher does.
"""
import argparse
import dataclasses
import shutil
import tempfile

import repro_torch.configs as C
import repro_torch.configs.qwen3_1_7b as Q
from repro_torch.launch.train import train
from repro_torch.models.config import ModelConfig


def make_100m() -> ModelConfig:
    # 80M params: 12 layers x d512 (8H/4KV) x ff2048, 32k vocab
    return dataclasses.replace(
        Q.CONFIG, name="qwen3-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv=4, d_ff=2048, vocab=32_000,
        attn_chunk_q=256, attn_chunk_k=256, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b",
                    help="qwen3-1.7b: the 80M example model; another arch: "
                         "its smoke config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    example = args.arch == "qwen3-1.7b"
    cfg = make_100m() if example else C.get_smoke(args.arch)
    # the 80M model trains at the reference example's rate; a smoke
    # config is a few thousand params and needs a larger one to move its
    # loss within a short run
    lr = 3e-4 if example else 1e-2
    print(f"[example] {cfg.name}: {cfg.n_params() / 1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens")

    # the launcher takes any arch id: point the smoke lookup of qwen3 at
    # the 100M config so that the example drives the public entry point
    orig = C.get_smoke
    C.get_smoke = lambda a: cfg if a == "qwen3-1.7b" else orig(a)
    ckpt = tempfile.mkdtemp(prefix="repro_torch_example_")
    try:
        result = train([
            "--arch", args.arch, "--smoke",
            "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--lr", str(lr), "--ckpt-dir", ckpt,
            "--ckpt-every", str(max(args.steps // 3, 1)),
            "--fail-at", str(args.steps // 2),   # mid-run failure
        ], device=args.device)
    finally:
        C.get_smoke = orig
        shutil.rmtree(ckpt, ignore_errors=True)

    hist = result["history"]
    print(f"[example] loss {hist[0][1]:.3f} -> {hist[-1][1]:.3f} "
          f"({result['restarts']} restart)")
    assert hist[-1][1] < hist[0][1], "loss should decrease"
    print("[example] done.")
    return result


if __name__ == "__main__":
    main()
