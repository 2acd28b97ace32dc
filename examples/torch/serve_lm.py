"""Batched serving on the PyTorch / CUDA port: continuous-batching greedy
decode.

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]

Twin of ``examples/serve_lm.py``: runs the port's serving driver
(``repro_torch.launch.serve``) on a reduced dense GQA config and on a
reduced musicgen config (multi-codebook decode: each step's token is a
list of codebook tokens).
"""
import argparse

from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    outs = {}
    for arch in ("qwen3-1.7b", "musicgen-medium"):
        print(f"\n=== serving {arch} (reduced config) ===")
        out = serve(["--arch", arch, "--smoke", "--slots", "4",
                     "--requests", "6", "--prompt-len", "8",
                     "--max-new", "16", "--max-seq", "64"], device=dev)
        assert out["tokens"] > 0
        lens = {k: len(v) for k, v in out["outputs"].items()}
        print(f"    per-request generated tokens: {lens}")
        outs[arch] = out
    return outs


if __name__ == "__main__":
    main()
