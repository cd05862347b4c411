"""Time kernel K6 (the embedding tables' gradients) at the flagship step's
shapes, B=128: 1,024 sequences of 32 tokens, bfloat16 ``dy`` from a seed.
Run from the root of a checkout; the kernels are built from that checkout,
so two trees can be compared in turns within one call on the card:

    (cd <tree> && python3 <this repo>/scripts/time_embedding_backward.py)

Prints one JSON line: the checkout, five means of 20 launches each (after 3
warm-up launches), and the sums of the position and command gradients.
"""
import json
import os
import sys

import numpy as np
import torch


def main() -> int:
    sys.path.insert(0, os.getcwd())
    from deepsvg_tpu_torch.data import generate_batch
    from deepsvg_tpu_torch.ops import embedding as emb_ops

    if not torch.cuda.is_available():
        print("time_embedding_backward: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    tb = generate_batch(np.random.default_rng(0), 128, 8, 30)
    c = torch.from_numpy(tb["commands"]).to(dev).reshape(1024, 32)
    a = torch.from_numpy(tb["args"]).to(dev).reshape(1024, 32, -1)
    gen = torch.Generator(device=dev).manual_seed(1)
    dy = torch.randn(1024, 32, 256, device=dev, generator=gen).to(torch.bfloat16)

    def fn():
        return emb_ops.embedding_backward(c, a, None, dy, 7, 257, 0, False)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(20):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / 20)
    out = fn()
    print(json.dumps({"tree": os.getcwd(), "k6_ms": times,
                      "dpos_sum": float(out[3].double().sum()),
                      "dcmd_sum": float(out[0].double().sum())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
