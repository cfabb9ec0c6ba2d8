"""Where RWKV-6 1.6B serving spends its time on the card.

    PYTHONPATH=src python -m repro_torch.profile_rwkv6 [--batch 4]
        [--prompt-len 512] [--repeats 5] [--traced 2] [--out profile.json]

The served model (full width and depth, bfloat16 compute, float32
weights from a seed, made on the host with numpy) through
``launch.serve``'s prefill and greedy decode steps, eager and captured as
CUDA graphs (``launch.serve.captured_steps``, the decode step's cache
donated): each timed by CUDA events over ``--repeats`` runs, then a
``torch.profiler`` trace of ``--traced`` prefills and of 4 x ``--traced``
decode steps, summed by kernel name: the device's busy share of the traced
window (1 - idle share), the hand-written kernels' share of the busy time,
the device kernels a step, and the longest kernels.  Needs one CUDA device
and ``nvcc``; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import captured_steps, eager_steps, timed
from repro_torch.models import rwkv6
from repro_torch.models.params import init_params
from repro_torch.profile_edgenext import report, trace

SEED = 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--traced", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("profile_rwkv6: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    print(f"device {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    cfg = get_config("rwkv6-1.6b")
    params = rwkv6.load_params(cfg, init_params(SEED, rwkv6.param_defs(cfg)))
    tokens = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)).cuda()
    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device="cuda")
    device = torch.device("cuda")
    results = dict(device=smi, torch=torch.__version__, batch=args.batch,
                   prompt_len=args.prompt_len, phases={})
    for form, (prefill, decode) in (("eager", eager_steps(cfg, params)),
                                    ("captured", captured_steps(cfg, params))):
        def prefill_once(x):
            return prefill({"tokens": x})

        with torch.inference_mode():
            _, cache = prefill_once(tokens)                  # warm-up (a capture)
            held = [cache]

            def decode_once(x):
                # the captured step returns its donated cache, which the
                # next step is given back, as in the served loop
                tok1, _, held[0] = decode(held[0], {"tokens": x})
                return tok1

            decode_once(tok)
            pre_ms = [timed(lambda: prefill_once(tokens), device)[1]
                      for _ in range(args.repeats)]
            dec_ms = [timed(lambda: decode_once(tok), device)[1]
                      for _ in range(4 * args.repeats)]
        for name, ms, fn, x, n in (
                ("prefill", pre_ms, prefill_once, tokens, args.traced),
                ("decode_step", dec_ms, decode_once, tok, 4 * args.traced)):
            rec = dict(event_ms_median=statistics.median(ms), event_ms_min=min(ms),
                       event_ms_max=max(ms), **trace(fn, x, n))
            results["phases"][f"{name}_{form}"] = rec
            shape = f" T={args.prompt_len}" if name == "prefill" else ""
            report(f"{name} {form} B={args.batch}{shape}", "steps", rec)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
