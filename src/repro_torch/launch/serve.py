"""Serving launcher: the combining batch engine over the dense model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --smoke --device cpu --requests 8

``build_server`` is the reference launcher's batching adapter
(``repro/launch/serve.py:45-68``): a fixed batch ``B``, prompts
right-padded with 0 to the longest, one shared batched ``DecodeState``,
greedy argmax.  Its semantics are the reference's, quirk included:
every prefill round replaces the one shared state, so sequences
admitted in an earlier round then decode against the newer round's
cache at a shared position (ROADMAP.md, "Faults").
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Any, Dict, List

import torch

from ..configs import get
from ..device import resolve
from ..models import decode_step, init_params, prefill
from ..serving.engine import CombiningEngine


def build_server(cfg, params, *, batch: int, max_len: int, device="cuda",
                 n_clients: int = 0) -> CombiningEngine:
    """A ``CombiningEngine`` whose prefill and decode combiners run the
    model on ``device`` at a fixed batch.  The engine's ``step_times``
    holds the host-clock seconds of every prefill round and decode step
    (each ends in a device-to-host copy of the argmax, so each is a
    completed step)."""
    B = batch
    dev = resolve(device)
    shared: Dict[str, Any] = {}
    times: Dict[str, List[float]] = {"prefill": [], "decode": []}

    def prefill_batch(prompts):
        t0 = time.perf_counter()
        L = max(len(p) for p in prompts)
        rows = [list(p) + [0] * (L - len(p)) for p in prompts]
        rows += [[0] * L] * (B - len(rows))
        logits, state = prefill(params, cfg, rows, device=dev,
                                max_len=max_len)
        shared["state"] = state
        first = torch.argmax(logits, -1).tolist()
        times["prefill"].append(time.perf_counter() - t0)
        return [int(t) for t in first[:len(prompts)]], \
            list(range(len(prompts)))

    def decode_batch(kvs, last):
        t0 = time.perf_counter()
        toks = list(last) + [0] * (B - len(last))
        logits, new_state = decode_step(params, cfg, shared["state"], toks,
                                        device=dev)
        shared["state"] = new_state
        nxt = torch.argmax(logits, -1).tolist()
        times["decode"].append(time.perf_counter() - t0)
        return [int(t) for t in nxt[:len(last)]]

    eng = CombiningEngine(max(n_clients, B),
                          prefill_batch_fn=prefill_batch,
                          decode_batch_fn=decode_batch,
                          n_kv_slots=B, max_batch=B, eos_token=-1)
    eng.step_times = times
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve(args.device)
    params = init_params(cfg, args.seed, device=dev)
    eng = build_server(cfg, params, batch=args.batch, max_len=args.max_len,
                       device=dev, n_clients=args.requests)
    eng.start()

    done = {}

    def client(c):
        done[c] = eng.submit(c, [c + 1, c + 2], args.max_tokens, seq=1,
                             timeout=600)

    ts = [threading.Thread(target=client, args=(c,))
          for c in range(args.requests)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    el = time.perf_counter() - t0
    eng.stop()
    s = eng.stats
    print(f"{args.requests} requests x {args.max_tokens} tokens in "
          f"{el:.2f}s on {dev}; decode combining degree "
          f"{s['decode_batched'] / max(1, s['decode_rounds']):.1f}; "
          f"persist rounds {s['persists']}")
    return done


if __name__ == "__main__":
    main()
