#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
one against its plain PyTorch version on the card, then serves 8 requests
x 32 tokens through the port's ``CombiningEngine`` over full-width
qwen3-1.7b (28 layers, bf16 weights drawn from seed 0), checks the served
tokens, the kernels' launch counts and crash recovery of a completed
request, and prints timings.  The last two lines of standard output are
the ``kernels`` JSON line and ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero and prints no result; so does a machine with no
CUDA device, or a directory that holds this script and nothing else of
the repository.  ``--profile`` adds a torch.profiler breakdown of a
prefill round and of decode steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data-sheet peaks (dense, no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # atol = rtol, per input dtype
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
DECODE_SRC = "src/repro_torch/csrc/decode_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention.py:97"
DECODE_TPU = "src/repro/kernels/decode_attention.py:74"

SLICE = dict(arch="qwen3-1.7b", batch=8, max_len=1024, prompt=512,
             max_tokens=32, seed=0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# timing helpers
# --------------------------------------------------------------------- #
class Timer:
    """Median of per-launch CUDA-event times, with the L2 cache flushed
    before every launch (the model's callers find their inputs cold)."""

    def __init__(self, torch, iters: int = 25, warmup: int = 5):
        self.torch = torch
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #
def check_kernels(torch):
    from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                     flash_attention, flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = {"flash_attention": 0.0, "decode_attention": 0.0}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    def compare(name, case, got, want, dtype):
        tol = TOL[str(dtype).split(".")[-1]]
        err = (got.float() - want.float()).abs()
        bound = tol + tol * want.float().abs()
        ok = bool(torch.isfinite(got.float()).all()) and bool((err <= bound).all())
        max_err = float(err.max())
        worst[name] = max(worst[name], max_err)
        say({"check": name, **case, "dtype": str(dtype).split(".")[-1],
             "max_abs_err": max_err, "atol": tol, "rtol": tol, "ok": ok})
        if not ok:
            fail(f"{name} {case} disagrees with its plain version")

    flash_cases = [
        dict(B=8, H=16, Hkv=8, Sq=512, Sk=512, d=128),               # slice
        dict(B=2, H=16, Hkv=8, Sq=200, Sk=200, d=128),               # ragged
        dict(B=2, H=16, Hkv=8, Sq=128, Sk=512, d=128),               # Sq < Sk
        dict(B=2, H=16, Hkv=8, Sq=256, Sk=256, d=128, causal=False),
        dict(B=2, H=16, Hkv=8, Sq=512, Sk=512, d=128, window=64),
        dict(B=2, H=16, Hkv=8, Sq=512, Sk=512, d=128, softcap=50.0),
        dict(B=1, H=4, Hkv=2, Sq=300, Sk=300, d=256, window=64, softcap=50.0),
        dict(B=1, H=4, Hkv=1, Sq=130, Sk=70, d=128),                 # Sq > Sk
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for c in flash_cases:
            kw = dict(causal=c.get("causal", True), window=c.get("window"),
                      softcap=c.get("softcap"))
            q = randn(c["B"], c["H"], c["Sq"], c["d"], dtype=dtype)
            k = randn(c["B"], c["Hkv"], c["Sk"], c["d"], dtype=dtype)
            v = randn(c["B"], c["Hkv"], c["Sk"], c["d"], dtype=dtype)
            compare("flash_attention", c, flash_attention(q, k, v, **kw),
                    flash_attention_plain(q, k, v, **kw), dtype)

    decode_cases = [dict(B=8, H=16, Hkv=8, S=1024, hd=128, kv_len=n)
                    for n in (1, 513, 1024)]
    decode_cases += [
        dict(B=8, H=8, Hkv=8, S=1024, hd=128, kv_len=700),            # G = 1
        dict(B=8, H=16, Hkv=8, S=1024, hd=128, kv_len=700, window=100,
             softcap=50.0),
        dict(B=2, H=64, Hkv=8, S=512, hd=128, kv_len=300),            # G = 8
        dict(B=2, H=16, Hkv=8, S=512, hd=256, kv_len=400, window=64,
             softcap=50.0),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for c in decode_cases:
            kw = dict(window=c.get("window"), softcap=c.get("softcap"))
            q = randn(c["B"], c["H"], c["hd"], dtype=dtype)
            k = randn(c["B"], c["Hkv"], c["S"], c["hd"], dtype=dtype)
            v = randn(c["B"], c["Hkv"], c["S"], c["hd"], dtype=dtype)
            compare("decode_attention", c,
                    decode_attention(q, k, v, c["kv_len"], **kw),
                    decode_attention_plain(q, k, v, c["kv_len"], **kw), dtype)
    torch.cuda.synchronize()
    return worst


def check_model_vs_cpu(torch):
    """Two full-width qwen3-1.7b layers in f32: prefill and two decode
    steps on the card (kernels) against the CPU (plain versions)."""
    from repro_torch.configs import get
    from repro_torch.models import decode_step, init_params, prefill
    cfg = dataclasses.replace(get(SLICE["arch"]), n_layers=2)
    p_cpu = init_params(cfg, 1, device="cpu", dtype=torch.float32)

    def to_card(t):
        return {k: to_card(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.to("cuda")
    p_gpu = to_card(p_cpu)
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen)
    outs = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        lg, st = prefill(p, cfg, toks, device=dev, max_len=104)
        seq = [lg]
        for t in (toks[:, 0], toks[:, 1]):
            lg, st = decode_step(p, cfg, st, t, device=dev)
            seq.append(lg)
        outs[dev] = torch.stack([x.float().cpu() for x in seq])
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    ok = bool(torch.allclose(outs["cuda"], outs["cpu"], atol=1e-4, rtol=1e-3))
    say({"check": "model_card_vs_cpu", "layers": 2, "dtype": "float32",
         "max_abs_err": err, "atol": 1e-4, "rtol": 1e-3,
         "logit_absmax": float(outs["cpu"][..., :cfg.vocab_size].abs().max()),
         "ok": ok})
    if not ok:
        fail("2-layer full-width model on the card disagrees with the CPU")


# --------------------------------------------------------------------- #
# phase 3: the slice
# --------------------------------------------------------------------- #
def slice_inputs(torch, np):
    """The slice's config, bf16 parameters drawn from the seed, and its
    prompts; one prefill and one decode step warm cuBLAS and the
    allocator."""
    from repro_torch.configs import get
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get(SLICE["arch"])
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SLICE["seed"], device="cuda")
    torch.cuda.synchronize()
    say({"phase": "init_params", "arch": cfg.name, "layers": cfg.n_layers,
         "d_model": cfg.d_model, "vocab": cfg.padded_vocab,
         "dtype": "bfloat16", "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(SLICE["seed"])
    prompts = [rng.integers(0, cfg.vocab_size, size=SLICE["prompt"]).tolist()
               for _ in range(SLICE["batch"])]
    lg, st = prefill(params, cfg, prompts, device="cuda",
                     max_len=SLICE["max_len"])
    decode_step(params, cfg, st, torch.argmax(lg, -1), device="cuda")
    torch.cuda.synchronize()
    return cfg, params, prompts


def median(xs):
    return sorted(xs)[len(xs) // 2]


def run_slice(torch, np):
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch.serve import build_server
    from repro_torch.models import decode_step, prefill

    B, T = SLICE["batch"], SLICE["max_tokens"]
    cfg, params, prompts = slice_inputs(torch, np)

    eng = build_server(cfg, params, batch=B, max_len=SLICE["max_len"],
                       device="cuda")
    results = {}
    barrier = threading.Barrier(B)

    def client(c):
        barrier.wait()
        results[c] = eng.submit(c, prompts[c], T, seq=1, timeout=900)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(B)]
    flash_attention.launches = 0
    decode_attention.launches = 0
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while len(eng.board.pending()) < B:       # all 8 form one prefill round
        if time.time() > deadline:
            fail("clients did not announce")
        time.sleep(0.001)
    t_serve = time.perf_counter()
    eng.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    eng.stop()
    stats = dict(eng.stats)
    say({"phase": "serve", "requests": B, "max_tokens": T, **stats,
         "launches": launches, "seconds": serve_s})

    if len(results) != B:
        fail(f"{len(results)} of {B} requests answered")
    for c, r in results.items():
        toks = r["tokens"]
        if len(toks) != T or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"client {c}: bad response {toks}")
    L = cfg.n_layers
    if launches["flash_attention"] != L * stats["prefill_rounds"]:
        fail(f"flash_attention launched {launches['flash_attention']} times "
             f"for {stats['prefill_rounds']} prefill rounds")
    if launches["decode_attention"] != L * stats["decode_rounds"]:
        fail(f"decode_attention launched {launches['decode_attention']} "
             f"times for {stats['decode_rounds']} decode rounds")
    if stats["persists"] < 1:
        fail("no completion was persisted")

    # the served tokens equal a direct greedy run of the same batch; its
    # host-clock times, with no engine threads around the model, and the
    # time a decode step takes to enqueue (the call returns before the
    # card is done) say whether the host or the card sets the pace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, st = prefill(params, cfg, prompts, device="cuda",
                     max_len=SLICE["max_len"])
    nxt = torch.argmax(lg, -1)
    direct = [nxt.tolist()]
    direct_prefill_s = time.perf_counter() - t0
    direct_step_s = []
    for _ in range(T - 1):
        t0 = time.perf_counter()
        lg, st = decode_step(params, cfg, st, nxt, device="cuda")
        nxt = torch.argmax(lg, -1)
        direct.append(nxt.tolist())
        direct_step_s.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(lg.float()).all()):
        fail("non-finite logits")
    for c in range(B):
        if [row[c] for row in direct] != results[c]["tokens"]:
            fail(f"client {c}: served tokens differ from a direct greedy run")
    enqueue_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, st = decode_step(params, cfg, st, nxt, device="cuda")
        enqueue_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    del st, lg

    # crash: the durable response log answers client 0 with no launch
    before = (flash_attention.launches, decode_attention.launches)
    eng.restart_after_crash()
    rec = eng.recover_request(0, prompts[0], T, seq=1, timeout=5)
    if rec != results[0]:
        fail("recover_request did not return client 0's logged response")
    if (flash_attention.launches, decode_attention.launches) != before:
        fail("recovery launched a kernel")
    say({"phase": "recover", "client": 0, "cached": True,
         "tokens": len(rec["tokens"])})

    times = eng.step_times
    dec = times["decode"]
    return {
        "prefill_ms_per_round": 1e3 * sum(times["prefill"]) / len(times["prefill"]),
        "decode_ms_per_step": 1e3 * median(dec),
        "decode_ms_per_step_mean": 1e3 * sum(dec) / len(dec),
        "tokens_per_s": B * T / serve_s,
        "prefill_rounds": stats["prefill_rounds"],
        "decode_rounds": stats["decode_rounds"],
        "direct_prefill_ms": 1e3 * direct_prefill_s,
        "direct_decode_ms_per_step": 1e3 * median(direct_step_s),
        "decode_enqueue_ms_per_step": 1e3 * median(enqueue_s),
    }, launches


# --------------------------------------------------------------------- #
# --profile: where a prefill round and a decode step spend their time
# --------------------------------------------------------------------- #
def profile_slice(torch, np, steps: int = 8, top: int = 8):
    """torch.profiler over one direct prefill and ``steps`` decode steps
    of the slice: the card's busy share of each, and the ops with the
    most device and host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step, prefill

    cfg, params, prompts = slice_inputs(torch, np)

    def device_us(e):
        return e.self_device_time_total

    def report(name, prof, wall_s, n):
        ev = prof.key_averages()
        # the card's own events (kernels, copies); a host op's entry
        # repeats the time of the kernels it launched, so it is left out
        dev = [e for e in ev if e.device_type == DeviceType.CUDA]
        host = [e for e in ev if e.device_type == DeviceType.CPU]
        busy_ms = sum(device_us(e) for e in dev) / 1e3
        by_dev = sorted(dev, key=device_us, reverse=True)[:top]
        by_cpu = sorted(host, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:top]
        say({"phase": "profile", "what": name, "repeats": n,
             "wall_ms": 1e3 * wall_s / n, "device_busy_ms": busy_ms / n,
             "device_busy_share": busy_ms / (1e3 * wall_s),
             "top_device_ms": {e.key: device_us(e) / 1e3 / n for e in by_dev},
             "top_host_ms": {e.key: e.self_cpu_time_total / 1e3 / n
                             for e in by_cpu}})

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        lg, st = prefill(params, cfg, prompts, device="cuda",
                         max_len=SLICE["max_len"])
        nxt = torch.argmax(lg, -1)
        nxt.tolist()
        wall = time.perf_counter() - t0
    report("prefill", prof, wall, 1)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, st = decode_step(params, cfg, st, nxt, device="cuda")
            nxt = torch.argmax(lg, -1)
            nxt.tolist()
        wall = time.perf_counter() - t0
    report("decode_step", prof, wall, steps)


# --------------------------------------------------------------------- #
# phase 4: per-kernel timings at the slice's shapes
# --------------------------------------------------------------------- #
def time_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                     flash_attention, flash_attention_plain)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(99)
    bf = torch.bfloat16
    es = 2  # bytes per bf16 element

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    B, H, Hkv, d = 8, 16, 8, 128
    S = SLICE["prompt"]
    q, k, v = randn(B, H, S, d), randn(B, Hkv, S, d), randn(B, Hkv, S, d)
    flops = 2 * 2 * B * H * S * S * d / 2
    nbytes = es * (2 * B * H * S * d + 2 * B * Hkv * S * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    flash = {
        "shape": f"q [{B},{H},{S},{d}] k,v [{B},{Hkv},{S},{d}] bf16 causal",
        "ms": timer(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": timer(lambda: flash_attention_plain(q, k, v, causal=True)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }

    Smax = SLICE["max_len"]
    kv_len = SLICE["prompt"] + SLICE["max_tokens"] // 2   # mid-generation
    qd = randn(B, H, d)
    kc, vc = randn(B, Hkv, Smax, d), randn(B, Hkv, Smax, d)
    q4 = qd[:, :, None, :]
    flops = 2 * 2 * B * H * kv_len * d
    nbytes = es * (2 * B * Hkv * kv_len * d + 2 * B * H * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    dec = {
        "shape": f"q [{B},{H},{d}] cache [{B},{Hkv},{Smax},{d}] bf16 "
                 f"kv_len {kv_len}",
        "ms": timer(lambda: decode_attention(qd, kc, vc, kv_len)),
        "plain_ms": timer(lambda: decode_attention_plain(qd, kc, vc, kv_len)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            q4, kc[:, :, :kv_len], vc[:, :, :kv_len], enable_gqa=True)),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    return {"flash_attention": flash, "decode_attention": dec}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a prefill round and decode steps")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in full f32
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: device
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    say(smi)
    say({"phase": "device", "name": name, "nvidia_smi": smi,
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # phase 2: build, then every kernel against its plain version
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    say({"phase": "build", "seconds": time.perf_counter() - t0,
         "log": str(_build.library_dir() / "build.log")})
    worst = check_kernels(torch)
    check_model_vs_cpu(torch)

    # phase 3: the slice; phase 4: timings
    slice_t, launches = run_slice(torch, np)
    say({"phase": "slice_timing", **slice_t, "device": name,
         "nvidia_smi": smi})
    kt = time_kernels(torch)
    for kname, row in kt.items():
        say({"phase": "kernel_timing", "name": kname, **row,
             "launches": launches[kname], "device": name,
             "nvidia_smi": smi})
    if args.profile:
        profile_slice(torch, np)
    rows = []
    for kname, src, tpu in (("flash_attention", FLASH_SRC, FLASH_TPU),
                            ("decode_attention", DECODE_SRC, DECODE_TPU)):
        r = kt[kname]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": launches[kname],
                     "max_abs_err": worst[kname], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    say(smi)
    say({"kernels": rows})
    say({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
