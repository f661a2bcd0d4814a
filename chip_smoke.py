#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and prints,
for each, every entry function's registers, spills and shared memory and
its count of tensor-core instructions (``build_kernel`` lines); holds each
kernel against its plain PyTorch version on the card, then drives two paths,
each through the port's ``CombiningEngine`` serving 8 requests x 32 tokens
with bf16 weights drawn from seed 0 at full width: qwen3-1.7b (28 layers,
``flash_attention`` in prefill, ``decode_attention`` in decode), then,
after qwen3's weights are freed, mamba2-2.7b (64 layers, ``ssd_scan`` in
prefill).  For each path it checks the served tokens against a direct
greedy run, every kernel's launch count, and crash recovery of a
completed request, and prints timings (each kernel's median, min and max
over 25 launches).  The last two lines of standard
output are the ``kernels`` JSON line and ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero and prints no result; so does a
machine with no CUDA device, or a directory that holds this script and
nothing else of the repository.  ``--profile`` adds a torch.profiler
breakdown of a prefill round and of decode steps of each path.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
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
# ssd_scan's f32 outputs: y sums up to ~640 terms (128 intra-chunk, 128
# state columns, the carried state) of magnitude up to ~50 in another
# order than the plain version, so agreement is to ~1e-5 of |y|'s scale
SSD_TOL = {"bfloat16": 2e-2, "float32": 1e-3}   # per output dtype
KERNELS = {   # name: (source, TPU kernel it replaces)
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:97"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:74"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:69"),
}

# the paths: launches of each kernel per prefill round and per decode
# step, in units of layers
SLICE = dict(arch="qwen3-1.7b", batch=8, max_len=1024, prompt=512,
             max_tokens=32, seed=0,
             per_layer={"flash_attention": (1, 0), "decode_attention": (0, 1),
                        "ssd_scan": (0, 0)})
SSM_SLICE = dict(SLICE, arch="mamba2-2.7b",
                 per_layer={"flash_attention": (0, 0),
                            "decode_attention": (0, 0), "ssd_scan": (1, 0)})


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
# phase 2a: what the compiler made of each kernel
# --------------------------------------------------------------------- #
# kernels whose bf16 instantiations must run their products on tensor cores
TENSOR_CORE_KERNELS = ("flash_attention", "ssd_scan")


def build_report():
    """One line per kernel source: for each entry function (by its mangled
    name, which carries the template arguments), the registers,
    spills and static shared memory that ``-Xptxas -v`` wrote to
    build.log, and the count of tensor-core instructions in its SASS
    (HMMA from mma.sync, HGMMA from wgmma) where the toolkit has
    ``cuobjdump``.  Fails if a kernel of TENSOR_CORE_KERNELS has no
    tensor-core instruction."""
    from repro_torch.kernels import _build
    lib_dir = _build.library_dir()
    entries, kernel, cur = {}, None, None
    for line in (lib_dir / "build.log").read_text().splitlines():
        if m := re.match(r"== (\w+)\.cu \(rc", line):
            kernel = m.group(1)
        elif m := re.search(r"Compiling entry function '(\w+)'", line):
            cur = entries[m.group(1)] = {"kernel": kernel}
        elif cur is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        elif cur is not None and (m := re.search(r"Used (\d+) registers",
                                                 line)):
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    bindir = Path(_build._nvcc()).parent
    cuobjdump = bindir / "cuobjdump"
    sass = None
    if cuobjdump.is_file():
        sass = {}
        fn = None
        dump = subprocess.run([str(cuobjdump), "-sass",
                               str(lib_dir / _build.LIB_NAME)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for line in dump.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                sass[fn] = {"hmma": 0, "hgmma": 0}
            elif fn is not None and "HGMMA" in line:
                sass[fn]["hgmma"] += 1
            elif fn is not None and "HMMA" in line:
                sass[fn]["hmma"] += 1
    for kname in KERNELS:
        rows = []
        for mangled, e in entries.items():
            if e["kernel"] != kname:
                continue
            row = {"entry": mangled,
                   **{k: v for k, v in e.items() if k != "kernel"}}
            if sass is not None:
                row.update(sass.get(mangled, {"hmma": None, "hgmma": None}))
            rows.append(row)
        say({"phase": "build_kernel", "kernel": kname, "entries": rows,
             "sass": "cuobjdump -sass" if sass is not None else
             f"no cuobjdump in {bindir}: tensor-core counts not read"})
        if sass is not None and kname in TENSOR_CORE_KERNELS and not any(
                (r["hmma"] or 0) + (r["hgmma"] or 0) for r in rows):
            fail(f"{kname}: no tensor-core instruction in its SASS")


# --------------------------------------------------------------------- #
# timing helpers
# --------------------------------------------------------------------- #
class Timer:
    """Median, min and max of per-launch CUDA-event times, with the L2
    cache flushed before every launch (the model's callers find their
    inputs cold)."""

    def __init__(self, torch, iters: int = 25, warmup: int = 5):
        self.torch = torch
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn):
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
        return times[len(times) // 2], times[0], times[-1]

    def row(self, key: str, fn) -> dict:
        """``{key: median, key_min: min, key_max: max}`` of fn's times."""
        med, lo, hi = self(fn)
        return {key: med, f"{key}_min": lo, f"{key}_max": hi}


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #
def check_kernels(torch):
    from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                     flash_attention, flash_attention_plain,
                                     ssd_scan, ssd_scan_plain)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = {name: 0.0 for name in KERNELS}

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda",
                                    dtype=torch.float32)).to(dtype)

    def compare(name, case, got, want, dtype, tols=TOL):
        tol = tols[str(dtype).split(".")[-1]]
        err = (got.float() - want.float()).abs()
        bound = tol + tol * want.float().abs()
        ok = bool(torch.isfinite(got.float()).all()) and bool((err <= bound).all())
        max_err = float(err.max())
        worst[name] = max(worst[name], max_err)
        say({"check": name, "dtype": str(dtype).split(".")[-1], **case,
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
        dict(B=1, H=8, Hkv=1, Sq=77, Sk=77, d=256, causal=False),    # G = 8
        dict(B=2, H=8, Hkv=8, Sq=200, Sk=200, d=128),                # G = 1
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

    # ssd_scan: y and the final state, at the mamba2 slice's shape and at
    # ragged lengths, with the distributions of tests/test_kernels.py
    ssd_cases = [dict(B=8, L=512, H=80, chunk=128),                   # slice
                 dict(B=2, L=300, H=80, chunk=128),                   # ragged
                 dict(B=2, L=100, H=16, chunk=128),                   # L < chunk
                 dict(B=2, L=448, H=16, chunk=64),
                 dict(B=2, L=448, H=16, chunk=256),
                 dict(B=1, L=1100, H=4, chunk=1024)]                 # MAX_CHUNK
    for dtype, out in ((torch.bfloat16, torch.float32),  # as the model calls it
                       (torch.bfloat16, torch.bfloat16),
                       (torch.float32, torch.float32)):
        for c in ssd_cases:
            B, L, H = c["B"], c["L"], c["H"]
            x = randn(B, L, H, 64, dtype=dtype, scale=0.5)
            dt = torch.nn.functional.softplus(randn(B, L, H))
            A = -torch.exp(randn(H, scale=0.3))
            Bm = randn(B, L, 128, dtype=dtype, scale=0.5)
            Cm = randn(B, L, 128, dtype=dtype, scale=0.5)
            y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=c["chunk"], out_dtype=out)
            y0, st0 = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=c["chunk"],
                                     out_dtype=out)
            case = dict(c, P=64, N=128, x_dtype=str(dtype).split(".")[-1])
            compare("ssd_scan", dict(case, out="y"), y, y0, out, SSD_TOL)
            compare("ssd_scan", dict(case, out="final_state"), st, st0,
                    torch.float32, SSD_TOL)
    torch.cuda.synchronize()
    return worst


def check_model_vs_cpu(torch, arch):
    """Two full-width layers of ``arch`` in f32: prefill of 100 tokens (no
    multiple of ssd_scan's chunk) and two decode steps on the card
    (kernels) against the CPU (plain versions)."""
    from repro_torch.configs import get
    from repro_torch.models import decode_step, init_params, prefill
    cfg = dataclasses.replace(get(arch), n_layers=2)
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
    say({"check": "model_card_vs_cpu", "arch": arch, "layers": 2,
         "dtype": "float32", "max_abs_err": err, "atol": 1e-4, "rtol": 1e-3,
         "logit_absmax": float(outs["cpu"][..., :cfg.vocab_size].abs().max()),
         "ok": ok})
    if not ok:
        fail(f"2-layer full-width {arch} on the card disagrees with the CPU")


# --------------------------------------------------------------------- #
# phase 3: the slice
# --------------------------------------------------------------------- #
def slice_inputs(torch, np, spec):
    """The path's config, bf16 parameters drawn from the seed, and its
    prompts; one prefill and one decode step warm cuBLAS and the
    allocator."""
    from repro_torch.configs import get
    from repro_torch.models import decode_step, init_params, param_count, prefill

    cfg = get(spec["arch"])
    t0 = time.perf_counter()
    params = init_params(cfg, seed=spec["seed"], device="cuda")
    torch.cuda.synchronize()
    say({"phase": "init_params", "arch": cfg.name, "layers": cfg.n_layers,
         "d_model": cfg.d_model, "vocab": cfg.padded_vocab,
         "params": param_count(params), "dtype": "bfloat16",
         "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(spec["seed"])
    prompts = [rng.integers(0, cfg.vocab_size, size=spec["prompt"]).tolist()
               for _ in range(spec["batch"])]
    lg, st = prefill(params, cfg, prompts, device="cuda",
                     max_len=spec["max_len"])
    decode_step(params, cfg, st, torch.argmax(lg, -1), device="cuda")
    torch.cuda.synchronize()
    return cfg, params, prompts


def median(xs):
    return sorted(xs)[len(xs) // 2]


def kernel_counts():
    from repro_torch import kernels
    return {name: getattr(kernels, name).launches for name in KERNELS}


def zero_counts():
    from repro_torch import kernels
    for name in KERNELS:
        getattr(kernels, name).launches = 0


def run_slice(torch, np, spec):
    """Serve the path's requests through the engine and check them; return
    its timings and each kernel's launches in the served run."""
    from repro_torch.launch.serve import build_server
    from repro_torch.models import decode_step, prefill

    B, T = spec["batch"], spec["max_tokens"]
    cfg, params, prompts = slice_inputs(torch, np, spec)

    eng = build_server(cfg, params, batch=B, max_len=spec["max_len"],
                       device="cuda")
    results = {}
    barrier = threading.Barrier(B)

    def client(c):
        barrier.wait()
        results[c] = eng.submit(c, prompts[c], T, seq=1, timeout=900)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(B)]
    zero_counts()
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
    launches = kernel_counts()
    eng.stop()
    stats = dict(eng.stats)
    say({"phase": "serve", "arch": cfg.name, "requests": B, "max_tokens": T,
         **stats, "launches": launches, "seconds": serve_s})

    if len(results) != B:
        fail(f"{len(results)} of {B} requests answered")
    for c, r in results.items():
        toks = r["tokens"]
        if len(toks) != T or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"client {c}: bad response {toks}")
    L = cfg.n_layers
    for name, (per_prefill, per_decode) in spec["per_layer"].items():
        want = L * (per_prefill * stats["prefill_rounds"]
                    + per_decode * stats["decode_rounds"])
        if launches[name] != want:
            fail(f"{cfg.name}: {name} launched {launches[name]} times for "
                 f"{stats['prefill_rounds']} prefill rounds and "
                 f"{stats['decode_rounds']} decode rounds, not {want}")
    if stats["persists"] < 1:
        fail("no completion was persisted")

    # the served tokens equal a direct greedy run of the same batch; its
    # host-clock times, with no engine threads around the model, and the
    # time a decode step takes to enqueue (the call returns before the
    # card is done) say whether the host or the card sets the pace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, st = prefill(params, cfg, prompts, device="cuda",
                     max_len=spec["max_len"])
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
    before = kernel_counts()
    eng.restart_after_crash()
    rec = eng.recover_request(0, prompts[0], T, seq=1, timeout=5)
    if rec != results[0]:
        fail("recover_request did not return client 0's logged response")
    if kernel_counts() != before:
        fail("recovery launched a kernel")
    say({"phase": "recover", "arch": cfg.name, "client": 0, "cached": True,
         "tokens": len(rec["tokens"])})

    times = eng.step_times
    dec = times["decode"]
    return {
        "arch": cfg.name,
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
def profile_slice(torch, np, spec, steps: int = 8, top: int = 8):
    """torch.profiler over one direct prefill and ``steps`` decode steps
    of a path: the card's busy share of each, and the ops with the most
    device and host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step, prefill

    cfg, params, prompts = slice_inputs(torch, np, spec)

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
        say({"phase": "profile", "arch": cfg.name, "what": name, "repeats": n,
             "wall_ms": 1e3 * wall_s / n, "device_busy_ms": busy_ms / n,
             "device_busy_share": busy_ms / (1e3 * wall_s),
             "top_device_ms": {e.key: device_us(e) / 1e3 / n for e in by_dev},
             "top_host_ms": {e.key: e.self_cpu_time_total / 1e3 / n
                             for e in by_cpu}})

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        lg, st = prefill(params, cfg, prompts, device="cuda",
                         max_len=spec["max_len"])
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
                                     flash_attention, flash_attention_plain,
                                     ssd_scan, ssd_scan_plain)
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
        **timer.row("ms", lambda: flash_attention(q, k, v, causal=True)),
        **timer.row("plain_ms",
                    lambda: flash_attention_plain(q, k, v, causal=True)),
        **timer.row("library_ms", lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }

    Smax = SLICE["max_len"]
    kv_len = SLICE["prompt"] + SLICE["max_tokens"] // 2   # mid-generation
    qd = randn(B, H, d)
    kc, vc = randn(B, Hkv, Smax, d), randn(B, Hkv, Smax, d)
    # the yardstick gets the cache prefix contiguous, made once here and
    # not inside its timed call
    q4 = qd[:, :, None, :]
    kpre = kc[:, :, :kv_len].contiguous()
    vpre = vc[:, :, :kv_len].contiguous()
    flops = 2 * 2 * B * H * kv_len * d
    nbytes = es * (2 * B * Hkv * kv_len * d + 2 * B * H * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    dec = {
        "shape": f"q [{B},{H},{d}] cache [{B},{Hkv},{Smax},{d}] bf16 "
                 f"kv_len {kv_len}",
        **timer.row("ms", lambda: decode_attention(qd, kc, vc, kv_len)),
        **timer.row("plain_ms",
                    lambda: decode_attention_plain(qd, kc, vc, kv_len)),
        **timer.row("library_ms", lambda: F.scaled_dot_product_attention(
            q4, kpre, vpre, enable_gqa=True)),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }

    # ssd_scan as mamba2's prefill calls it: x, Bm, Cm bf16 from the
    # convs, dt and A f32, y f32; one chunk's work is C B^T over the whole
    # chunk (as the TPU kernel computes it), the masked product with X,
    # C S^T and the state update; no PyTorch call computes the scan
    from repro_torch.configs import get
    cfg = get(SSM_SLICE["arch"])
    B, L = SSM_SLICE["batch"], SSM_SLICE["prompt"]
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    H, cl = cfg.ssm_expand * cfg.d_model // P, 128
    x = 0.5 * randn(B, L, H, P)
    Bm, Cm = 0.5 * randn(B, L, N), 0.5 * randn(B, L, N)
    dt = F.softplus(torch.randn(B, L, H, generator=gen, device="cuda"))
    A = -torch.exp(0.3 * torch.randn(H, generator=gen, device="cuda"))
    f32 = 4
    nbytes = (es * B * L * H * P + f32 * B * L * H + f32 * H
              + 2 * es * B * L * N + f32 * B * L * H * P + f32 * B * H * P * N)
    n_chunks = -(-L // cl)
    flops = B * H * n_chunks * (2 * cl * cl * N + 2 * cl * cl * P
                                + 2 * cl * N * P + 2 * cl * P * N)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    ssd = {
        "shape": f"x [{B},{L},{H},{P}] Bm,Cm [{B},{L},{N}] bf16, dt f32, "
                 f"y f32, chunk {cl}",
        **timer.row("ms", lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=cl,
                                           out_dtype=torch.float32)),
        **timer.row("plain_ms", lambda: ssd_scan_plain(
            x, dt, A, Bm, Cm, chunk=cl, out_dtype=torch.float32)),
        "library_ms": None,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    return {"flash_attention": flash, "decode_attention": dec,
            "ssd_scan": ssd}


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
    build_report()
    worst = check_kernels(torch)
    for spec in (SLICE, SSM_SLICE):
        check_model_vs_cpu(torch, spec["arch"])

    # phase 3: the paths, one after the other; each kernel runs on one of
    # them (run_slice checks that the other launches it no time), so its
    # launches on the main path are the sum over both runs
    launches = {kname: 0 for kname in KERNELS}
    for spec in (SLICE, SSM_SLICE):
        slice_t, path_launches = run_slice(torch, np, spec)
        say({"phase": "slice_timing", **slice_t, "device": name,
             "nvidia_smi": smi})
        for kname, n in path_launches.items():
            launches[kname] += n
        gc.collect()                 # free this path's weights and state
        torch.cuda.empty_cache()
    # after both served runs: a run after the profiler has traced was
    # seen to step slower on the host
    for spec in (SLICE, SSM_SLICE) if args.profile else ():
        profile_slice(torch, np, spec)
        gc.collect()
        torch.cuda.empty_cache()

    # phase 4: per-kernel timings
    kt = time_kernels(torch)
    for kname, row in kt.items():
        say({"phase": "kernel_timing", "name": kname, **row,
             "launches": launches[kname], "device": name,
             "nvidia_smi": smi})
    rows = []
    for kname, (src, tpu) in KERNELS.items():
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
