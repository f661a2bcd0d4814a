"""The port's serving host layer on the CPU: its copies of the engine,
scheduler, KV-slot allocator, StateRec and PBComb checkpointer run the
reference's store-mode tests; ``PSCR1`` records cross between the two
packages both ways; and the port's launcher adapter serves the same
greedy tokens as the reference's on the same f32 parameters.
"""

import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.persist import staterec as ref_staterec
from repro.serving.engine import CombiningEngine as RefEngine
from repro_torch.api import CombiningRuntime
from repro_torch.configs import ARCHS
from repro_torch.launch import serve
from repro_torch.launch.serve import build_server
from repro_torch.models import params_from_reference
from repro_torch.persist import staterec
from repro_torch.persist.checkpoint import PBCombCheckpointer
from repro_torch.persist.store import DirStore, MemStore
from repro_torch.serving.engine import CombiningEngine
from repro_torch.serving.kv_cache import SlotAllocator
from repro_torch.serving.scheduler import RequestHeap

torch.set_num_threads(2)


# ------------------------------------------------------------------ #
# the engine over a toy LM (tests/test_serving.py, store mode)
# ------------------------------------------------------------------ #
def _toy_engine(n=8, slots=8, max_batch=4, slow=0.0, runtime=None,
                response_log="auto"):
    def prefill_batch(prompts):
        if slow:
            time.sleep(slow)
        return [max(1, sum(p) % 97) for p in prompts], \
            [list(p) for p in prompts]

    def decode_batch(kvs, last):
        return [(t + 1) % 97 or 1 for t in last]

    return CombiningEngine(n, prefill_batch_fn=prefill_batch,
                           decode_batch_fn=decode_batch, n_kv_slots=slots,
                           max_batch=max_batch, eos_token=-1,
                           runtime=runtime, response_log=response_log)


def test_generate_and_batching():
    eng = _toy_engine()
    eng.start()
    results = {}

    def client(c):
        results[c] = eng.submit(c, [c, c + 1], max_tokens=6, seq=1)

    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    eng.stop()
    assert all(len(r["tokens"]) == 6 for r in results.values())
    assert eng.stats["decode_batched"] > eng.stats["decode_rounds"]
    assert eng.stats["persists"] <= 8


def test_completion_is_never_admitted_again():
    """A prefill combiner that runs while a decode round completes its
    sequences must not admit them a second time.  Here it runs right
    after each response is served, the window in which the reference
    engine's order (forget the sequences, then serve) re-admits every
    completion not yet served."""
    eng = _toy_engine()
    serve = eng.board.serve

    def serve_then_prefill(rec, response):
        serve(rec, response)
        eng._combine_prefill()
    eng.board.serve = serve_then_prefill
    results = {}

    def client(c):
        results[c] = eng.submit(c, [c, c + 1], max_tokens=3, seq=1,
                                timeout=30)

    ts = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in ts:
        t.start()
    deadline = time.time() + 30
    while len(eng.board.pending()) < 4:
        assert time.time() < deadline
        time.sleep(0.001)
    eng.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    eng.stop()
    assert sorted(results) == [0, 1, 2, 3]
    assert eng.stats["prefill_rounds"] == 1
    assert eng.stats["prefill_batched"] == 4 and not eng.live


def test_detectable_request_recovery():
    eng = _toy_engine()
    eng.start()
    r1 = eng.submit(3, [1, 2, 3], max_tokens=4, seq=1)
    eng.restart_after_crash()
    r2 = eng.recover_request(3, [1, 2, 3], 4, seq=1)
    assert r2 == r1
    r3 = eng.recover_request(4, [9], 3, seq=1)
    assert len(r3["tokens"]) == 3
    eng.stop()


def test_elimination_cancel_pairs_with_generate():
    eng = _toy_engine(slots=1, max_batch=1, slow=0.05)
    eng.start()
    got = {}

    def blocker():
        eng.submit(0, [5], max_tokens=20, seq=1)

    def gen():
        got["gen"] = eng.submit(1, [7], max_tokens=10 ** 6, seq=1,
                                timeout=30)

    def canc():
        time.sleep(0.01)
        got["cancel"] = eng.cancel(2, target=(1, 1), seq=1, timeout=30)

    tb = threading.Thread(target=blocker)
    tg = threading.Thread(target=gen)
    tc = threading.Thread(target=canc)
    tb.start()
    time.sleep(0.005)
    tg.start()
    tc.start()
    for t in (tb, tg, tc):
        t.join(30)
    eng.stop()
    assert got["gen"]["cancelled"] is True
    assert got["cancel"]["cancelled_ok"] is True
    assert eng.stats["eliminated"] == 1


def test_slot_allocator_recycles_lifo():
    a = SlotAllocator(4)
    s = [a.alloc() for _ in range(4)]
    assert a.alloc() is None
    a.free(s[1])
    a.free(s[2])
    assert a.alloc() == s[2]
    assert a.alloc() == s[1]
    assert a.stats["recycled_hits"] == 2


def test_request_heap_priority():
    h = RequestHeap()
    h.insert(5.0, "low")
    h.insert(1.0, "urgent")
    h.insert(3.0, "mid")
    assert h.delete_min() == "urgent"
    assert h.delete_min() == "mid"
    assert h.delete_min() == "low"
    assert h.delete_min() is None


def test_property_random_workload_exactly_once():
    rng = random.Random(42)
    eng = _toy_engine(n=6, slots=4, max_batch=3)
    eng.start()
    results = {}

    def client(c, n_reqs):
        for seq in range(1, n_reqs + 1):
            results[(c, seq)] = eng.submit(c, [c, seq],
                                           max_tokens=rng.randint(1, 4),
                                           seq=seq, timeout=60)

    ts = [threading.Thread(target=client, args=(c, 3)) for c in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    eng.stop()
    assert len(results) == 18
    eng.restart_after_crash()
    for c in range(6):
        cached = eng.ckpt.response(c)
        assert cached is not None
        assert cached == results[(c, cached["seq"])]


def test_priority_admission_under_slot_pressure():
    eng = _toy_engine(slots=1, max_batch=1, slow=0.02)
    eng.start()
    order = []
    lock = threading.Lock()

    def client(c, prio):
        eng.submit(c, [c], max_tokens=2, seq=1, priority=prio)
        with lock:
            order.append(c)

    t0 = threading.Thread(target=client, args=(0, 0.0))
    t0.start()
    time.sleep(0.005)
    t1 = threading.Thread(target=client, args=(1, 9.0))
    t2 = threading.Thread(target=client, args=(2, 1.0))
    t1.start()
    t2.start()
    for t in (t0, t1, t2):
        t.join(30)
    eng.stop()
    assert order.index(2) < order.index(1)


def test_nvm_response_log_and_shm_backend_wait_for_their_slices():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _toy_engine(response_log="nvm")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        CombiningRuntime(n_threads=2, backend="shm")
    rt = CombiningRuntime(n_threads=2)
    for call in (lambda: rt.make("queue"), lambda: rt.spawn_workers(2),
                 rt.quiesce, rt.occupancy, rt.segment_stats,
                 lambda: rt.arm_crash(1)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()
    assert _toy_engine(runtime=rt).store is not None     # "auto" -> "store"
    rt.close()


# ------------------------------------------------------------------ #
# StateRec and the PBComb checkpointer (tests/test_persist.py)
# ------------------------------------------------------------------ #
def _payload(step):
    return {"w": np.full((8, 8), float(step), np.float32),
            "step": np.asarray(step, np.int32)}


TEMPLATE = _payload(0)


def test_staterec_roundtrip():
    buf = staterec.pack(_payload(3), ["a", None], [1, 0])
    payload, rv, da = staterec.unpack(buf, TEMPLATE)
    assert int(payload["step"]) == 3
    assert rv == ["a", None] and da == [1, 0]
    np.testing.assert_array_equal(payload["w"], _payload(3)["w"])


def test_staterec_bf16_roundtrip():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16) * 1.5}
    buf = staterec.pack(p, [None], [0])
    out, _, _ = staterec.unpack(buf, p)
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  np.full((4, 4), 1.5, np.float32))
    assert staterec.payload_nbytes(p) == 32


def test_checkpoint_announce_combine_recover():
    store = MemStore()
    ck = PBCombCheckpointer(store, 2, TEMPLATE)
    ck.initialize(_payload(0))
    ck.announce(0, _payload(5), seq=1)
    ck.announce(1, _payload(5), seq=1)
    assert ck.combine_once() == 2
    assert store.counters["psync"] >= 1
    payload = ck.recover()
    assert int(payload["step"]) == 5
    assert ck.was_applied(0, 1) and ck.was_applied(1, 1)
    assert ck.response(0) == 1


def test_checkpoint_combining_reduces_psyncs():
    store = MemStore()
    ck = PBCombCheckpointer(store, 8, TEMPLATE)
    ck.initialize(_payload(0))
    base = store.counters["psync"]
    for p in range(8):
        ck.announce(p, _payload(7), seq=1)
    ck.combine_once()
    assert store.counters["psync"] - base == 1


@pytest.mark.parametrize("seed", range(12))
def test_checkpoint_crash_never_torn(seed):
    store = MemStore()
    ck = PBCombCheckpointer(store, 2, TEMPLATE)
    ck.initialize(_payload(0))
    ck.announce(0, _payload(1), seq=1)
    ck.combine_once()
    ck.announce(0, _payload(2), seq=2)
    ck.announce(1, _payload(2), seq=1)
    rng = random.Random(seed)
    if rng.random() < 0.5:
        ck.combine_once()
    store.crash(rng)
    ck2 = PBCombCheckpointer(store, 2, TEMPLATE)
    payload = ck2.recover()
    step = int(payload["step"])
    assert step in (1, 2)
    np.testing.assert_array_equal(payload["w"],
                                  np.full((8, 8), float(step), np.float32))
    if step == 2:
        assert ck2.was_applied(0, 2)
        assert ck2.response(0) == 2
    else:
        assert ck2.was_applied(0, 1)
        assert not ck2.was_applied(0, 2)


def test_checkpoint_lease_takeover():
    store = MemStore()
    ck = PBCombCheckpointer(store, 2, TEMPLATE, lease_s=0.01)
    ck.initialize(_payload(0))
    rec = ck.announce(0, _payload(9), seq=1, wait=True, timeout=0.05)
    assert rec.done_event.is_set()
    assert int(ck.recover()["step"]) == 9


def test_dirstore_roundtrip(tmp_path):
    store = DirStore(str(tmp_path))
    ck = PBCombCheckpointer(store, 1, TEMPLATE)
    ck.initialize(_payload(0))
    ck.announce(0, _payload(4), seq=1)
    ck.combine_once()
    store2 = DirStore(str(tmp_path))
    ck2 = PBCombCheckpointer(store2, 1, TEMPLATE)
    payload = ck2.recover()
    assert int(payload["step"]) == 4
    assert ck2.was_applied(0, 1)


def test_checkpointer_over_nvm_waits_for_its_slice():
    with pytest.raises(NotImplementedError, match="NVMStore"):
        PBCombCheckpointer.over_nvm(None, 2, TEMPLATE)


# ------------------------------------------------------------------ #
# PSCR1 across the two packages
# ------------------------------------------------------------------ #
def _mixed_tree(rng):
    """dicts (unsorted keys), lists, tuples, None, bf16, f32 and int32."""
    return {
        "z": [rng.standard_normal((3, 2)).astype(np.float32), None,
              (np.asarray(7, np.int32), rng.standard_normal(4).astype(np.float32))],
        "a": {"bf": (rng.standard_normal((2, 5)) * 3).astype(np.float32),
              "n": None},
        "m": np.arange(6, dtype=np.int32).reshape(2, 3),
    }


def _as_bf16(tree, to):
    out = jax.tree.map(lambda a: a, tree)
    out["a"]["bf"] = to(tree["a"]["bf"])
    return out


def test_tree_leaves_follow_jax_order():
    tree = _mixed_tree(np.random.default_rng(0))
    ours = staterec.tree_leaves(tree)
    theirs = jax.tree_util.tree_leaves(tree)
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        assert a is b


def test_staterec_written_by_the_port_reads_in_the_reference():
    rng = np.random.default_rng(1)
    base = _mixed_tree(rng)
    ours = _as_bf16(base, lambda a: torch.from_numpy(a).to(torch.bfloat16))
    buf = staterec.pack(ours, [{"tokens": [1, 2]}, None], [1, 0])
    tmpl = _as_bf16(jax.tree.map(np.zeros_like, base),
                    lambda a: jnp.zeros(a.shape, jnp.bfloat16))
    got, rv, da = ref_staterec.unpack(buf, tmpl)
    assert rv == [{"tokens": [1, 2]}, None] and da == [1, 0]
    assert str(got["a"]["bf"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(got["a"]["bf"]).view(np.uint16),
        ours["a"]["bf"].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(got["z"][0], base["z"][0])
    np.testing.assert_array_equal(got["z"][2][1], base["z"][2][1])
    assert got["z"][1] is None and int(got["z"][2][0]) == 7
    np.testing.assert_array_equal(got["m"], base["m"])


def test_staterec_written_by_the_reference_reads_in_the_port():
    rng = np.random.default_rng(2)
    base = _mixed_tree(rng)
    theirs = _as_bf16(base, lambda a: jnp.asarray(a, jnp.bfloat16))
    buf = ref_staterec.pack(theirs, ["x"], [1])
    # the port reads it into torch templates and into numpy templates
    t_tmpl = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.float32),
                          base)
    t_tmpl["z"][2] = (torch.zeros((), dtype=torch.int32), t_tmpl["z"][2][1])
    t_tmpl["m"] = torch.zeros((2, 3), dtype=torch.int32)
    t_tmpl["a"]["bf"] = torch.zeros((2, 5), dtype=torch.bfloat16)
    got, rv, da = staterec.unpack(buf, t_tmpl)
    assert rv == ["x"] and da == [1]
    assert got["a"]["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["a"]["bf"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(theirs["a"]["bf"]).view(np.uint16))
    np.testing.assert_array_equal(got["z"][0].numpy(), base["z"][0])
    assert got["z"][1] is None and int(got["z"][2][0]) == 7
    assert got["m"].dtype == torch.int32
    np.testing.assert_array_equal(got["m"].numpy(), base["m"])
    n_tmpl = jax.tree.map(np.zeros_like, theirs)
    got_np, _, _ = staterec.unpack(buf, n_tmpl)
    np.testing.assert_array_equal(got_np["a"]["bf"].view(np.uint16),
                                  np.asarray(theirs["a"]["bf"]).view(np.uint16))


# ------------------------------------------------------------------ #
# the launcher adapter over a real (smoke) model
# ------------------------------------------------------------------ #
CFG_NAME = "qwen3-1.7b"


def _ref_adapter(cfg, tree, B, max_len):
    """The reference launcher's batching adapter
    (``repro/launch/serve.py:45-68``) with its ``max_len``."""
    jit_prefill = jax.jit(lambda p, t: ref_prefill(p, cfg, t, {},
                                                   max_len=max_len))
    jit_decode = jax.jit(lambda p, s, t: ref_decode_step(p, cfg, s, t))
    shared = {}

    def prefill_batch(prompts):
        L = max(len(p) for p in prompts)
        rows = [list(p) + [0] * (L - len(p)) for p in prompts]
        rows += [[0] * L] * (B - len(rows))
        logits, state = jit_prefill(tree, jnp.asarray(rows, jnp.int32))
        shared["state"] = state
        first = np.asarray(jnp.argmax(logits, -1))
        return [int(t) for t in first[:len(prompts)]], \
            list(range(len(prompts)))

    def decode_batch(kvs, last):
        toks = list(last) + [0] * (B - len(last))
        logits, new_state = jit_decode(tree, shared["state"],
                                       jnp.asarray(toks, jnp.int32))
        shared["state"] = new_state
        nxt = np.asarray(jnp.argmax(logits, -1))
        return [int(t) for t in nxt[:len(last)]]
    return prefill_batch, decode_batch


@pytest.fixture(scope="module")
def model():
    rcfg = REF_ARCHS[CFG_NAME].smoke()
    tree = jax.tree.map(np.asarray, ref_init_params(rcfg, jax.random.PRNGKey(3),
                                                    dtype=jnp.float32))
    return rcfg, tree, params_from_reference(tree, device="cpu")


def _serve(eng, prompts, max_tokens):
    """All clients announce before the engine starts, so the round
    structure (one prefill round) is the same in every run."""
    results = {}

    def client(c):
        results[c] = eng.submit(c, prompts[c], max_tokens, seq=1, timeout=180)

    ts = [threading.Thread(target=client, args=(c,)) for c in prompts]
    for t in ts:
        t.start()
    deadline = time.time() + 30
    while len(eng.board.pending()) < len(prompts):
        assert time.time() < deadline
        time.sleep(0.001)
    eng.start()
    for t in ts:
        t.join()
    eng.stop()
    return results


def test_serving_with_real_model_matches_reference(model):
    rcfg, tree, params = model
    cfg = ARCHS[CFG_NAME].smoke()
    B, max_len, T = 4, 24, 4
    prompts = {c: list(range(c + 1, 2 * c + 4)) for c in range(4)}  # ragged
    eng = build_server(cfg, params, batch=B, max_len=max_len, device="cpu")
    ours = _serve(eng, prompts, T)
    assert eng.stats["prefill_rounds"] == 1 and eng.stats["persists"] >= 1
    assert len(eng.step_times["decode"]) == eng.stats["decode_rounds"]
    pf, dc = _ref_adapter(rcfg, tree, B, max_len)
    ref_eng = RefEngine(B, prefill_batch_fn=pf, decode_batch_fn=dc,
                        n_kv_slots=B, max_batch=B, eos_token=-1)
    theirs = _serve(ref_eng, prompts, T)
    assert len(ours) == 4
    for c in prompts:
        assert len(ours[c]["tokens"]) == T
        assert all(0 <= t < cfg.padded_vocab for t in ours[c]["tokens"])
    assert ours == theirs
    # the completed requests answer from the durable response log
    eng.restart_after_crash()
    assert eng.recover_request(0, prompts[0], T, seq=1, timeout=5) == ours[0]


def test_adapter_keeps_the_reference_quirk_across_prefill_rounds(model):
    """A second prefill round replaces the one shared state, so the
    first round's sequence decodes against the new cache at the shared
    position: the port keeps that behaviour exactly (ROADMAP.md,
    "Faults")."""
    rcfg, tree, params = model
    cfg = ARCHS[CFG_NAME].smoke()
    eng = build_server(cfg, params, batch=4, max_len=24, device="cpu")
    ours = (eng.prefill_batch_fn, eng.decode_batch_fn)
    theirs = _ref_adapter(rcfg, tree, 4, 24)
    outs = []
    for pf, dc in (ours, theirs):
        first, kv = pf([[5, 6, 7]])
        a = dc(kv, first)
        second, kv2 = pf([[9, 10, 11, 12, 13]])
        b = dc(kv + kv2, [a[0], second[0]])
        c = dc(kv + kv2, b)
        outs.append((first, a, second, b, c))
    assert outs[0] == outs[1]


def test_launcher_main_serves_on_the_cpu(capsys):
    done = serve.main(["--arch", CFG_NAME, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-tokens", "3",
                       "--batch", "4"])
    assert sorted(done) == [0, 1, 2]
    assert all(len(r["tokens"]) == 3 for r in done.values())
    assert "on cpu" in capsys.readouterr().out


def test_launcher_refuses_to_run_quietly_on_the_cpu(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, params = model
    cfg = ARCHS[CFG_NAME].smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(cfg, params, batch=4, max_len=24)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", CFG_NAME, "--smoke", "--requests", "1"])
