"""The port's dense model held against the JAX reference on the CPU.

Both packages get the same parameters: the reference's ``init_params``
in f32, with its zero-initialised norms and biases filled with numpy
noise so that those paths carry signal, converted leaf for leaf by
``params_from_reference``.  Logits agree to atol = rtol = 1e-4 in f32:
the packages differ only in summation order (logits are O(1), so a few
f32 ulps per reduction stay well below it).  The port's own versions of
four ``tests/test_models.py`` checks run on parameters the port draws
itself, in bf16, with that file's tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import prefill as ref_prefill
from repro_torch.configs import ARCHS, get
from repro_torch.models import (DecodeState, decode_step, forward,
                                init_decode_state, init_params, layer_window,
                                param_count, params_from_reference, prefill)
from repro_torch.models import layers

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
DENSE = ["qwen3-1.7b", "gemma2-9b", "command-r-35b"]


def _ref_tree(cfg, seed=0, dtype=jnp.float32):
    """Reference params as numpy; zero leaves (norms, biases) get noise."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, ref_init_params(cfg, KEY, dtype=dtype))

    def fill(a):
        if a.any():
            return a
        return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return jax.tree.map(fill, tree)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ------------------------------------------------------------------ #
# parameters
# ------------------------------------------------------------------ #
def test_params_from_reference_is_bit_exact_in_bf16():
    cfg = get("qwen3-1.7b").smoke()
    tree = _ref_tree(REF_ARCHS["qwen3-1.7b"].smoke(), dtype=jnp.bfloat16)
    params = params_from_reference(tree, device="cpu")
    ref_flat, port_flat = _flat(tree), _flat(params)
    assert ref_flat.keys() == port_flat.keys()
    for name, a in ref_flat.items():
        t = port_flat[name]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16), err_msg=name)
    assert param_count(params) == sum(a.size for a in ref_flat.values())
    assert cfg.padded_vocab == params["embed"].shape[0]


@pytest.mark.parametrize("arch", DENSE + ["mamba2-2.7b"])
def test_init_params_has_the_reference_layout(arch):
    cfg = ARCHS[arch].smoke()
    shapes = jax.eval_shape(lambda: ref_init_params(REF_ARCHS[arch].smoke(),
                                                    KEY))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(shapes).items()}
    params = init_params(cfg, 0, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in _flat(params).items()}
    assert got == want
    # the reference's distributions: embed N(0, 0.01), projections
    # N(0, 1/fan_in), norms zero; the mixer's f32 leaves A_log = 0,
    # D = 1, dt_bias = 0 stay f32 whatever the dtype
    p32 = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    assert abs(float(p32["embed"].std()) - 0.01) < 1e-3
    blocks = p32["blocks"]
    w = blocks["ssm"]["wx"] if cfg.family == "ssm" else blocks["attn"]["wq"]
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert not blocks["ln1"].any() and not p32["final_norm"].any()
    if cfg.family == "ssm":
        mixer = params["blocks"]["ssm"]
        assert not mixer["A_log"].any() and not mixer["dt_bias"].any()
        assert bool((mixer["D"] == 1).all())
    # a seed makes the same draw; another seed another
    again = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    assert torch.equal(again["embed"], p32["embed"])
    other = init_params(cfg, 1, device="cpu", dtype=torch.float32)
    assert not torch.equal(other["embed"], p32["embed"])


# ------------------------------------------------------------------ #
# layers
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    """rms_norm, rope, swiglu and unembed on the same inputs, each
    returning the input's dtype.  rms_norm rounds where the reference
    rounds, so in bf16 it is bit-exact; the others agree to 1e-2 in bf16
    (sin, cos and the products' sums differ between the two libraries
    by an ulp now and then)."""
    tol = 1e-5 if dtype == "float32" else 1e-2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(0)

    def pair(*shape, scale=1.0):
        a = (scale * rng.standard_normal(shape)).astype(np.float32)
        return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)

    xj, x = pair(2, 6, 4, 16)
    wj, w = pair(16, scale=0.1)
    got = layers.rms_norm(x, w, 1e-6)
    want = np.asarray(ref_layers.rms_norm(xj, wj, 1e-6))
    assert got.dtype == tdt
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    np.testing.assert_allclose(_np(got), want.astype(np.float32),
                               atol=tol, rtol=tol)
    pos = np.arange(6)[None, :].repeat(2, 0) + 5
    hj, h = pair(3, 16)
    gj, g = pair(16, 32, scale=0.25)
    uj, u = pair(16, 32, scale=0.25)
    dj, d = pair(32, 16, scale=0.25)
    tj, t = pair(256, 16)
    for got, want in (
            (layers.apply_rope(x, torch.from_numpy(pos), 1e6),
             ref_layers.apply_rope(xj, jnp.asarray(pos), 1e6)),
            (layers.swiglu(h, g, u, d), ref_layers.swiglu(hj, gj, uj, dj)),
            (layers.unembed(h, t, 30.0, 250),
             ref_layers.unembed(hj, tj, 30.0, 250))):
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    assert float(layers.unembed(h, t, None, 250)[:, 250:].max()) == -2.0 ** 30


def test_layer_window_is_a_host_int_per_layer():
    g = ARCHS["gemma2-9b"]
    assert [layer_window(g, i) for i in range(4)] == [4096, 1 << 30, 4096,
                                                      1 << 30]
    assert layer_window(ARCHS["qwen3-1.7b"], 3) is None
    local = dataclasses.replace(g, local_global_pattern=False)
    assert layer_window(local, 1) == 4096


# ------------------------------------------------------------------ #
# the model against the reference
# ------------------------------------------------------------------ #
def _variants():
    out = [(a, {}) for a in DENSE]
    # biases and an untied unembed: no shipped dense config has them
    out.append(("qwen3-1.7b", {"use_bias": True, "tie_embeddings": False}))
    return out


@pytest.mark.parametrize("arch,changes", _variants(),
                         ids=[a + ("+bias" if c else "") for a, c in _variants()])
def test_forward_prefill_decode_match_reference(arch, changes):
    rcfg = dataclasses.replace(REF_ARCHS[arch].smoke(), **changes)
    cfg = dataclasses.replace(ARCHS[arch].smoke(), **changes)
    tree = _ref_tree(rcfg)
    params = params_from_reference(tree, device="cpu")
    B, T = 2, 24                        # longer than gemma2's smoke window
    toks = _tokens(cfg, (B, T))

    want = np.asarray(ref_forward(tree, rcfg, jnp.asarray(toks)))
    got = forward(params, cfg, toks, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (B, T, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), want, **F32_TOL)

    P = T - 3
    rl, rst = ref_prefill(tree, rcfg, jnp.asarray(toks[:, :P]), {},
                          max_len=T + 1)
    pl, pst = prefill(params, cfg, toks[:, :P], device="cpu", max_len=T + 1)
    np.testing.assert_allclose(_np(pl), np.asarray(rl), **F32_TOL)
    np.testing.assert_allclose(_np(pst.kv.k), np.asarray(rst.kv.k), **F32_TOL)
    assert pst.pos == int(rst.pos) == P
    for t in range(P, T):
        rl, rst = ref_decode_step(tree, rcfg, rst, jnp.asarray(toks[:, t]))
        pl, pst = decode_step(params, cfg, pst, toks[:, t], device="cpu")
        np.testing.assert_allclose(_np(pl), np.asarray(rl), **F32_TOL)
        # teacher-forced decode continues the full forward pass
        np.testing.assert_allclose(_np(pl), want[:, t], **F32_TOL)
    assert pst.pos == int(rst.pos) == T
    np.testing.assert_allclose(_np(pst.kv.v), np.asarray(rst.kv.v), **F32_TOL)


def test_decode_updates_the_cache_in_place_at_pos():
    cfg = ARCHS["qwen3-1.7b"].smoke()
    params = params_from_reference(_ref_tree(REF_ARCHS["qwen3-1.7b"].smoke()),
                                   device="cpu")
    toks = _tokens(cfg, (2, 5))
    _, st = prefill(params, cfg, toks, device="cpu", max_len=8)
    k_before = st.kv.k.clone()
    _, st2 = decode_step(params, cfg, st, toks[:, 0], device="cpu")
    assert isinstance(st2.pos, int) and st2.pos == 6 and st2.kv.length == 6
    assert st2.kv.k.data_ptr() == st.kv.k.data_ptr()      # same storage
    changed = (st2.kv.k != k_before).any(dim=(0, 1, 2, 4))
    assert changed.tolist() == [False] * 5 + [True] + [False] * 2
    with pytest.raises(ValueError, match="past the cache"):
        decode_step(params, cfg, DecodeState(st2.kv, 8), toks[:, 0],
                    device="cpu")


def test_decode_from_an_empty_state():
    """``init_decode_state`` gives a zero cache at pos 0; decoding the
    prompt token by token matches the full forward pass."""
    cfg = ARCHS["gemma2-9b"].smoke()
    params = params_from_reference(_ref_tree(REF_ARCHS["gemma2-9b"].smoke()),
                                   device="cpu")
    toks = _tokens(cfg, (2, 20))
    full = _np(forward(params, cfg, toks, device="cpu"))
    st = init_decode_state(cfg, 2, 20, device="cpu", dtype=torch.float32)
    for t in range(20):
        lg, st = decode_step(params, cfg, st, toks[:, t], device="cpu")
        np.testing.assert_allclose(_np(lg), full[:, t], **F32_TOL)


# ------------------------------------------------------------------ #
# the port's versions of tests/test_models.py checks (bf16 params)
# ------------------------------------------------------------------ #
def test_prefill_then_decode_matches_full_forward():
    cfg = ARCHS["qwen3-1.7b"].smoke()
    params = init_params(cfg, 0, device="cpu")
    T = 16
    tokens = _tokens(cfg, (1, T))
    full = _np(forward(params, cfg, tokens, device="cpu"))
    # bf16 params: agreement at bf16 resolution, as in test_models.py
    tol = dict(atol=1.5e-1, rtol=1.5e-1)
    lg, state = prefill(params, cfg, tokens[:, :T - 2], device="cpu",
                        max_len=T + 2)
    np.testing.assert_allclose(_np(lg), full[:, T - 3], **tol)
    lg, state = decode_step(params, cfg, state, tokens[:, T - 2], device="cpu")
    np.testing.assert_allclose(_np(lg), full[:, T - 2], **tol)
    lg, state = decode_step(params, cfg, state, tokens[:, T - 1], device="cpu")
    np.testing.assert_allclose(_np(lg), full[:, T - 1], **tol)


def test_gemma2_local_global_alternation():
    cfg = ARCHS["gemma2-9b"].smoke()
    cfg_local = dataclasses.replace(cfg, local_global_pattern=False,
                                    sliding_window=4, n_layers=2)
    params = init_params(cfg_local, 0, device="cpu")
    T = 24
    tokens = _tokens(cfg_local, (1, T))
    out_full = forward(params, cfg_local, tokens, device="cpu")
    tokens2 = tokens.copy()
    tokens2[0, :4] = (tokens[0, :4] + 1) % cfg_local.vocab_size
    out_pert = forward(params, cfg_local, tokens2, device="cpu")
    np.testing.assert_allclose(_np(out_full[0, -1]), _np(out_pert[0, -1]),
                               atol=1e-3, rtol=1e-3)
    # and the perturbation does reach a position inside its window
    assert not torch.equal(out_full[0, 4], out_pert[0, 4])


def test_logit_softcap_bounds_logits():
    cfg = ARCHS["gemma2-9b"].smoke()
    params = init_params(cfg, 0, device="cpu")
    logits = forward(params, cfg, _tokens(cfg, (1, 8)), device="cpu").float()
    real = logits[..., :cfg.vocab_size]
    assert float(real.abs().max()) <= cfg.logit_softcap + 1e-3


def test_padded_vocab_never_wins():
    cfg = dataclasses.replace(ARCHS["qwen3-1.7b"].smoke(), vocab_size=250)
    params = init_params(cfg, 0, device="cpu")
    logits = forward(params, cfg, _tokens(cfg, (1, 8)), device="cpu")
    assert logits.shape[-1] == 256
    assert int(logits.argmax(-1).max()) < cfg.vocab_size


# ------------------------------------------------------------------ #
# what the ported slices refuse
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("family", ["moe", "hybrid", "vlm", "audio"])
def test_other_families_are_not_ported_yet(family):
    cfg = dataclasses.replace(ARCHS["qwen3-1.7b"].smoke(), family=family)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        forward({}, cfg, [[1]], device="cpu")


def test_entry_points_refuse_to_run_quietly_on_the_cpu():
    """The default device is the card: with none, every entry point
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = ARCHS["qwen3-1.7b"].smoke()
    params = init_params(cfg, 0, device="cpu")
    toks = [[1, 2, 3]]
    calls = [
        lambda: init_params(cfg, 0),
        lambda: forward(params, cfg, toks),
        lambda: prefill(params, cfg, toks),
        lambda: init_decode_state(cfg, 1, 8),
        lambda: params_from_reference({"w": np.zeros(2, np.float32)}),
    ]
    _, st = prefill(params, cfg, toks, device="cpu", max_len=4)
    calls.append(lambda: decode_step(params, cfg, st, [1]))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
