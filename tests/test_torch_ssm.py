"""The port's SSM family on the CPU: ``ssd_scan``'s plain version held
against the JAX Pallas kernel (interpret mode) and the reference's
sequential oracle, the wrapper's dispatch, the Mamba2 mixer and the
mamba2 model held against ``repro.models``, and mamba2 served through the
port's engine against the reference launcher's adapter.

Inputs are drawn with numpy from a seed and handed bit-identical to both
packages.  Tolerances, atol = rtol:
  * 2e-4 for the f32 plain scan against the f32 Pallas kernel: the same
    chunked algorithm summed in another order, outputs up to ~25;
  * 2e-3 against ``ref.ssd_ref`` and between chunk sizes, as in
    ``tests/test_kernels.py``: the sequential recurrence rounds at every
    step, the chunked one once per chunk;
  * 2e-2 for bf16 outputs of the scan (bf16 keeps ~3 significant digits);
  * 1e-4 for f32 logits and mixer outputs (the packages differ only in
    summation order);
  * 5e-2 for the mixer in bf16: the reference's silu and conv round each
    op to bf16 where torch rounds once, so conv outputs differ by a bf16
    ulp, which reaches the f32 state and the bf16 output.
The CUDA kernel runs only on the card: the ``gpu`` test at the end, and
``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS as REF_ARCHS
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import ssm as ref_ssm
from repro.serving.engine import CombiningEngine as RefEngine
from repro_torch.configs import ARCHS
from repro_torch.kernels import ssd_scan, ssd_scan_plain
from repro_torch.launch import serve
from repro_torch.launch.serve import build_server
from repro_torch.models import (SSMState, decode_step, forward,
                                init_decode_state, init_params,
                                params_from_reference, prefill)
from repro_torch.models import ssm
from test_torch_serving import _ref_adapter, _serve

torch.set_num_threads(2)
ARCH = "mamba2-2.7b"
KEY = jax.random.PRNGKey(0)
PALLAS_TOL = dict(atol=2e-4, rtol=2e-4)
SEQ_TOL = dict(atol=2e-3, rtol=2e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
MIXER_BF16_TOL = dict(atol=5e-2, rtol=5e-2)
SSD_TOL = dict(atol=1e-3, rtol=1e-3)   # chip_smoke.py's, for f32 outputs


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _scan_inputs(seed, B, L, H, P, N, dtype="float32"):
    """(jax arrays, torch tensors) of the same values: x, dt, A, Bm, Cm
    with the distributions of ``tests/test_kernels.py::_ssd_inputs``."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((B, L, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H))))
    A = -np.exp(0.3 * rng.standard_normal(H))
    Bm = 0.5 * rng.standard_normal((B, L, N))
    Cm = 0.5 * rng.standard_normal((B, L, N))
    jx, tx = [], []
    for a, cast in ((x, True), (dt, False), (A, False), (Bm, True),
                    (Cm, True)):
        t = torch.from_numpy(a.astype(np.float32))
        if cast and dtype == "bfloat16":
            t = t.to(torch.bfloat16)
            jx.append(jnp.asarray(t.view(torch.int16).numpy()
                                  .view(np.uint16).view(jnp.bfloat16)))
        else:
            jx.append(jnp.asarray(t.numpy()))
        tx.append(t)
    return jx, tx


# ------------------------------------------------------------------ #
# ssd_scan: the plain version against the Pallas kernel and ssd_ref
# ------------------------------------------------------------------ #
SWEEP = [(1, 128, 2, 64, 32, 64), (2, 256, 4, 64, 64, 128),
         (1, 256, 1, 32, 128, 64), (2, 64, 2, 16, 16, 32)]


@pytest.mark.parametrize("B,L,H,P,N,chunk", SWEEP)
def test_ssd_plain_matches_pallas(B, L, H, P, N, chunk):
    jx, tx = _scan_inputs(0, B, L, H, P, N)
    want = pallas_ssd(*jx, chunk=chunk, interpret=True)
    y, state = ssd_scan_plain(*tx, chunk=chunk)
    assert y.dtype == torch.float32 and state.shape == (B, H, P, N)
    _close(y, want, PALLAS_TOL)


def test_ssd_plain_matches_pallas_bf16():
    """The Pallas kernel writes y in x's dtype; so does the plain version
    by default."""
    jx, tx = _scan_inputs(1, 1, 128, 2, 32, 32, "bfloat16")
    want = pallas_ssd(*jx, chunk=64, interpret=True)
    y, _ = ssd_scan_plain(*tx, chunk=64)
    assert y.dtype == torch.bfloat16
    _close(y, want, BF16_TOL)


@pytest.mark.parametrize("L,chunk", [(256, 64), (300, 128), (100, 128),
                                     (2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_sequential_ref(L, chunk, dtype):
    """y and the final state against the token-by-token recurrence,
    including lengths that are no multiple of the chunk (the Pallas
    kernel asserts divisibility; the port pads with dt = 0)."""
    jx, tx = _scan_inputs(2, 2, L, 3, 32, 32, dtype)
    y_ref, s_ref = ref.ssd_ref(*jx)
    y, state = ssd_scan_plain(*tx, chunk=chunk, out_dtype=torch.float32)
    assert y.shape == (2, L, 3, 32) and state.dtype == torch.float32
    # ssd_ref rounds y to x's dtype; compare in f32 when it did not
    _close(y, y_ref, SEQ_TOL if dtype == "float32" else BF16_TOL)
    _close(state, s_ref, SEQ_TOL)


def test_ssd_plain_matches_the_models_chunked_ref():
    """The port's scan returns what ``ssd_chunked_ref`` returns beside
    y: the final state, at a length that divides the chunk."""
    jx, tx = _scan_inputs(3, 2, 256, 2, 32, 32)
    y_ref, s_ref = ref_ssm.ssd_chunked_ref(*jx, 64)
    y, state = ssd_scan_plain(*tx, chunk=64)
    _close(y, y_ref, F32_TOL)
    _close(state, s_ref, F32_TOL)


def test_ssd_chunk_independence():
    _, tx = _scan_inputs(4, 1, 300, 2, 32, 32)
    y0, s0 = ssd_scan_plain(*tx, chunk=64)
    for chunk in (32, 128, 256, 512):
        y, s = ssd_scan_plain(*tx, chunk=chunk)
        np.testing.assert_allclose(_np(y), _np(y0), **SEQ_TOL)
        np.testing.assert_allclose(_np(s), _np(s0), **SEQ_TOL)


def test_ssd_masks_before_the_exp():
    """A large decay overflows exp above the diagonal; masking there
    before the exp keeps y finite (a 0/1 mask after it gives inf * 0)."""
    _, (x, dt, A, Bm, Cm) = _scan_inputs(5, 1, 128, 2, 16, 16)
    y, state = ssd_scan_plain(x, dt * 50.0, A * 10.0, Bm, Cm)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()


# ------------------------------------------------------------------ #
# ssd_scan's bf16 tensor-core arithmetic, emulated on the CPU
# ------------------------------------------------------------------ #
def _split_bf16(t):
    """t as a bf16 high part and the bf16 rounding of what it leaves."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _ssd_tensor_core_emulation(x, dt, A, Bm, Cm, *, chunk=128,
                               out_dtype=torch.float32):
    """The rounding of ``csrc/ssd_scan.cu``'s bf16 path in plain PyTorch:
    G = C B^T once per (sequence, chunk) from the bf16 operands and shared
    by every head; each other product keeps its exact bf16 side (x, C or
    B) and splits its f32 side (G exp(cs_i - cs_j) dt_j, the carried
    state, x dt_j exp(cs_end - cs_j)) into bf16 high and low parts; sums
    in f32; steps past L read as dt = 0."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-L // chunk)
    pad = nc * chunk - L
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, chunk, H, P)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(Bsz, nc, chunk, H)
    Bc = F.pad(Bm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, chunk, N)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, chunk, N)
    G = torch.einsum("bzin,bzjn->bzij", Cc, Bc)          # once per (b, chunk)
    cs = torch.cumsum(dtf * A.float(), dim=2)            # [B, nc, cl, H]
    lower = torch.ones(chunk, chunk, dtype=torch.bool).tril()[None, :, :, None]
    s = torch.zeros(Bsz, H, P, N)
    ys = []
    for z in range(nc):
        csz = cs[:, z]
        seg = (csz[:, :, None, :] - csz[:, None, :, :]).masked_fill(
            ~lower, float("-inf"))
        m_hi, m_lo = _split_bf16(G[:, z, :, :, None] * torch.exp(seg)
                                 * dtf[:, z, None, :, :])  # [B, i, j, H]
        y = (torch.einsum("bijh,bjhp->bihp", m_hi, xf[:, z])
             + torch.einsum("bijh,bjhp->bihp", m_lo, xf[:, z]))
        s_hi, s_lo = _split_bf16(s)
        y_inter = (torch.einsum("bin,bhpn->bihp", Cc[:, z], s_hi)
                   + torch.einsum("bin,bhpn->bihp", Cc[:, z], s_lo))
        ys.append(y + y_inter * torch.exp(csz)[..., None])
        cs_end = csz[:, -1]                               # [B, H]
        w = dtf[:, z] * torch.exp(cs_end[:, None] - csz)  # [B, cl, H]
        x_hi, x_lo = _split_bf16(xf[:, z] * w[..., None])
        s = (s * torch.exp(cs_end)[..., None, None]
             + torch.einsum("bjhp,bjn->bhpn", x_hi, Bc[:, z])
             + torch.einsum("bjhp,bjn->bhpn", x_lo, Bc[:, z]))
    y = torch.stack(ys, 1).reshape(Bsz, nc * chunk, H, P)[:, :L]
    return y.to(out_dtype), s


@pytest.mark.parametrize("L,chunk", [(256, 128), (300, 128), (100, 128),
                                     (448, 64), (200, 256)])
def test_ssd_tensor_core_rounding_holds_the_tolerance(L, chunk):
    """C B^T shared across heads and the bf16 hi/lo splits keep the bf16
    kernel's f32 y and state within SSD_TOL of the plain version and of
    the JAX sequential oracle (fed the same bf16 values in f32, so that it
    returns f32), at the (P, N) the kernel is built for, with the
    distributions chip_smoke.py uses, ragged L included."""
    _, tx = _scan_inputs(10, 2, L, 3, 64, 128, "bfloat16")
    y, s = _ssd_tensor_core_emulation(*tx, chunk=chunk)
    y0, s0 = ssd_scan_plain(*tx, chunk=chunk, out_dtype=torch.float32)
    torch.testing.assert_close(y, y0, **SSD_TOL)
    torch.testing.assert_close(s, s0, **SSD_TOL)
    y_ref, s_ref = ref.ssd_ref(*[jnp.asarray(t.float().numpy()) for t in tx])
    _close(y, y_ref, SSD_TOL)
    _close(s, s_ref, SSD_TOL)


def test_ssd_tensor_core_rounding_matches_pallas():
    jx, tx = _scan_inputs(11, 1, 256, 2, 64, 128, "bfloat16")
    want = pallas_ssd(*[j.astype(jnp.float32) for j in jx], chunk=128,
                      interpret=True)
    y, _ = _ssd_tensor_core_emulation(*tx, chunk=128)
    _close(y, want, SSD_TOL)


def test_ssd_tensor_core_split_beats_bf16_alone():
    """Why the f32 side is split: rounded once to bf16 (8 bits) it misses
    SSD_TOL; high plus low parts (~16 bits) hold it."""
    rng = np.random.default_rng(12)
    t = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    b = b.to(torch.bfloat16).float()                      # the exact side
    hi, lo = _split_bf16(t)
    b = b.double()                      # products summed exactly: only
    exact = t.double() @ b              # the operands' rounding counts
    bound = SSD_TOL["atol"] + SSD_TOL["rtol"] * exact.abs()
    assert ((hi.double() @ b - exact).abs() > bound).any()
    assert ((hi.double() @ b + lo.double() @ b - exact).abs() < bound / 10).all()


def test_ssd_wrapper_on_cpu_is_the_plain_version():
    _, tx = _scan_inputs(6, 2, 150, 2, 64, 128, "bfloat16")
    before = ssd_scan.launches
    y, s = ssd_scan(*tx, out_dtype=torch.float32)
    y0, s0 = ssd_scan_plain(*tx, out_dtype=torch.float32)
    assert torch.equal(y, y0) and torch.equal(s, s0)
    assert ssd_scan.launches == before     # the plain version is no launch


def test_ssd_wrapper_refuses_non_cpu_tensors_without_a_card():
    """A tensor that is not on the CPU never reaches the plain version:
    with no card to launch on, the wrapper raises."""
    _, (x, dt, A, Bm, Cm) = _scan_inputs(7, 1, 64, 2, 64, 128)
    meta = [t.to("meta") for t in (x, dt, A, Bm, Cm)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(meta[0], dt, A, Bm, Cm)


# ------------------------------------------------------------------ #
# the Mamba2 mixer against repro.models.ssm
# ------------------------------------------------------------------ #
def _ref_tree(cfg, seed=0, dtype=jnp.float32):
    """Reference params as numpy; zero leaves (norms, biases, A_log,
    dt_bias) get noise so that their paths carry signal."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_prefill_and_decode_match_reference(dtype):
    rcfg = REF_ARCHS[ARCH].smoke()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else MIXER_BF16_TOL
    layer = jax.tree.map(lambda a: a[0],
                         _ref_tree(rcfg, dtype=jdt)["blocks"]["ssm"])
    params = params_from_reference(layer, device="cpu")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 150, rcfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x).to(tdt)
    r_out, r_st = ref_ssm.ssm_block_prefill(layer, jnp.asarray(xt.float()
                                                              .numpy(), jdt),
                                            rcfg)
    out, st = ssm.ssm_block_prefill(params, xt, rcfg)
    assert out.dtype == tdt and st.ssm.dtype == torch.float32
    _close(out, r_out, tol)
    for name, got, want in zip(SSMState._fields, st, r_st):
        assert got.dtype == getattr(torch, str(want.dtype)), name
        _close(got, want, tol)
    for step in range(2):
        x1 = torch.from_numpy(rng.standard_normal(
            (2, 1, rcfg.d_model)).astype(np.float32)).to(tdt)
        r_out, r_st = ref_ssm.ssm_block_decode(
            layer, jnp.asarray(x1.float().numpy(), jdt), rcfg, r_st)
        out, st2 = ssm.ssm_block_decode(params, x1, rcfg, st)
        assert st2 is st                       # updated in place
        _close(out, r_out, tol)
        for got, want in zip(st, r_st):
            _close(got, want, tol)


def test_mixer_train_matches_reference():
    rcfg = REF_ARCHS[ARCH].smoke()
    layer = jax.tree.map(lambda a: a[0], _ref_tree(rcfg)["blocks"]["ssm"])
    params = params_from_reference(layer, device="cpu")
    x = np.random.default_rng(9).standard_normal(
        (2, 40, rcfg.d_model)).astype(np.float32)
    want = ref_ssm.ssm_block_train(layer, jnp.asarray(x), rcfg)
    _close(ssm.ssm_block_train(params, torch.from_numpy(x), rcfg), want,
           F32_TOL)


# ------------------------------------------------------------------ #
# the mamba2 model against repro.models
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def smoke_model():
    rcfg = REF_ARCHS[ARCH].smoke()
    tree = _ref_tree(rcfg)
    return rcfg, ARCHS[ARCH].smoke(), tree, \
        params_from_reference(tree, device="cpu")


@pytest.mark.parametrize("P", [21, 160])
def test_forward_prefill_decode_match_reference(smoke_model, P):
    """A 160-token prompt is one chunk of 160 in the reference (160 is
    no multiple of 128) and a chunk of 128 plus a masked tail in the
    port; logits agree all the same."""
    rcfg, cfg, tree, params = smoke_model
    B, T = 2, P + 3
    toks = _tokens(cfg, (B, T))
    want = np.asarray(ref_forward(tree, rcfg, jnp.asarray(toks)))
    got = forward(params, cfg, toks, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (B, T, cfg.padded_vocab)
    _close(got, want, F32_TOL)

    rl, rst = ref_prefill(tree, rcfg, jnp.asarray(toks[:, :P]), {})
    pl, pst = prefill(params, cfg, toks[:, :P], device="cpu")
    _close(pl, rl, F32_TOL)
    assert pst.kv is None and pst.pos == int(rst.pos) == P
    for got_s, want_s in zip(pst.ssm, rst.ssm):
        assert got_s.shape == want_s.shape
        _close(got_s, want_s, F32_TOL)
    for t in range(P, T):
        rl, rst = ref_decode_step(tree, rcfg, rst, jnp.asarray(toks[:, t]))
        pl, pst = decode_step(params, cfg, pst, toks[:, t], device="cpu")
        _close(pl, rl, F32_TOL)
        # teacher-forced decode continues the full forward pass
        _close(pl, want[:, t], F32_TOL)
    assert pst.pos == int(rst.pos) == T
    for got_s, want_s in zip(pst.ssm, rst.ssm):
        _close(got_s, want_s, F32_TOL)


def test_short_prompt_decodes_like_the_full_forward(smoke_model):
    """A prompt shorter than ssm_conv_width - 1 leaves the reference a
    conv window too short for its decode, which raises; the port
    front-fills the window with the zeros of the conv's own padding, so
    its decode equals the reference's forward over the same tokens."""
    rcfg, cfg, tree, params = smoke_model
    toks = _tokens(cfg, (2, 3), seed=4)
    want = np.asarray(ref_forward(tree, rcfg, jnp.asarray(toks)))
    _, rst = ref_prefill(tree, rcfg, jnp.asarray(toks[:, :2]), {})
    with pytest.raises(ValueError, match="does not match"):
        ref_decode_step(tree, rcfg, rst, jnp.asarray(toks[:, 2]))
    for n in (1, 2):
        pl, pst = prefill(params, cfg, toks[:, :n], device="cpu")
        assert pst.ssm.conv_x.shape[2] == cfg.ssm_conv_width - 1
        _close(pl, want[:, n - 1], F32_TOL)
        for t in range(n, 3):
            pl, pst = decode_step(params, cfg, pst, toks[:, t], device="cpu")
            _close(pl, want[:, t], F32_TOL)


def test_decode_from_an_empty_state(smoke_model):
    """``init_decode_state`` gives a zero state at pos 0; decoding the
    prompt token by token matches the full forward pass, and every step
    updates the stacked state in place."""
    _, cfg, _, params = smoke_model
    toks = _tokens(cfg, (2, 12))
    full = _np(forward(params, cfg, toks, device="cpu"))
    st = init_decode_state(cfg, 2, 0, device="cpu", dtype=torch.float32)
    assert st.kv is None and not st.ssm.ssm.any()
    ptr = st.ssm.ssm.data_ptr()
    for t in range(12):
        lg, st = decode_step(params, cfg, st, toks[:, t], device="cpu")
        np.testing.assert_allclose(_np(lg), full[:, t], **F32_TOL)
    assert st.pos == 12 and st.ssm.ssm.data_ptr() == ptr


# ------------------------------------------------------------------ #
# the port's versions of tests/test_models.py checks (bf16 params)
# ------------------------------------------------------------------ #
def test_prefill_then_decode_matches_full_forward():
    cfg = ARCHS[ARCH].smoke()
    params = init_params(cfg, 0, device="cpu")
    T = 16
    tokens = _tokens(cfg, (1, T))
    full = _np(forward(params, cfg, tokens, device="cpu"))
    # bf16 params: agreement at bf16 resolution, as in test_models.py
    tol = dict(atol=1.5e-1, rtol=1.5e-1)
    lg, state = prefill(params, cfg, tokens[:, :T - 2], device="cpu")
    np.testing.assert_allclose(_np(lg), full[:, T - 3], **tol)
    lg, state = decode_step(params, cfg, state, tokens[:, T - 2], device="cpu")
    np.testing.assert_allclose(_np(lg), full[:, T - 2], **tol)
    lg, state = decode_step(params, cfg, state, tokens[:, T - 1], device="cpu")
    np.testing.assert_allclose(_np(lg), full[:, T - 1], **tol)


def test_padded_vocab_never_wins():
    cfg = dataclasses.replace(ARCHS[ARCH].smoke(), vocab_size=250)
    params = init_params(cfg, 0, device="cpu")
    logits = forward(params, cfg, _tokens(cfg, (1, 8)), device="cpu")
    assert logits.shape[-1] == 256
    assert int(logits.argmax(-1).max()) < cfg.vocab_size


def test_params_from_reference_keeps_the_f32_leaves():
    """A bf16 reference tree converts with its f32 leaves (A_log, D,
    dt_bias) still f32 when no dtype is asked for."""
    tree = _ref_tree(REF_ARCHS[ARCH].smoke(), dtype=jnp.bfloat16)
    params = params_from_reference(tree, device="cpu")
    mixer = params["blocks"]["ssm"]
    for name in ("A_log", "D", "dt_bias"):
        assert mixer[name].dtype == torch.float32, name
        np.testing.assert_array_equal(mixer[name].numpy(),
                                      tree["blocks"]["ssm"][name])
    assert mixer["wx"].dtype == torch.bfloat16
    assert params_from_reference(tree, device="cpu", dtype=torch.float32)[
        "blocks"]["ssm"]["wx"].dtype == torch.float32


# ------------------------------------------------------------------ #
# serving mamba2 through the engine
# ------------------------------------------------------------------ #
def test_serving_mamba2_matches_reference(smoke_model):
    rcfg, cfg, tree, params = smoke_model
    B, max_len, T = 4, 24, 4
    prompts = {c: list(range(c + 1, 2 * c + 4)) for c in range(4)}  # ragged
    eng = build_server(cfg, params, batch=B, max_len=max_len, device="cpu")
    before = ssd_scan.launches
    ours = _serve(eng, prompts, T)
    assert ssd_scan.launches == before       # the CPU runs the plain version
    assert eng.stats["prefill_rounds"] == 1 and eng.stats["persists"] >= 1
    pf, dc = _ref_adapter(rcfg, tree, B, max_len)
    ref_eng = RefEngine(B, prefill_batch_fn=pf, decode_batch_fn=dc,
                        n_kv_slots=B, max_batch=B, eos_token=-1)
    theirs = _serve(ref_eng, prompts, T)
    assert len(ours) == 4
    for c in prompts:
        assert len(ours[c]["tokens"]) == T
        assert all(0 <= t < cfg.vocab_size for t in ours[c]["tokens"])
    assert ours == theirs
    # the completed requests answer from the durable response log
    eng.restart_after_crash()
    assert eng.recover_request(0, prompts[0], T, seq=1, timeout=5) == ours[0]


def test_launcher_main_serves_mamba2_on_the_cpu(capsys):
    """The launcher's default prompts are 2 tokens long, shorter than the
    conv window."""
    done = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-tokens", "3",
                       "--batch", "4"])
    assert sorted(done) == [0, 1, 2]
    assert all(len(r["tokens"]) == 3 for r in done.values())
    assert "on cpu" in capsys.readouterr().out


# ------------------------------------------------------------------ #
# on the card
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_cuda_ssd_scan_matches_plain(cuda, dtype, out_dtype):
    """The kernel against its plain version at a ragged length, in the
    chunk sizes the kernel takes.  f32 outputs agree to 1e-3: y is a sum
    of up to ~640 terms of magnitude up to ~50, in another order."""
    tol = 1e-3 if out_dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape, scale=0.5):
        return scale * torch.randn(shape, generator=gen, device=cuda)
    x, Bm, Cm = (randn(2, 300, 8, 64).to(dtype), randn(2, 300, 128).to(dtype),
                 randn(2, 300, 128).to(dtype))
    dt = torch.nn.functional.softplus(randn(2, 300, 8, scale=1.0))
    A = -torch.exp(randn(8, scale=0.3))
    for chunk in (64, 128, 256):
        before = ssd_scan.launches
        y, s = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, out_dtype=out_dtype)
        assert ssd_scan.launches == before + 1
        y0, s0 = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                                out_dtype=out_dtype)
        torch.testing.assert_close(y, y0, atol=tol, rtol=tol)
        torch.testing.assert_close(s, s0, atol=1e-3, rtol=1e-3)
    torch.cuda.synchronize()
