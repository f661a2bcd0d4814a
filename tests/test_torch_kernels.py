"""The port's attention kernels on the CPU: their plain PyTorch versions
held against the JAX Pallas kernels (interpret mode) and the reference's
oracles, the wrappers' dispatch, and the C interface and instantiated
shapes of every CUDA source (``ssd_scan``'s plain version and dispatch are
tested in ``test_torch_ssm.py``).

Inputs are drawn with numpy from a seed and handed bit-identical to both
packages.  Tolerances are those of ``tests/test_kernels.py``: 2e-5 for
f32 flash attention and 3e-5 for f32 decode (the two sides sum in another
order), 2e-2 for bf16 (the outputs round to bf16, ~3 significant digits).
The CUDA kernels themselves run only on the card: the ``gpu`` test at the
end, and ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.attention import _sdpa
from repro_torch.configs import ARCHS
from repro_torch.kernels import (_build, decode_attention,
                                 decode_attention_plain, flash_attention,
                                 flash_attention_plain)
from repro_torch.kernels.decode_attention import GROUPS
from repro_torch.kernels.flash_attention import (HEAD_DIMS, NEG_INF,
                                                 check_layout)
from repro_torch.kernels.ssd_scan import SHAPES as SSD_SHAPES

torch.set_num_threads(2)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_F32_TOL = 3e-5
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _pair(rng, shape, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 bits
    identical: rounded once in torch, handed to JAX as raw words)."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
        words = t.view(torch.int16).numpy().view(np.uint16)
        return jnp.asarray(words.view(jnp.bfloat16)), t
    return jnp.asarray(t.numpy()), t


def _qkv(seed, B, H, Hkv, Sq, Sk, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    return (_pair(rng, (B, H, Sq, d), dtype), _pair(rng, (B, Hkv, Sk, d), dtype),
            _pair(rng, (B, Hkv, Sk, d), dtype))


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


# ------------------------------------------------------------------ #
# flash_attention
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("B,H,Hkv,S,d", [
    (1, 1, 1, 128, 64),
    (2, 4, 2, 256, 64),     # GQA
    (1, 8, 1, 256, 128),    # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_causal(B, H, Hkv, S, d, dtype):
    (qj, q), (kj, k), (vj, v) = _qkv(0, B, H, Hkv, S, S, d, dtype)
    want = pallas_flash(qj, kj, vj, causal=True, interpret=True)
    got = flash_attention_plain(q, k, v, causal=True)
    assert got.dtype == q.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("window,softcap", [(64, None), (128, 50.0)])
def test_flash_plain_matches_pallas_window_softcap(window, softcap):
    (qj, q), (kj, k), (vj, v) = _qkv(1, 2, 4, 2, 256, 256, 64)
    want = pallas_flash(qj, kj, vj, causal=True, window=window,
                        softcap=softcap, interpret=True)
    _close(flash_attention_plain(q, k, v, causal=True, window=window,
                                 softcap=softcap), want, TOL["float32"])


def test_flash_plain_matches_pallas_noncausal():
    (qj, q), (kj, k), (vj, v) = _qkv(2, 1, 2, 2, 128, 128, 64)
    want = pallas_flash(qj, kj, vj, causal=False, interpret=True)
    _close(flash_attention_plain(q, k, v, causal=False), want, TOL["float32"])


@pytest.mark.parametrize("Sq,Sk,kw", [
    (200, 200, {}),                                 # ragged, Sq == Sk
    (70, 200, {}),                                  # Sq < Sk, right-aligned
    (130, 70, {}),                                  # Sq > Sk: masked rows
    (200, 200, {"window": 64, "softcap": 50.0}),
    (90, 90, {"causal": False, "window": 32}),      # window without causal
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_ref_ragged(Sq, Sk, kw, dtype):
    """Lengths the Pallas kernel's divisibility assert refuses, held
    against ``ref.attention_ref``."""
    (qj, q), (kj, k), (vj, v) = _qkv(3, 2, 4, 2, Sq, Sk, 64, dtype)
    want = ref.attention_ref(qj, kj, vj, **kw)
    got = flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(got.float()).all()
    _close(got, want, TOL[dtype])


# ------------------------------------------------------------------ #
# flash_attention's bf16 tensor-core arithmetic, emulated on the CPU
# ------------------------------------------------------------------ #
def _flash_tensor_core_emulation(q, k, v, *, causal=True, window=None,
                                 softcap=None, scale=None):
    """The rounding of ``csrc/flash_attention.cu``'s bf16 path in plain
    PyTorch: logits in f32 from the bf16 operands, an online softmax over
    kv tiles of 64 keys (32 at d = 256) walked from each 64-row q tile's
    first visible tile to its causal end, P rounded to bf16 before P V
    (the row sum takes P unrounded), -2**30 for masked keys, -inf past Sk
    and the l == 0 guard."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    bq, bk = 64, 64 if d <= 128 else 32
    scale = scale if scale is not None else d ** -0.5
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    off = Sk - Sq
    out = torch.zeros(B, H, Sq, d)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        qpos = torch.arange(q0, q1)[:, None] + off
        begin, end = 0, Sk
        if not (causal and q0 + off < 0):
            if causal:
                end = min(Sk, q1 - 1 + off + 1)
            if window is not None:
                begin = max(0, q0 + off - window + 1)
        begin = begin // bk * bk
        m = torch.full((B, H, q1 - q0, 1), NEG_INF)
        l = torch.zeros(B, H, q1 - q0, 1)
        acc = torch.zeros(B, H, q1 - q0, d)
        for kt in range(begin, end, bk):
            kpos = torch.arange(kt, kt + bk)[None, :]
            ks = kf[:, :, kt:kt + bk]
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, q0:q1].float(), ks)
            s = F.pad(s * scale, (0, bk - ks.shape[2]))
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            keep = torch.ones_like(kpos + qpos, dtype=torch.bool)
            if causal:
                keep &= qpos >= kpos
            if window is not None:
                keep &= qpos < kpos + window
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
            s = torch.where(kpos >= Sk, torch.full_like(s, -torch.inf), s)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            vs = F.pad(vf[:, :, kt:kt + bk], (0, 0, 0, bk - ks.shape[2]))
            acc = acc * alpha + p.to(torch.bfloat16).float() @ vs
            m = m_new
        out[:, :, q0:q1] = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(q.dtype)


@pytest.mark.parametrize("Sq,Sk,d,kw", [
    (200, 200, 128, {}),                                 # ragged
    (70, 200, 128, {}),                                  # Sq < Sk
    (130, 70, 128, {}),                                  # Sq > Sk: masked rows
    (200, 200, 128, {"window": 64, "softcap": 50.0}),
    (90, 90, 128, {"causal": False, "window": 32}),
    (150, 150, 256, {"window": 64, "softcap": 50.0}),
])
def test_flash_tensor_core_rounding_holds_the_tolerance(Sq, Sk, d, kw):
    """P rounded to bf16 before P V keeps the bf16 kernel within TOL of
    the JAX reference and of the plain version, at the inputs and
    tolerance chip_smoke.py holds the kernel to."""
    (qj, q), (kj, k), (vj, v) = _qkv(8, 1, 4, 2, Sq, Sk, d, "bfloat16")
    got = _flash_tensor_core_emulation(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    tol = TOL["bfloat16"]
    _close(got, ref.attention_ref(qj, kj, vj, **kw), tol)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, **kw),
                               atol=tol, rtol=tol)


def test_flash_tensor_core_rounding_matches_pallas():
    (qj, q), (kj, k), (vj, v) = _qkv(9, 2, 4, 2, 256, 256, 128, "bfloat16")
    want = pallas_flash(qj, kj, vj, causal=True, interpret=True)
    _close(_flash_tensor_core_emulation(q, k, v), want, TOL["bfloat16"])


def test_flash_wrapper_on_cpu_is_the_plain_version():
    (_, q), (_, k), (_, v) = _qkv(4, 1, 4, 2, 48, 48, 64)
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=16, softcap=30.0)
    assert torch.equal(got, flash_attention_plain(q, k, v, window=16,
                                                  softcap=30.0))
    assert flash_attention.launches == before    # the plain version is no launch


# ------------------------------------------------------------------ #
# decode_attention
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("B,H,Hkv,S,hd,block,kv_len", [
    (2, 8, 2, 1024, 64, 256, 614),
    (1, 4, 4, 512, 128, 128, 512),     # MHA (G = 1)
    (2, 8, 1, 256, 64, 64, 153),       # MQA
])
def test_decode_plain_matches_pallas(B, H, Hkv, S, hd, block, kv_len):
    rng = np.random.default_rng(5)
    qj, q = _pair(rng, (B, H, hd), "float32")
    kj, k = _pair(rng, (B, Hkv, S, hd), "float32")
    vj, v = _pair(rng, (B, Hkv, S, hd), "float32")
    want = pallas_decode(qj, kj, vj, kv_len, block_s=block, interpret=True)
    _close(decode_attention_plain(q, k, v, kv_len), want, DECODE_F32_TOL)


def test_decode_plain_matches_pallas_bf16():
    rng = np.random.default_rng(6)
    qj, q = _pair(rng, (2, 8, 64), "bfloat16")
    kj, k = _pair(rng, (2, 4, 256, 64), "bfloat16")
    vj, v = _pair(rng, (2, 4, 256, 64), "bfloat16")
    want = pallas_decode(qj, kj, vj, 100, block_s=128, interpret=True)
    got = decode_attention_plain(q, k, v, 100)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bfloat16"])


@pytest.mark.parametrize("kv_len,window,softcap", [
    (1, None, None),
    (37, 16, None),
    (100, None, 50.0),
    (128, 1 << 30, 50.0),      # a gemma2 global layer's window
    (90, 24, 30.0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_model_sdpa(kv_len, window, softcap, dtype):
    """The model decode path's masking (window and softcap on top of the
    Pallas kernel's) held against the reference's ``_sdpa`` on the
    heads-major cache, with the query at position ``kv_len - 1``."""
    rng = np.random.default_rng(kv_len)
    B, H, Hkv, S, hd = 2, 8, 4, 128, 32
    qj, q = _pair(rng, (B, 1, H, hd), dtype)
    kj, k = _pair(rng, (B, Hkv, S, hd), dtype)
    vj, v = _pair(rng, (B, Hkv, S, hd), dtype)
    want = _sdpa(qj, kj, vj, scale=hd ** -0.5, causal_offset=kv_len - 1,
                 window=window, attn_softcap=softcap, kv_len=kv_len,
                 kv_heads_major=True)[:, 0]
    got = decode_attention_plain(q[:, 0].contiguous(), k, v, kv_len,
                                 window=window, softcap=softcap)
    tol = DECODE_F32_TOL if dtype == "float32" else TOL[dtype]
    _close(got, want, tol)


def test_decode_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 64, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 64, 64)).astype(np.float32))
    before = decode_attention.launches
    got = decode_attention(q, k, v, 40, window=8)
    assert torch.equal(got, decode_attention_plain(q, k, v, 40, window=8))
    assert decode_attention.launches == before


# ------------------------------------------------------------------ #
# no fallback: a tensor off the CPU launches the kernel or raises
# ------------------------------------------------------------------ #
def test_wrappers_refuse_non_cpu_tensors_without_a_card():
    """A tensor that is not on the CPU never reaches the plain version:
    with no card to launch on, the wrappers raise."""
    q = torch.empty((1, 2, 8, 64), device="meta")
    k = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q[:, :, 0], k, k, 4)
    mixed = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(mixed, k, k)


def test_layout_check_refuses_misaligned_and_strided_views():
    """The kernels move 16 bytes at a time: a contiguous view that starts
    4 bytes past a boundary, or a strided view, is refused before launch."""
    base = torch.zeros(1 + 2 * 4 * 8 * 128)
    odd = base[1:].view(2, 4, 8, 128)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        check_layout("flash_attention", torch.zeros(2, 4, 8, 128), odd)
    with pytest.raises(ValueError, match="contiguous"):
        check_layout("decode_attention",
                     torch.zeros(2, 8, 4, 128).transpose(1, 2))
    check_layout("flash_attention", torch.zeros(2, 4, 8, 128), base[4:])


# ------------------------------------------------------------------ #
# the C interface: ctypes signatures agree with the extern "C" entries
# ------------------------------------------------------------------ #
_CTYPE = {"void*": "c_void_p", "const void*": "c_void_p", "int": "c_int",
          "float": "c_float"}


def _c_entries():
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [" ".join(p.split()[:-1]) for p in m.group(2).split(",")]
            out[m.group(1)] = [_CTYPE[p] for p in params]
    return out


def _body(src: str, head: str) -> str:
    """The brace-balanced body that follows the first ``head`` in src."""
    i = src.index("{", src.index(head))
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i:j + 1]
    raise AssertionError(f"unbalanced body after {head!r}")


def test_ctypes_signatures_match_the_cuda_sources():
    entries = _c_entries()
    assert set(entries) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert [t.__name__ for t in argtypes] == entries[name], name


def test_cuda_dispatch_covers_the_dense_configs():
    """The .cu switches instantiate exactly the head dims and group sizes
    the wrappers accept, and those cover every ported dense config."""
    flash = (CSRC / "flash_attention.cu").read_text()
    decode = (CSRC / "decode_attention.cu").read_text()
    dims = {int(x) for x in re.findall(r"launch_flash<T, (\d+)>", flash)}
    assert dims == set(HEAD_DIMS)
    # bf16 goes to the tensor-core kernel, tiled for every head dim; f32
    # keeps the FMA body
    assert {int(x) for x in re.findall(r"struct FlashMma<(\d+)>",
                                       flash)} == set(HEAD_DIMS)
    launch = _body(flash, "cudaError_t launch_flash(")
    bf16, f32 = launch.split("} else {")
    assert "is_same_v<T, __nv_bfloat16>" in bf16
    assert "flash_fwd_mma_kernel<D>" in bf16 and "flash_fwd_kernel<T, D>" in f32
    mma = _body(flash, "flash_fwd_mma_kernel(")
    assert "wgmma_qk<BK>(" in mma and "wgmma_pv<D>(" in mma
    assert "wgmma" not in _body(flash, "\nflash_fwd_kernel(")
    assert {int(x) for x in re.findall(r"dispatch_groups<T, (\d+)>",
                                       decode)} == set(HEAD_DIMS)
    assert {int(x) for x in re.findall(r"launch_decode<T, D, (\d+)>",
                                       decode)} == set(GROUPS)
    dense = [c for c in ARCHS.values() if c.family == "dense"]
    assert dense
    for cfg in dense:
        assert cfg.hd in HEAD_DIMS, cfg.name
        assert cfg.n_heads // cfg.n_kv_heads in GROUPS, cfg.name


def test_cuda_dispatch_covers_the_ssm_configs():
    """ssd_scan.cu instantiates exactly the (head_dim, state) pairs the
    wrapper accepts, and those cover every ported ssm config."""
    src = (CSRC / "ssd_scan.cu").read_text()
    shapes = {(int(p), int(n)) for p, n in
              re.findall(r"launch_ssd<T, O, (\d+), (\d+)>", src)}
    assert shapes == set(SSD_SHAPES)
    # bf16: C B^T once per (b, chunk), then the tensor-core scan; f32
    # keeps the FMA body
    launch = _body(src, "cudaError_t launch_ssd(")
    bf16, f32 = launch.split("} else {")
    assert "is_same_v<T, bf16>" in bf16
    assert "ssd_cb_kernel<N>" in bf16 and "ssd_scan_mma_kernel<O, P, N>" in bf16
    assert "ssd_scan_kernel<T, O, P, N>" in f32
    for kernel in ("ssd_cb_kernel(", "ssd_scan_mma_kernel("):
        assert "mma_bf16(" in _body(src, kernel)
    assert "mma_bf16(" not in _body(src, "\nssd_scan_kernel(")
    ssm = [c for c in ARCHS.values() if c.family == "ssm"]
    assert [c.name for c in ssm] == ["mamba2-2.7b"]
    for cfg in ssm:
        assert (cfg.ssm_head_dim, cfg.ssm_state) in SSD_SHAPES, cfg.name


def test_build_key_covers_every_source():
    cus, headers = _build._sources()
    assert {p.name for p in cus} == {"flash_attention.cu",
                                     "decode_attention.cu", "ssd_scan.cu"}
    assert {p.name for p in headers} == {"common.cuh", "mma.cuh"}
    assert _build._key() == _build._key()
    assert "sm_90a" in " ".join(_build.FLAGS)


# ------------------------------------------------------------------ #
# on the card
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda, dtype):
    tol = TOL[str(dtype).split(".")[-1]]
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v = randn(2, 16, 200, 128), randn(2, 8, 200, 128), randn(2, 8, 200, 128)
    for kw in ({}, {"window": 64, "softcap": 50.0}, {"causal": False}):
        torch.testing.assert_close(flash_attention(q, k, v, **kw),
                                   flash_attention_plain(q, k, v, **kw),
                                   atol=tol, rtol=tol)
    qd = randn(2, 16, 128)
    for kv_len, kw in ((1, {}), (150, {}), (200, {"window": 64,
                                                  "softcap": 50.0})):
        torch.testing.assert_close(
            decode_attention(qd, k, v, kv_len, **kw),
            decode_attention_plain(qd, k, v, kv_len, **kw), atol=tol, rtol=tol)
    torch.cuda.synchronize()
