"""The flash-attention routes of the ``wgmma`` kernels: ``flash_sm90``
(bf16, head sizes 64, 80, 128 and 256; the float32 one,
``flash_sm90_f32``, at 64 and 128, has its card tests in
``tests/test_torch_flash_sm90_f32.py``).

On the CPU: which kernel a (dtype, head size) call takes
(``kernel_for``, which the wrapper and ``chip_smoke.py`` share), what
the wrapper refuses before any launch (``check_args``), and the plain
version ``attention_torch`` against ``repro.kernels.ref.attention`` at
every (Sq, Skv, mask, heads) case the card tests take, in float32 at
the reference's ``2e-5``; and that ``chip_smoke.py --flash-turn`` (one
turn of a comparison call) refuses to run without a card.

Marked ``cuda`` (skipped without a card): the TMA-fed, warp-specialised
``wgmma`` kernel against ``attention_torch`` around its 128-row q tile
and 128-key kv tile, under every mask and the served GQA ratios, one
launch a call, at the reference's bf16 ``2e-2``
(``tests/test_kernels.py:17-18``); and the C side's route against
``kernel_for``.  The card tests import nothing of JAX.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa

BF16_TOL = dict(atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# CPU: the route and the refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D,want", [
    (64, "flash_sm90"), (128, "flash_sm90"),
    (40, "flash_sm90"), (33, "flash_sm90"), (100, "flash_sm90"),
    (1, "flash_mma"), (16, "flash_mma"), (32, "flash_mma"),
    (80, "flash_sm90"), (129, "flash_sm90"), (256, "flash_sm90")])
def test_kernel_for_bf16(D, want):
    """bf16 takes flash_sm90 exactly where the padded head size is 64,
    80, 128 or 256 (a head of 40 pads to 64, one of 129 to 256),
    flash_mma at 16 and 32, the reduced configs' sizes."""
    assert tfa.kernel_for(torch.bfloat16, D) == want
    assert (want == "flash_sm90") == (tfa.padded_head_dim(D)
                                      in tfa.SM90_HEAD_DIMS)


@pytest.mark.parametrize("D,want", [
    (64, "flash_sm90_f32"), (128, "flash_sm90_f32"),
    (40, "flash_sm90_f32"), (33, "flash_sm90_f32"), (100, "flash_sm90_f32"),
    (1, "flash_kernel"), (16, "flash_kernel"), (32, "flash_kernel"),
    (80, "flash_sm90_f32"), (129, "flash_sm90_f32"),
    (256, "flash_sm90_f32")])
def test_kernel_for_float32(D, want):
    """float32 takes flash_sm90_f32 exactly where the padded head size is
    64, 80, 128 or 256 (a head of 129 pads to 256), flash_kernel at 16
    and 32, the reduced configs' sizes."""
    assert tfa.kernel_for(torch.float32, D) == want
    assert (want == "flash_sm90_f32") == (tfa.padded_head_dim(D)
                                          in tfa.SM90_F32_HEAD_DIMS)


def test_kernel_for_names_only_built_kernels():
    assert {tfa.kernel_for(dt, D) for dt in (torch.float32, torch.bfloat16)
            for D in range(1, 257)} == set(tfa.KERNELS)


@pytest.mark.parametrize("dtype,D,exc", [
    (torch.bfloat16, 288, NotImplementedError),
    (torch.float32, 0, NotImplementedError),
    (torch.float16, 64, TypeError)])
def test_kernel_for_refuses(dtype, D, exc):
    with pytest.raises(exc):
        tfa.kernel_for(dtype, D)


def _qkv(B=1, Sq=8, Skv=8, Hq=4, Hkv=2, D=64, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(0)
    return (torch.randn(B, Sq, Hq, D, generator=gen).to(dtype),
            torch.randn(B, Skv, Hkv, D, generator=gen).to(dtype),
            torch.randn(B, Skv, Hkv, D, generator=gen).to(dtype))


@pytest.mark.parametrize("D,want", [(64, 64), (128, 128), (40, 64),
                                    (16, 16), (200, 256), (80, 80),
                                    (256, 256)])
def test_check_args_pads(D, want):
    q, k, v = _qkv(D=D)
    assert tfa.check_args(q, k, v, None) == want


def _misaligned(x):
    flat = torch.empty(x.numel() + 8, dtype=x.dtype)
    y = flat[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    return y


REFUSED = {
    "mixed dtypes": (lambda q, k, v: (q, k.float(), v), TypeError,
                     "share one dtype"),
    "float16": (lambda q, k, v: (q.half(), k.half(), v.half()), TypeError,
                "share one dtype"),
    "3-d q": (lambda q, k, v: (q[0], k, v), ValueError, "bad shapes"),
    "k and v differ": (lambda q, k, v: (q, k, v[:, :4]), ValueError,
                       "bad shapes"),
    "Hq not a multiple of Hkv": (lambda q, k, v: (q[:, :, :3].contiguous(),
                                                  k, v),
                                 ValueError, "incompatible"),
    "Sq > Skv": (lambda q, k, v: (q, k[:, :4].contiguous(),
                                  v[:, :4].contiguous()),
                 ValueError, "incompatible"),
    "head sizes differ": (lambda q, k, v: (q[..., :32].contiguous(), k, v),
                          ValueError, "incompatible"),
    "batch differs": (lambda q, k, v: (torch.cat([q, q]), k, v), ValueError,
                      "incompatible"),
    "head dim 288": (lambda q, k, v: tuple(
        torch.nn.functional.pad(x, (0, 224)) for x in (q, k, v)),
                     NotImplementedError, "head dim 288"),
    "not contiguous": (lambda q, k, v: (q.transpose(1, 2).contiguous()
                                        .transpose(1, 2), k, v),
                       ValueError, "contiguous"),
    "not 16-byte aligned": (lambda q, k, v: (_misaligned(q), k, v),
                            ValueError, "16-byte aligned"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_check_args_refuses(case):
    """What the wrapper refused before a launch it still refuses, with
    the same exception and message."""
    make, exc, match = REFUSED[case]
    q, k, v = make(*_qkv())
    with pytest.raises(exc, match=match):
        tfa.check_args(q, k, v, None)


@pytest.mark.parametrize("window", (0, -3))
def test_check_args_refuses_window(window):
    with pytest.raises(ValueError, match="window must be >= 1"):
        tfa.check_args(*_qkv(), window)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _qkv(Sq=5, Skv=9)
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=True, window=4)
    assert tfa.launches == before
    assert torch.equal(got, tfa.attention_torch(q, k, v, causal=True,
                                                window=4))


#: query rows around the 128-row q tile (and the 64-row warpgroup half),
#: and a served prompt
SQ = (1, 63, 64, 65, 127, 128, 129, 1000)
#: Skv - Sq: queries at the start of the keys, and offset past them
EXTRA = (0, 70)
#: causal, local windows of 48 and 100, bidirectional
MASKS = [(True, None), (True, 48), (True, 100), (False, None)]
#: stablelm-1.6b, llama3.2-3b, dbrx-132b, qwen3-moe-235b-a22b
HEADS = [(32, 32), (24, 8), (48, 8), (64, 4)]
#: the card tests' heads: HEADS, recurrentgemma-9b's local layers (MQA,
#: 16 over 1) and hubert-xlarge's encoder (16 over 16)
CARD_HEADS = HEADS + [(16, 1), (16, 16)]


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture(scope="module")
def jref():
    from repro.kernels import ref

    return ref


@pytest.mark.parametrize("Sq", SQ)
@pytest.mark.parametrize("extra", EXTRA)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("heads", HEADS)
def test_plain_vs_reference_at_card_cases(jref, Sq, extra, causal, window,
                                          heads):
    """The card tests hold the kernel to ``attention_torch``; this holds
    ``attention_torch`` to the JAX package's oracle on the same cases
    (the queries' offset into the keys, the windows, the GQA head map),
    so a reading of the masks the two share cannot pass unseen.  B 1 and
    head size 64 here (the masks and the head map depend on neither);
    float32."""
    import jax.numpy as jnp

    (Hq, Hkv), Skv = heads, Sq + extra
    qn, kn, vn = _draw(Sq * 7 + extra, (1, Sq, Hq, 64), (1, Skv, Hkv, 64),
                       (1, Skv, Hkv, 64))
    got = tfa.attention_torch(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                              causal=causal, window=window)
    want = jref.attention(*(jnp.asarray(x) for x in (qn, kn, vn)),
                          causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# ---------------------------------------------------------------------------
# card only
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "for sm_90a)")
    return torch.device("cuda")


def _card(dev, seed, *shapes):
    return [torch.from_numpy(x).to(dev).to(torch.bfloat16)
            for x in _draw(seed, *shapes)]


def _close(got, want):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", SQ)
@pytest.mark.parametrize("extra", EXTRA)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("heads", CARD_HEADS)
@pytest.mark.parametrize("D", tfa.SM90_HEAD_DIMS)
def test_sm90_kernel_vs_plain(cuda_device, Sq, extra, causal, window, heads,
                              D):
    """B 2; Skv = Sq + extra (queries the last Sq positions).  Sq of 63,
    64 and 65 also sit around the 64-key kv tile of head size 256."""
    (Hq, Hkv), B, Skv = heads, 2, Sq + extra
    q, k, v = _card(cuda_device, Sq * 7 + extra, (B, Sq, Hq, D),
                    (B, Skv, Hkv, D), (B, Skv, Hkv, D))
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    assert got.shape == q.shape and bool(torch.isfinite(got.float()).all())
    _close(got, tfa.attention_torch(q, k, v, causal=causal, window=window))


#: the served shapes at head sizes 80 and 256, (B, Sq, Hq, Hkv, D,
#: causal, window): recurrentgemma-9b's 2300-token prompt with its 2048
#: window and without, its 8-token prompt, hubert-xlarge's 1000 frames
SERVED = [(1, 2300, 16, 1, 256, True, 2048), (1, 2300, 16, 1, 256, True,
                                              None),
          (2, 8, 16, 1, 256, True, 2048), (1, 1000, 16, 16, 80, False,
                                           None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SERVED)
def test_sm90_served_wide_shapes(cuda_device, case, monkeypatch):
    """The kernel at the served shapes against ``attention_torch``, on
    the tensors as they are: no padding copy (``pad_head`` never runs)."""
    B, S, Hq, Hkv, D, causal, window = case

    def no_pad(*_):
        raise AssertionError("flash_attention padded the head")

    monkeypatch.setattr(tfa, "pad_head", no_pad)
    q, k, v = _card(cuda_device, S + D, (B, S, Hq, D), (B, S, Hkv, D),
                    (B, S, Hkv, D))
    assert tfa.kernel_for(q.dtype, D) == "flash_sm90"
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _close(got, tfa.attention_torch(q, k, v, causal=causal, window=window))


@pytest.mark.cuda
def test_route_agrees_with_kernel_for(cuda_device):
    """The C dispatch and ``kernel_for`` name the same kernel for every
    dtype and instantiated head size."""
    lib = tfa._lib()
    for dtype, code in tfa._DTYPE_CODE.items():
        for D in tfa.HEAD_DIMS:
            assert tfa.KERNELS[lib.flash_attention_route(code, D)] == \
                tfa.kernel_for(dtype, D)
    assert lib.flash_attention_route(0, 64) == \
        tfa.KERNELS.index("flash_sm90_f32")
    assert lib.flash_attention_route(1, 48) == -1
    assert lib.flash_attention_route(2, 64) == -1


def test_flash_turn_refuses_without_cuda():
    """``chip_smoke.py --flash-turn`` (a comparison call's turn) exits
    non-zero and prints no result without a card."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(root / "chip_smoke.py"), "--flash-turn"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
