"""CUDA kernels of the PyTorch port on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. The file imports no JAX, so it also runs where JAX is
absent; on such a machine run it without the JAX-importing ``conftest.py``:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: float32 max-abs 1e-4 (both sides true float32, TF32 off),
bfloat16 max-abs 1e-2 (about one bf16 ulp of an output below 2).
"""

import numpy as np
import pytest
import torch

from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.models.params import dit_state
from vietvoice_tts_tpu_torch.ops.kernels import fused_rope_attention as fra
from vietvoice_tts_tpu_torch.ops.rope import rope_tables

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _attention_inputs(b, n, heads, head_dim, valid, device, dtype, seed=7):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * heads * head_dim)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    cos, sin = rope_tables(n, head_dim)
    return (
        torch.from_numpy(qkv).to(device, dtype),
        torch.from_numpy(cos).to(device),
        torch.from_numpy(sin).to(device),
        torch.from_numpy(mask).to(device),
    )


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,n,heads,head_dim", [(2, 512, 8, 128), (2, 512, 16, 64),
                                                (2, 437, 8, 128)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, tol, b, n, heads, head_dim):
    valid = [n - 77, n]
    qkv, cos, sin, mask = _attention_inputs(b, n, heads, head_dim, valid,
                                            cuda_device, dtype)
    before = fra.launches
    out = fra.fused_qkv_rope_attention(qkv, cos, sin, mask, heads)
    torch.cuda.synchronize()
    assert fra.launches == before + 1
    ref = fra.fused_qkv_rope_attention_reference(qkv, cos, sin, mask, heads)
    for row, v in enumerate(valid):
        err = (out[row, :v].float() - ref[row, :v].float()).abs().max().item()
        assert err <= tol


def test_cuda_wrapper_raises_on_mixed_devices(cuda_device):
    qkv, cos, sin, mask = _attention_inputs(1, 64, 2, 64, [64], cuda_device,
                                            torch.float32)
    before = fra.launches
    with pytest.raises(ValueError, match="cos"):
        fra.fused_qkv_rope_attention(qkv, cos.cpu(), sin, mask, 2)
    strided = torch.cat([qkv, qkv], dim=-1)[..., : qkv.shape[-1]]
    with pytest.raises(ValueError, match="contiguous"):
        fra.fused_qkv_rope_attention(strided, cos, sin, None, 2)
    assert fra.launches == before


def test_cuda_wrapper_and_dit_raise_on_unsupported_head_dim(cuda_device):
    """head_dim 96 has no kernel: on the card the wrapper raises, and so does
    a DiT built with use_kernels; neither falls back to the plain version."""
    qkv, cos, sin, mask = _attention_inputs(1, 64, 2, 96, [64], cuda_device,
                                            torch.float32)
    before = fra.launches
    with pytest.raises(ValueError, match="head_dim"):
        fra.fused_qkv_rope_attention(qkv, cos, sin, mask, 2)

    dims = dict(dim=192, depth=1, heads=2, ff_mult=2, n_mels=16, text_dim=32,
                text_conv_layers=1, vocab_size=40)
    tree = tdit.init_dit_params(np.random.default_rng(0), tdit.DiTConfig(**dims))
    dit = tdit.DiT(tdit.DiTConfig(**dims, compute_dtype=torch.float32, use_kernels=True))
    dit.load_state_dict(dit_state(tree, torch.float32), assign=True)
    dit = dit.to(cuda_device).eval()
    b, n = 1, 64
    x = torch.zeros((b, n, 16), device=cuda_device)
    ids = torch.zeros((b, n), dtype=torch.int64, device=cuda_device)
    valid = torch.ones((b, n), dtype=torch.bool, device=cuda_device)
    with torch.inference_mode(), pytest.raises(ValueError, match="head_dim"):
        dit.forward_embedded(x, x, dit.text_embed(ids), torch.zeros(b, device=cuda_device),
                             valid)
    assert fra.launches == before


def test_cuda_dit_forward_runs_kernel_in_every_block(cuda_device):
    """The DiT dispatches to the kernel once per block on CUDA tensors with
    use_kernels, and its output matches the plain path's (gates opened)."""
    dims = dict(dim=256, depth=3, heads=2, ff_mult=2, n_mels=16, text_dim=32,
                text_conv_layers=1, vocab_size=40)
    rng = np.random.default_rng(0)
    tree = tdit.init_dit_params(rng, tdit.DiTConfig(**dims))
    for gates in (tree["blocks"]["ada"], tree["final_ada"]):
        for k in gates:
            gates[k] = rng.normal(0.0, 0.05, gates[k].shape).astype(np.float32)
    state = dit_state(tree, torch.float32)

    b, n = 2, 200
    x, cond = (torch.from_numpy(rng.standard_normal((b, n, 16)).astype(np.float32))
               .to(cuda_device) for _ in range(2))
    ids = torch.from_numpy(rng.integers(-1, 40, (b, n))).to(cuda_device)
    mask = torch.from_numpy(np.arange(n)[None, :] < np.array([150, n])[:, None])
    mask = mask.to(cuda_device)
    t = torch.tensor([0.3, 0.7], device=cuda_device)

    outs, counts = {}, {}
    for use_kernels in (True, False):
        dit = tdit.DiT(tdit.DiTConfig(**dims, compute_dtype=torch.float32,
                                      use_kernels=use_kernels))
        dit.load_state_dict(state, assign=True)
        dit = dit.to(cuda_device).eval()
        before = fra.launches
        with torch.inference_mode():
            outs[use_kernels] = dit.forward_embedded(x, cond, dit.text_embed(ids), t, mask)
        torch.cuda.synchronize()
        counts[use_kernels] = fra.launches - before
    assert counts == {True: dims["depth"], False: 0}
    err = (outs[True] - outs[False]).abs().max().item()
    assert np.isfinite(err) and err <= 1e-4
