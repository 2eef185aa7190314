"""The DiT block's gated residual and modulated LayerNorm
(``ops/kernels/adaln_norm.py``, ``csrc/adaln_norm.cu``).

On the CPU: the plain version against the eager chain the DiT ran before it
(``modulated_norm`` and the gated residual, written out below as they were),
bit for bit, alone and through whole forwards (the deep-cache split, a
modulation per batch row), and the routes: which calls reach the kernel's
wrapper, and what it refuses before a launch. Tests marked ``cuda`` hold the
kernel against the plain version on the card and skip here. The file imports
no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_adanorm.py -m cuda --noconftest

Gates on the card: h' bit for bit; u within one ulp of its type at each
rounding the plain chain makes (one, or two with a bfloat16 norm_dtype),
plus a few float32 ulps of the modulation's terms, since the kernel sums
the statistics in another order than ``F.layer_norm``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vietvoice_tts_tpu_torch.models import dit as tdit
from vietvoice_tts_tpu_torch.models.params import dit_state
from vietvoice_tts_tpu_torch.models.sampler import SamplerConfig, flow_matching_sample
from vietvoice_tts_tpu_torch.ops.kernels import adaln_norm as an

DTYPES = (torch.float32, torch.bfloat16)
DIMS = dict(depth=3, heads=2, ff_mult=2, n_mels=16, text_dim=32, text_conv_layers=1,
            vocab_size=40)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# -- The eager chain the DiT ran before the kernel ------------------------------


def _chain_norm(h, sc, sh, norm_dtype, dtype):
    """``modulated_norm`` as the DiT block wrote it."""
    return (an.layernorm(h, norm_dtype) * (1.0 + sc[:, None]) + sh[:, None]).to(dtype)


def _chain_residual(h, g, x):
    return h + g[:, None].to(h.dtype) * x


def _chain_forward(dit, x, cond, text_emb, mask, mods, fmod, shallow_blocks=None,
                   deep_state=None, return_deep_state=False):
    """``DiT.forward_embedded`` on one rank as it was before the kernel:
    the modulated norms and gated residuals as separate ops, the final norm
    after the last block."""
    cfg = dit.cfg
    dtype = cfg.compute_dtype
    n = x.shape[1]
    mask_f = mask[..., None].float()
    h_in = torch.cat([x.float() * mask_f, cond.float() * mask_f, text_emb * mask_f],
                     dim=-1).to(dtype)
    h = tdit.linear(h_in, dit.input_proj)
    pos = F.mish(tdit.dwconv(h, dit.conv_pos_dw.weight, dit.conv_pos_dw.bias))
    h = (h + tdit.linear(pos, dit.conv_pos_pw)) * mask_f.to(dtype)
    cos, sin = dit._rope(n, x.device)
    attend = dit._attend()

    def run_blocks(h, start, stop):
        for i in range(start, stop):
            blk = dit.blocks[i]
            sh_a, sc_a, g_a, sh_f, sc_f, g_f = mods[i].chunk(6, dim=-1)
            u = _chain_norm(h, sc_a, sh_a, cfg.norm_dtype, dtype)
            attn = tdit.linear(attend(tdit.linear(u, blk.qkv), cos, sin, mask), blk.attn_out)
            h = _chain_residual(h, g_a, attn)
            u = _chain_norm(h, sc_f, sh_f, cfg.norm_dtype, dtype)
            f = tdit.linear(F.gelu(tdit.linear(u, blk.ff1), approximate="tanh"), blk.ff2)
            h = _chain_residual(h, g_f, f)
        return h

    deep_out = None
    if shallow_blocks is None:
        h = run_blocks(h, 0, cfg.depth)
    else:
        h = run_blocks(h, 0, shallow_blocks)
        if deep_state is not None:
            h = h + deep_state.to(h.dtype)
        else:
            h_deep = run_blocks(h, shallow_blocks, cfg.depth)
            deep_out = h_deep - h
            h = h_deep
    sh, sc = fmod.chunk(2, dim=-1)
    h = an.layernorm(h) * (1.0 + sc[:, None]) + sh[:, None]
    out = F.linear(h, dit.final_proj.weight.float(), dit.final_proj.bias.float())
    out = torch.where(mask[..., None], out, torch.zeros(()))
    return (out, deep_out) if return_deep_state else out


def _gated_dit(dim, device, dtype, use_kernels, norm_dtype=torch.float32, seed=0):
    """A DiT of width ``dim`` with opened AdaLN gates (a pack's are zero)."""
    cfg = tdit.DiTConfig(dim=dim, **DIMS, compute_dtype=dtype, norm_dtype=norm_dtype,
                         use_kernels=use_kernels)
    rng = np.random.default_rng(seed)
    tree = tdit.init_dit_params(rng, cfg)
    for gates in (tree["blocks"]["ada"], tree["final_ada"]):
        for k in gates:
            gates[k] = rng.normal(0.0, 0.05, gates[k].shape).astype(np.float32)
    dit = tdit.DiT(cfg)
    dit.load_state_dict(dit_state(tree, dtype), assign=True)
    return dit.to(device).eval()


def _forward_inputs(dit, b, n, device, seed=1):
    rng = np.random.default_rng(seed)
    x, cond = (torch.from_numpy(rng.standard_normal((b, n, 16)).astype(np.float32)).to(device)
               for _ in range(2))
    ids = torch.from_numpy(rng.integers(-1, 40, (b, n))).to(device)
    mask = torch.from_numpy(np.arange(n)[None, :] < np.array([n - 9, n][:b])[:, None])
    t = torch.tensor([0.3, 0.7][:b], device=device)
    return x, cond, dit.text_embed(ids), t, mask.to(device)


def _modulations(b, rows, dim, depth=2, seed=2, device="cpu"):
    """Six modulation rows [rows, dim] of one block, as the DiT cuts them
    from the hoisted ``mods`` [depth, rows, 6·dim] (strided views); rows 1
    broadcasts over the batch."""
    rng = np.random.default_rng(seed)
    mods = torch.from_numpy(
        rng.normal(0.0, 0.3, (rows, depth, 6 * dim)).astype(np.float32)).to(device)
    return mods.transpose(0, 1)[depth - 1].chunk(6, dim=-1)


def _stream(b, n, dim, dtype, seed=3, device="cpu", strided=False):
    """h [b, n, dim] with a per-row offset and scale; with ``strided`` a view
    of frames of a longer buffer, as a sequence-parallel rank slices it."""
    rng = np.random.default_rng(seed)
    full = n + 5 if strided else n
    h = (rng.standard_normal((b, full, dim)) * rng.uniform(0.5, 4.0, (b, full, 1))
         + rng.normal(0.0, 2.0, (b, full, 1)))
    h = torch.from_numpy(h.astype(np.float32)).to(device, dtype)
    return h[:, 3:3 + n] if strided else h


# -- CPU: the plain version is the chain ----------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm_dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 3])
def test_plain_version_is_the_eager_chain_bit_for_bit(dtype, norm_dtype, rows):
    """Forms (a), (b), (c) and the final float32 norm of the plain version
    against ``modulated_norm`` and the gated residual as the block ran them,
    with strided modulation views (rows 1 broadcasts, rows 3 one per batch
    row) and a strided h."""
    b, n, dim = 3, 7, 48
    h, x = _stream(b, n, dim, dtype, strided=True), _stream(b, n, dim, dtype, seed=4)
    sh_a, sc_a, g_a, *_ = _modulations(b, rows, dim)
    kw = dict(norm_dtype=norm_dtype)
    h1, u = an.adaln_norm_reference(h, scale=sc_a, shift=sh_a, **kw)
    assert h1 is h and torch.equal(u, _chain_norm(h, sc_a, sh_a, norm_dtype, dtype))
    h2, u = an.adaln_norm_reference(h, g_a, x, sc_a, sh_a, **kw)
    want = _chain_residual(h, g_a, x)
    assert torch.equal(h2, want) and torch.equal(u, _chain_norm(want, sc_a, sh_a, norm_dtype,
                                                                 dtype))
    h3, u = an.adaln_norm_reference(h, g_a, x)
    assert u is None and torch.equal(h3, want)
    _, u = an.adaln_norm_reference(h, g_a, x, sc_a, sh_a, norm_dtype=torch.float32,
                                   out_dtype=torch.float32)
    assert u.dtype == torch.float32
    assert torch.equal(u, an.layernorm(want) * (1.0 + sc_a[:, None]) + sh_a[:, None])
    # The wrapper on CPU tensors is the plain version and launches nothing.
    before = an.launches
    got = an.adaln_norm(h, g_a, x, sc_a, sh_a, **kw)
    assert all(torch.equal(p, q) for p, q in zip(got, (h2, _chain_norm(want, sc_a, sh_a,
                                                                         norm_dtype, dtype))))
    assert an.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cache", ["none", "record", "replay", "per_row"])
def test_dit_forward_is_the_eager_chain_bit_for_bit(dtype, cache):
    """Whole forwards of the DiT, on the plain route (as training and the
    CPU run it), against the chain: no split, the deep cache's recording
    forward and its shallow forward on the record, and modulations computed
    from t, one row per batch row (B' = B)."""
    dit = _gated_dit(32, "cpu", dtype, use_kernels=False)
    x, cond, emb, t, mask = _forward_inputs(dit, 2, 24, "cpu")
    mods, fmod = dit.time_modulations(t)
    per_row = (mods.transpose(0, 1), fmod)
    hoisted = (mods[:1].transpose(0, 1), fmod[:1])  # B' = 1, as the sampler passes them
    with torch.inference_mode():
        if cache == "none":
            got = dit.forward_embedded(x, cond, emb, t, mask, time_mod=hoisted)
            want = _chain_forward(dit, x, cond, emb, mask, *hoisted)
        elif cache == "per_row":
            got = dit.forward_embedded(x, cond, emb, t, mask)
            want = _chain_forward(dit, x, cond, emb, mask, *per_row)
        else:
            kw = dict(shallow_blocks=1, return_deep_state=True)
            got_out, state = dit.forward_embedded(x, cond, emb, t, mask, time_mod=hoisted, **kw)
            want_out, want_state = _chain_forward(dit, x, cond, emb, mask, *hoisted, **kw)
            assert torch.equal(state, want_state) and torch.equal(got_out, want_out)
            got = dit.forward_embedded(x, cond, emb, t, mask, time_mod=hoisted,
                                       shallow_blocks=1, deep_state=state)
            want = _chain_forward(dit, x, cond, emb, mask, *hoisted, shallow_blocks=1,
                                  deep_state=want_state)
            if cache == "record":
                got, want = got_out, want_out
    assert got.dtype == torch.float32 and got.abs().max() > 0
    assert torch.equal(got, want)


class _Spy:
    """Stands in for the kernel's wrapper inside the DiT: counts its calls
    and runs the plain version."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return an.adaln_norm_reference(*args, **kw)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("split,want", [(None, 1 + 2 * 3), ("record", 2 + 2 * 3),
                                        ("replay", 2 + 2 * 1)])
def test_dit_reaches_the_wrapper_only_with_use_kernels(monkeypatch, use_kernels, split, want):
    """With ``use_kernels`` every gated residual and modulated norm of a
    forward goes through the kernel's wrapper (which takes CUDA tensors to
    the kernel): 1 + 2·depth calls, one more for a deep-cache split, whose
    segments end in a residual alone; without it none does."""
    spy = _Spy()
    monkeypatch.setattr(tdit, "adaln_norm", spy)
    dit = _gated_dit(32, "cpu", torch.float32, use_kernels=use_kernels)
    x, cond, emb, t, mask = _forward_inputs(dit, 2, 16, "cpu")
    with torch.inference_mode():
        if split is None:
            dit.forward_embedded(x, cond, emb, t, mask)
        else:
            _, state = dit.forward_embedded(x, cond, emb, t, mask, shallow_blocks=1,
                                            return_deep_state=True)
            if split == "replay":
                spy.calls = 0
                dit.forward_embedded(x, cond, emb, t, mask, shallow_blocks=1,
                                     deep_state=state)
    assert spy.calls == (want if use_kernels else 0)


def test_wrapper_refuses_autograd_before_it_launches():
    """Off the CPU the wrapper goes to the kernel, and first refuses a call
    autograd would record (the kernel has no backward), through
    ``refuse_autograd``; under ``no_grad`` it goes on to the launch, which
    takes CUDA tensors alone. Meta tensors stand in for a card here. On the
    CPU the plain version stays differentiable."""
    h = torch.zeros((1, 4, 16), device="meta", requires_grad=True)
    sc = torch.zeros((1, 16), device="meta")
    before = an.launches
    with pytest.raises(RuntimeError, match="no backward"):
        an.adaln_norm(h, scale=sc, shift=sc)
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        an.adaln_norm(h, scale=sc, shift=sc)
    assert an.launches == before
    hc = _stream(1, 4, 16, torch.float32).requires_grad_(True)
    _, u = an.adaln_norm(hc, scale=torch.zeros(1, 16), shift=torch.zeros(1, 16))
    u.sum().backward()
    assert hc.grad is not None and an.launches == before


@pytest.mark.parametrize("call,match", [
    (lambda h, m: an.adaln_norm(h, m, None), "come together"),
    (lambda h, m: an.adaln_norm(h), "residual"),
    (lambda h, m: an.adaln_norm(h, scale=m.double(), shift=m), "float32"),
    (lambda h, m: an.adaln_norm(h, scale=torch.zeros(2, 16), shift=m), r"\[1 or 3, 16\]"),
    (lambda h, m: an.adaln_norm(h.half(), scale=m, shift=m), "float32 or bfloat16"),
    (lambda h, m: an.adaln_norm(h, scale=m, shift=m, out_dtype=torch.float16), "out_dtype"),
])
def test_wrapper_checks_its_inputs_on_every_device(call, match):
    with pytest.raises((TypeError, ValueError), match=match):
        call(_stream(3, 4, 16, torch.float32), torch.zeros(1, 16))


@pytest.mark.parametrize("dim,dtype,want", [
    (1024, torch.bfloat16, (128, 1)), (1024, torch.float32, (256, 1)),
    (768, torch.bfloat16, (96, 1)), (1152, torch.bfloat16, (160, 1)),
    (1536, torch.float32, (192, 2)), (4096, torch.bfloat16, (256, 2)),
    (8, torch.float32, (32, 1)),
])
def test_launch_shape_adapts_to_width_and_dtype(dim, dtype, want):
    """One block a row: the fewest 16-byte vectors a thread that keep a block
    within 256 threads, in whole warps."""
    threads, vpt = an.launch_shape(dim, dtype)
    assert (threads, vpt) == want
    assert threads * vpt * 16 // dtype.itemsize >= dim and threads % 32 == 0


@pytest.mark.parametrize("dim,dtype,match", [
    (36, torch.bfloat16, "multiple of 8"), (1028, torch.float32, "multiple of 8"),
    (4104, torch.bfloat16, "up to 4096"), (2056, torch.float32, "up to 2048"),
    (1024, torch.float16, "float32 or bfloat16"),
])
def test_launch_shape_refuses_what_the_kernel_does_not_take(dim, dtype, match):
    with pytest.raises((TypeError, ValueError), match=match):
        an.launch_shape(dim, dtype)


# -- On the card -------------------------------------------------------------------


def _ulp(t: torch.Tensor) -> torch.Tensor:
    """One ulp of each value of t in t's dtype, as float32."""
    mant = {torch.float32: 23, torch.bfloat16: 7}[t.dtype]
    a = t.float().abs().clamp_min(torch.finfo(t.dtype).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - mant)


def _check_u(u, h_new, sc, sh, norm_dtype, out_dtype, label):
    """u within one ulp of each rounding the chain makes, plus 2⁻²⁰ of the
    float32 terms before them: the normalised value, the row's mean |h'| over
    its standard deviation (the error of a float32 mean is relative to the
    values summed), and the shift. The statistics' summation order is all
    that differs before the roundings."""
    _, want = an.adaln_norm_reference(h_new, scale=sc, shift=sh, norm_dtype=norm_dtype,
                                      out_dtype=out_dtype)
    norm = an.layernorm(h_new, norm_dtype)
    hs = h_new.to(norm_dtype).float()
    spread = hs.abs().mean(-1, keepdim=True) * torch.rsqrt(
        hs.var(-1, unbiased=False, keepdim=True) + an.LN_EPS)
    one_sc = (1.0 + sc[:, None]).abs()
    tol = 2.0 ** -20 * ((norm.abs() + spread) * one_sc + sh[:, None].abs())
    if out_dtype != torch.float32:
        tol = tol + _ulp(want)
    if norm_dtype != torch.float32:
        tol = tol + _ulp(norm.to(norm_dtype)) * one_sc
    err = (u.float() - want.float()).abs()
    assert u.dtype == want.dtype and u.is_contiguous(), label
    assert torch.isfinite(u).all() and bool((err <= tol).all()), (
        f"{label}: u off by {err.max().item():.3e}, worst over tolerance "
        f"{(err / tol).max().item():.2f}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [512, 768, 1024, 1536])
def test_cuda_kernel_matches_plain(cuda_device, dim, dtype):
    """Forms (a), (b), (c) and the final float32 norm at rows 1, 7 and
    1,408 (2 × 704, the cell's CFG-doubled chunk), norm_dtype float32 and
    bfloat16, B' = 1 and B' = B, strided modulation views and a strided h:
    h' bit for bit, u by :func:`_check_u`; one launch a call."""
    for b, n in ((1, 1), (7, 1), (2, 704)):
        for rows in (1, b):
            for norm_dtype in DTYPES:
                label = f"dim {dim} {dtype} rows {b}×{n} B'={rows} norm {norm_dtype}"
                h = _stream(b, n, dim, dtype, device=cuda_device, strided=True)
                x = _stream(b, n, dim, dtype, seed=4, device=cuda_device)
                sh, sc, g, *_ = _modulations(b, rows, dim, device=cuda_device)
                kw = dict(norm_dtype=norm_dtype)
                before = an.launches
                h_a, u_a = an.adaln_norm(h, scale=sc, shift=sh, **kw)
                h_b, u_b = an.adaln_norm(h, g, x, sc, sh, **kw)
                h_c, u_c = an.adaln_norm(h, g, x)
                h_d, u_d = an.adaln_norm(h_b, g, x, sc, sh, norm_dtype=torch.float32,
                                         out_dtype=torch.float32)
                torch.cuda.synchronize()
                assert an.launches == before + 4, label
                want_h, _ = an.adaln_norm_reference(h, g, x)
                assert h_a is h and u_c is None, label
                assert torch.equal(h_b, want_h) and torch.equal(h_c, want_h), label
                want_d, _ = an.adaln_norm_reference(h_b, g, x)
                assert torch.equal(h_d, want_d), label
                _check_u(u_a, h, sc, sh, norm_dtype, dtype, f"(a) {label}")
                _check_u(u_b, want_h, sc, sh, norm_dtype, dtype, f"(b) {label}")
                _check_u(u_d, want_d, sc, sh, torch.float32, torch.float32,
                         f"final {label}")


@pytest.mark.cuda
def test_cuda_kernel_raises_on_what_it_does_not_take(cuda_device):
    """A width that is not a multiple of 8, rows off 16-byte alignment, a
    non-unit stride along dim, a modulation on another device and an input
    that requires grad raise on the card; nothing falls back to the plain
    version, and nothing launches."""
    before = an.launches
    h = torch.zeros((1, 4, 36), device=cuda_device)
    m = torch.zeros((1, 36), device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        an.adaln_norm(h, scale=m, shift=m)
    h = torch.zeros((1, 4, 33), device=cuda_device)[..., 1:]
    m = torch.zeros((1, 32), device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        an.adaln_norm(h, scale=m, shift=m)
    h = torch.zeros((1, 4, 64), device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        an.adaln_norm(h, scale=m, shift=m)
    h = torch.zeros((1, 4, 32), device=cuda_device)
    with pytest.raises(ValueError, match="scale is on cpu"):
        an.adaln_norm(h, scale=m.cpu(), shift=m)
    h.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        an.adaln_norm(h, scale=m, shift=m)
    assert an.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,norm_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.float32, 5e-2),
    (torch.bfloat16, torch.bfloat16, 5e-2),
])
def test_cuda_dit_forward_with_the_kernel_matches_plain(cuda_device, dtype, norm_dtype, tol):
    """A whole forward with ``use_kernels`` (the AdaLN kernel and kernel 1)
    against the plain route on the same weights, gates opened: 1 + 2·depth
    AdaLN launches, and the velocity within the whole-path tolerances of
    ``test_torch_cuda.py`` (float32) and ``chip_smoke.py:MEL_TOLERANCE``
    (bfloat16); the deep cache's two forwards as well."""
    dit = _gated_dit(256, cuda_device, dtype, use_kernels=True, norm_dtype=norm_dtype)
    x, cond, emb, t, mask = _forward_inputs(dit, 2, 200, cuda_device)
    outs, counts = {}, {}
    for use_kernels in (True, False):
        dit.cfg = dataclasses.replace(dit.cfg, use_kernels=use_kernels)
        before = an.launches
        with torch.inference_mode():
            out = dit.forward_embedded(x, cond, emb, t, mask)
            rec, state = dit.forward_embedded(x, cond, emb, t, mask, shallow_blocks=1,
                                              return_deep_state=True)
            rep = dit.forward_embedded(x, cond, emb, t, mask, shallow_blocks=1,
                                       deep_state=state)
        torch.cuda.synchronize()
        outs[use_kernels] = (out, rec, rep)
        counts[use_kernels] = an.launches - before
    depth = dit.cfg.depth
    assert counts == {True: (1 + 2 * depth) + (2 + 2 * depth) + (2 + 2 * 1), False: 0}
    for got, want in zip(outs[True], outs[False]):
        err = (got - want).abs().max().item()
        assert np.isfinite(err) and err <= tol, err


@pytest.mark.cuda
def test_cuda_sampler_launches_the_kernel_every_forward(cuda_device):
    """A 7-evaluation solve launches 7 · (1 + 2·depth) AdaLN kernels, and
    agrees with its plain solve."""
    dit = _gated_dit(64, cuda_device, torch.float32, use_kernels=True)
    rng = np.random.default_rng(2)
    b, n = 2, 96
    cond, x0 = (torch.from_numpy(rng.standard_normal((b, n, 16)).astype(np.float32))
                .to(cuda_device) for _ in range(2))
    ids = torch.from_numpy(rng.integers(-1, 40, (b, n))).to(cuda_device)
    mask = torch.from_numpy(np.arange(n)[None, :] < np.array([70, n])[:, None]).to(cuda_device)
    outs = {}
    for use_kernels in (True, False):
        dit.cfg = dataclasses.replace(dit.cfg, use_kernels=use_kernels)
        before = an.launches
        with torch.inference_mode():
            outs[use_kernels] = flow_matching_sample(dit, SamplerConfig(nfe_step=8), cond, ids,
                                                     mask, [0, 1], x0=x0)
        torch.cuda.synchronize()
        assert an.launches - before == (7 * (1 + 2 * dit.cfg.depth) if use_kernels else 0)
    assert (outs[True] - outs[False]).abs().max().item() <= 1e-3
