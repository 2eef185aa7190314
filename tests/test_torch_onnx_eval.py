"""Unit tests for the PyTorch port's numpy ONNX evaluator
(``vietvoice_tts_tpu_torch/models/onnx_eval.py``), the JAX package's
``tests/test_onnx_eval.py`` case for case; the GELU and grouped-conv cases
hold the evaluator against torch (the port's model) and JAX both.

Each op is exercised through a real serialized graph (onnx_pb.make_*), not
by calling the op table directly — the wire format, attribute parsing, and
environment threading are part of what's under test.
"""

import numpy as np
import pytest

import vietvoice_tts_tpu_torch.models.onnx_pb as ox
from vietvoice_tts_tpu_torch.models.onnx_eval import EvalSession, UnsupportedOp

F32, I64 = 1, 7


def _session(nodes, inits=(), inputs=(), outputs=()):
    graph = ox.make_graph("g", list(nodes), list(inits), list(inputs), list(outputs))
    return EvalSession(ox.make_model(graph))


def _run1(op, feeds, out_shape_hint=("N",), inits=(), n_in=None, **attrs):
    names = list(feeds)
    node = ox.make_node(op, names, ["y"], **attrs)
    s = _session(
        [node],
        inits,
        [ox.make_value_info(n, F32, list(out_shape_hint)) for n in names],
        [ox.make_value_info("y", F32, list(out_shape_hint))],
    )
    return s.run(["y"], feeds)[0]


class TestElementwise:
    def test_gemm_transb_with_bias(self):
        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        w = np.arange(12, dtype=np.float32).reshape(4, 3)  # [out, in]
        b = np.ones(4, np.float32)
        y = _run1("Gemm", {"a": a, "w": w, "b": b}, transB=1)
        np.testing.assert_allclose(y, a @ w.T + b)

    def test_integer_div_truncates(self):
        """Regression: ONNX Div on int64 is C-truncating division; the
        float-division bug shifted ref_signal_len (46.875 vs 46) and cost a
        whole cond frame in the golden rehearsal."""
        a = np.array([12000, -7], np.int64)
        b = np.array([256, 2], np.int64)
        y = _run1("Div", {"a": a, "b": b})
        assert y.dtype == np.int64
        np.testing.assert_array_equal(y, [46, -3])

    def test_float_div_stays_true_division(self):
        y = _run1("Div", {"a": np.float32([3.0]), "b": np.float32([2.0])})
        np.testing.assert_allclose(y, [1.5])

    def test_gelu_tanh_matches_jax(self):
        import jax.numpy as jnp
        import torch
        from jax.nn import gelu

        x = np.linspace(-3, 3, 17, dtype=np.float32)
        y = _run1("Gelu", {"x": x}, approximate="tanh")
        np.testing.assert_allclose(y, np.asarray(gelu(jnp.asarray(x))), atol=1e-6)
        ref = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
        np.testing.assert_allclose(y, ref.numpy(), atol=1e-6)

    def test_softmax_layernorm(self):
        x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
        y = _run1("Softmax", {"x": x}, axis=-1)
        e = np.exp(x - x.max(-1, keepdims=True))
        np.testing.assert_allclose(y, e / e.sum(-1, keepdims=True), rtol=1e-6)
        scale = np.full(5, 2.0, np.float32)
        y = _run1(
            "LayerNormalization",
            {"x": x, "s": scale},
            epsilon=1e-6,
        )
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        np.testing.assert_allclose(y, (x - mu) / np.sqrt(var + 1e-6) * 2.0, rtol=1e-5)


class TestConvs:
    def test_conv_grouped_matches_jax(self):
        import jax
        import jax.numpy as jnp

        rng = np.random.default_rng(1)
        c, k, n = 6, 5, 16
        x = rng.standard_normal((1, c, n)).astype(np.float32)
        w = rng.standard_normal((c, 1, k)).astype(np.float32)  # depthwise
        y = _run1("Conv", {"x": x, "w": w}, group=c, pads=[2, 2], strides=[1])
        ref = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (1,), [(2, 2)],
            feature_group_count=c,
            dimension_numbers=("NCW", "OIW", "NCW"),
        )
        np.testing.assert_allclose(y, np.asarray(ref), atol=1e-5)
        import torch

        ref_t = torch.nn.functional.conv1d(
            torch.from_numpy(x), torch.from_numpy(w), padding=2, groups=c)
        np.testing.assert_allclose(y, ref_t.numpy(), atol=1e-5)

    def test_conv_stride(self):
        x = np.arange(10, dtype=np.float32).reshape(1, 1, 10)
        w = np.ones((1, 1, 2), np.float32)
        y = _run1("Conv", {"x": x, "w": w}, strides=[3], pads=[0, 0])
        np.testing.assert_allclose(y.reshape(-1), [1, 7, 13])  # pairs at 0,3,6

    def test_conv_transpose_is_overlap_add(self):
        # Identity kernel + stride = pure overlap-add scatter.
        k, hop, n = 4, 2, 3
        frames = np.arange(k * n, dtype=np.float32).reshape(1, k, n, order="F")
        w = np.zeros((k, 1, k), np.float32)
        w[np.arange(k), 0, np.arange(k)] = 1.0
        y = _run1("ConvTranspose", {"x": frames, "w": w}, strides=[hop])
        expect = np.zeros((n - 1) * hop + k, np.float32)
        for i in range(n):
            expect[i * hop : i * hop + k] += frames[0, :, i]
        np.testing.assert_allclose(y.reshape(-1), expect)


class TestShapeOps:
    def test_slice_with_dynamic_inputs(self):
        x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        y = _run1(
            "Slice",
            {
                "x": x,
                "starts": np.array([1], np.int64),
                "ends": np.array([2**31 - 1], np.int64),
                "axes": np.array([1], np.int64),
            },
        )
        np.testing.assert_array_equal(y, x[:, 1:])

    def test_pad_reflect_and_constant_value(self):
        x = np.arange(5, dtype=np.float32).reshape(1, 5)
        y = _run1("Pad", {"x": x, "p": np.array([0, 2, 0, 2], np.int64)}, mode="reflect")
        np.testing.assert_array_equal(y[0], np.pad(x[0], 2, mode="reflect"))
        y = _run1(
            "Pad",
            {"x": x, "p": np.array([0, 0, 0, 3], np.int64), "v": np.float32(7.0)},
        )
        np.testing.assert_array_equal(y[0], np.concatenate([x[0], [7, 7, 7]]))

    def test_reshape_zero_copies_dim(self):
        x = np.zeros((2, 3, 4), np.float32)
        y = _run1("Reshape", {"x": x, "s": np.array([0, -1], np.int64)})
        assert y.shape == (2, 12)

    def test_gather_range_shape_chain(self):
        table = np.arange(20, dtype=np.float32).reshape(10, 2)
        idx = np.array([[1, 3, 5]], np.int64)
        y = _run1("Gather", {"t": table, "i": idx}, axis=0)
        assert y.shape == (1, 3, 2)
        np.testing.assert_array_equal(y[0, 1], table[3])

    def test_split_into_heads(self):
        x = np.arange(12, dtype=np.float32).reshape(1, 12)
        node = ox.make_node("Split", ["x"], ["a", "b", "c"], axis=1)
        s = _session([node], [], [ox.make_value_info("x", F32, [1, 12])],
                     [ox.make_value_info(n, F32, [1, 4]) for n in "abc"])
        a, b, c = s.run(["a", "b", "c"], {"x": x})
        np.testing.assert_array_equal(a, x[:, :4])
        np.testing.assert_array_equal(c, x[:, 8:])


class TestSessionSurface:
    def test_unsupported_op_raises_by_name(self):
        node = ox.make_node("NonMaxSuppression", ["x"], ["y"])
        s = _session([node], [], [ox.make_value_info("x", F32, [1])],
                     [ox.make_value_info("y", F32, [1])])
        with pytest.raises(UnsupportedOp, match="NonMaxSuppression"):
            s.run(["y"], {"x": np.zeros(1, np.float32)})

    def test_get_inputs_outputs_like_ort(self):
        node = ox.make_node("Identity", ["x"], ["y"])
        s = _session([node], [], [ox.make_value_info("x", F32, [1])],
                     [ox.make_value_info("y", F32, [1])])
        assert [i.name for i in s.get_inputs()] == ["x"]
        assert [o.name for o in s.get_outputs()] == ["y"]
        # run with default (graph-declared) outputs
        out = s.run(None, {"x": np.float32([5.0])})
        np.testing.assert_array_equal(out[0], [5.0])


class TestExtendedOps:
    """Ops the real F5 export plausibly contains beyond the fixture's set."""

    def test_einsum(self):
        a = np.random.default_rng(2).standard_normal((2, 3, 4)).astype(np.float32)
        b = np.random.default_rng(3).standard_normal((4, 5)).astype(np.float32)
        y = _run1("Einsum", {"a": a, "b": b}, equation="bnd,df->bnf")
        np.testing.assert_allclose(y, np.einsum("bnd,df->bnf", a, b), rtol=1e-5)

    def test_reduce_sum_max(self):
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        y = _run1("ReduceSum", {"x": x}, axes=[1], keepdims=0)
        np.testing.assert_array_equal(y, x.sum(1))
        y = _run1("ReduceMax", {"x": x}, axes=[0], keepdims=1)
        np.testing.assert_array_equal(y, x.max(0, keepdims=True))

    def test_trilu_mask(self):
        x = np.ones((4, 4), np.float32)
        np.testing.assert_array_equal(_run1("Trilu", {"x": x}, upper=1), np.triu(x))
        np.testing.assert_array_equal(_run1("Trilu", {"x": x}, upper=0), np.tril(x))

    def test_comparisons_and_logic(self):
        a = np.float32([1, 2, 3])
        b = np.float32([2, 2, 2])
        np.testing.assert_array_equal(_run1("LessOrEqual", {"a": a, "b": b}), a <= b)
        m1 = a > b
        m2 = a < b
        np.testing.assert_array_equal(_run1("Or", {"a": m1, "b": m2}), m1 | m2)
        np.testing.assert_array_equal(_run1("Not", {"a": m1}), ~m1)

    def test_floor_mod_sign(self):
        a = np.float32([-1.5, 0.5, 2.5])
        np.testing.assert_array_equal(_run1("Floor", {"a": a}), np.floor(a))
        np.testing.assert_array_equal(_run1("Sign", {"a": a}), np.sign(a))
