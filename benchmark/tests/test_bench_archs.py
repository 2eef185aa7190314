"""The backbone is found by the name a configuration gives under
``"architecture"``: a configuration naming an alias of ``f5_dit`` is served
and checked through the alias alone, and one that names no architecture,
or one without a module, is refused with the file's name."""

from __future__ import annotations

import collections
import copy
import sys
import types

import pytest

from benchmark import flops, spec
from benchmark import run as runmod
from benchmark.archs import f5_dit
from benchmark.trace import Summary

HOOKS = ("backbone", "leaves", "pack_meta", "prepare", "velocity", "eval_flops", "embed_flops",
         "attention_bound_s", "attention_calls_per_batch")
TABLES = ("BF16_KEYS", "SCALE_RULES")
ALIAS = "f5_alias"


class _Alias(types.ModuleType):
    """``f5_dit`` under another name, counting what is read of it and the
    calls of its hooks."""

    def __init__(self):
        super().__init__(f"benchmark.archs.{ALIAS}")
        self.read = collections.Counter()
        self.called = collections.Counter()

    def __getattr__(self, name):
        value = getattr(f5_dit, name)
        self.read[name] += 1
        if name not in HOOKS:
            return value

        def hook(*args, **kwargs):
            self.called[name] += 1
            return value(*args, **kwargs)

        return hook


@pytest.fixture
def alias(monkeypatch):
    module = _Alias()
    monkeypatch.setitem(sys.modules, module.__name__, module)
    return module


def _traced_window(model):
    """A window whose traced span holds one whole batch of two request rows."""
    calls = flops.attention_calls_per_batch(model)
    d = {"bucket": 512, "total_len": [448, 200], "real": [True, True]}
    whole = {"dispatch": d, "attention_calls": calls, "attention_ns": 10**9,
             "first_ns": 0, "last_ns": 2 * 10**9}
    t = Summary((0, 4 * 10**9), 3 * 10**9, [], [], 4 * 10**9, 10**9, [whole],
                step_ns=2 * 10**9, step_busy_ns=15 * 10**8)
    return runmod.Window(model=model, start=0.0, records=[], batches=[d],
                         batcher={"batches": 1, "jobs": 2, "padded_rows": 0, "retries": 0,
                                  "failures": 0},
                         stages={"chunk_dispatch": (0.003, 1)}, trace=t)


def test_a_configuration_selects_its_architecture_by_name(tiny_cfg, tiny_rest_mix, alias):
    cfg = {**copy.deepcopy(tiny_cfg), "architecture": ALIAS}
    result, _ = runmod.run({"name": "f5base.rest_short", "chips": 1}, cfg, tiny_rest_mix,
                           spec.limits("f5base.rest_short"), 2**31 + 91, 2.0, False,
                           device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    # The readers of the counts, on a traced window of F5 v1 Base named by the alias.
    model = spec.model({**spec.config("f5tts_v1_base"), "architecture": ALIAS})
    assert model["architecture"] == ALIAS
    win = _traced_window(model)
    assert spec.metric_reader("attn_roofline")(win) > 0
    assert spec.metric_reader("step_mfu_pct")(win) > 0
    assert set(alias.called) == set(HOOKS)
    assert set(TABLES) <= set(alias.read)


def test_the_alias_counts_as_f5(alias):
    """The alias's model counts what F5's does, through ``flops``."""
    cfg = spec.config("f5tts_v1_base")
    base, other = spec.model(cfg), spec.model({**cfg, "architecture": ALIAS})
    assert {k: v for k, v in other.items() if k != "architecture"} == \
        {k: v for k, v in base.items() if k != "architecture"}
    for n in (200, 448):
        assert flops.row_flops(other, n) == flops.row_flops(base, n)
        assert flops.attention_bound_s(other, [n], 512) == flops.attention_bound_s(base, [n], 512)


def test_no_architecture_is_refused():
    cfg = spec.config("f5tts_small")
    del cfg["architecture"]
    with pytest.raises(ValueError, match=r"configs/f5tts_small\.json names no architecture"):
        spec.model(cfg)


def test_an_architecture_without_a_module_is_refused():
    cfg = {**spec.config("f5tts_small"), "architecture": "no_such_backbone"}
    with pytest.raises(ValueError, match=r"configs/f5tts_small\.json .*'no_such_backbone'.*"
                                         r"benchmark/archs/no_such_backbone\.py"):
        spec.model(cfg)
