"""The backbones the benchmark knows, one module an architecture, found by
the name that a configuration file gives under ``"architecture"``
(``spec.architecture``).

A module ``archs/<architecture>.py`` holds everything of the benchmark
that depends on the backbone, and exposes:

- ``backbone(model_config) -> dict``: the backbone's sizes that the
  benchmark's own code reads, from the configuration's ``ModelConfig``
  keys; ``spec.model`` puts it under ``"dit"``;
- ``leaves(model)``: the backbone's leaves as (path, shape, rule, fan-in),
  in the weight pack's layout and in the order they are drawn;
  ``BF16_KEYS``, the path keys of the leaves the program keeps in
  bfloat16; ``SCALE_RULES``, {rule: f(x, fan_in)} for the rules of its
  own (``weights.py`` has the common ones);
- ``pack_meta(model) -> dict``: the ``dit`` section of the pack's
  ``model_meta.json``;
- the reference's backbone, plain float32 ``torch`` through
  ``reference.model.Ops`` (so that a lower precision reaches every
  product): ``prepare(ops, p, model, cond2, ids2, t_starts)``, the
  solve-wide state of the CFG-doubled rows, and
  ``velocity(ops, p, model, state, x2, mask2, step)``, one evaluation at
  the solve's step ``step``;
- the counts: ``eval_flops(model, valid)``, ``embed_flops(model, valid)``,
  ``attention_bound_s(model, valid_lengths, bucket, dtype_bytes)`` and
  ``attention_calls_per_batch(model)``, which ``flops.py`` hands on.

What every architecture shares stays where it is: the vocoder's leaves and
the draws (``weights.py``), the mel front end, the row noise, the Euler/CFG
loop and the vocoder (``reference/model.py``), the peaks and the vocoder's
count (``flops.py``). A new architecture is a new file here.
"""
