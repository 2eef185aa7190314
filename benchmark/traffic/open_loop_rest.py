"""Open-loop REST traffic: requests due on a fixed schedule, sent through the
REST app in this process (its ASGI callable, no socket), each timed from
when it was due to its whole response.

A mix of this kind (``traffic/<mix>.json``) gives:

- ``route``: the POST route (``/api/v1/synthesize``);
- ``rate_rps``: the offered rate: ``rate_rps`` × the window's seconds
  requests, due at the times of a Poisson process over the window;
- ``arrival_seed``: the seed of those times, one path for every run's
  seed (``tools/arrivals.py`` finds a typical one); the run's seed puts
  its requests on the path in its own order;
- ``chars``: ``median``, ``sigma``, ``min``, ``max`` of the lognormal law
  of the sentences' lengths in characters (its midpoint quantiles, in an
  order from the seed);
- ``voices``: ``zipf_s``, the exponent of the law by which requests pick a
  catalogue voice (through the request's gender, group, area and emotion);
- ``max_batch``, ``max_wait_ms``: the micro-batcher's settings;
- ``max_threads``: the worker threads the app may hold at once;
- ``trace``: ``start_s`` and ``seconds`` of the traced span of a
  ``--trace 1`` run;
- ``check``: ``sample``, how many finished requests the output check
  compares (the longest among them).
"""

from __future__ import annotations

import asyncio
import time

from . import common

DRAIN_SECONDS = 60.0


def requests(mix: dict, model: dict, voices: list, seed: int, seconds: float) -> list[dict]:
    """The run's requests, each with its text, voice and due time (s after
    the window opens)."""
    n = max(1, int(round(mix["rate_rps"] * seconds)))
    lengths = common.lognormal_lengths(common.rng_for(seed, 1), n, mix["chars"])
    due = common.poisson_arrivals(common.rng_for(mix["arrival_seed"], 2), n, n / mix["rate_rps"])
    voice = common.zipf_voices(common.rng_for(seed, 3), n, len(voices), mix["voices"]["zipf_s"])
    rng, words = common.rng_for(seed, 4), common.bank_words()
    return [{"i": i, "due": float(due[i]), "voice": int(voice[i]),
             "text": common.text_of_length(rng, words, int(lengths[i]))} for i in range(n)]


def body(req: dict, voices: list, model: dict) -> dict:
    v = voices[req["voice"]]
    return {"text": req["text"], "speed": model["speed"], "gender": v["gender"],
            "group": v["group"], "area": v["area"], "emotion": v["emotion"]}


def drive(reqs: list, mix: dict, model: dict, voices: list, api, events=(),
          seconds: float = 0.0) -> dict:
    """Send every request at its due time through the REST app serving
    ``api``; wait for all of them (at most a minute past the last due
    time; the window's ``seconds`` are in the schedule already). ``events``
    are (seconds after the window opens, callable) run on this thread.
    Returns the window's start and, per request, its record."""
    from anyio import to_thread

    from vietvoice_tts_tpu_torch.api import tts_engine
    from vietvoice_tts_tpu_torch.api.app import app
    from vietvoice_tts_tpu_torch.api.testing import AsyncTestClient

    from ..pack import parse_wav_pcm

    tts_engine._engine = api  # the app serves this engine
    client = AsyncTestClient(app)
    records: list = [None] * len(reqs)

    async def one(req, t0):
        rec = {"i": req["i"], "due": t0 + req["due"], "sent": time.perf_counter()}
        try:
            resp = await client.post(mix["route"], json=body(req, voices, model))
            if resp.status_code != 200:
                raise RuntimeError(f"HTTP {resp.status_code}: {resp.content[:200]!r}")
            rec["pcm"] = parse_wav_pcm(resp.content)
            rec["ok"] = True
        except Exception as e:  # noqa: BLE001 — a failed request is counted, not raised
            rec["ok"], rec["error"] = False, f"{type(e).__name__}: {e}"
        rec["end"] = time.perf_counter()
        records[req["i"]] = rec

    async def main():
        to_thread.current_default_thread_limiter().total_tokens = mix["max_threads"]
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        for at, fn in events:
            loop.call_later(max(0.0, t0 + at - time.perf_counter()), fn)
        tasks = []
        for req in reqs:
            delay = t0 + req["due"] - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            tasks.append(asyncio.create_task(one(req, t0)))
        last_due = t0 + reqs[-1]["due"]
        done, pending = await asyncio.wait(
            tasks, timeout=max(1.0, last_due + DRAIN_SECONDS - time.perf_counter()))
        for t in pending:
            t.cancel()
        for t in done:
            t.result()
        return t0

    try:
        t0 = asyncio.run(main())
    finally:
        tts_engine._engine = None
    for req, rec in zip(reqs, records):
        if rec is None:
            records[req["i"]] = {"i": req["i"], "due": t0 + req["due"], "ok": False,
                                 "error": "no response a minute past the last due time",
                                 "end": float("inf")}
    return {"start": t0, "records": records}
