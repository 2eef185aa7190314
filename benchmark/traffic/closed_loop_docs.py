"""Closed-loop long-form traffic: a few clients, each sending one document
at a time through the library entry (``TTSApi.synthesize``) and the next
once the last one's whole waveform is back, until the window closes.

A mix of this kind (``traffic/<mix>.json``) gives:

- ``clients``: how many send at once;
- ``docs``: how many documents the run's list holds (more than a window
  finishes); the clients take them in order;
- ``chars``: ``median``, ``sigma``, ``min``, ``max`` of the lognormal law
  of the documents' lengths in characters (midpoint quantiles, in an order
  from the seed), and ``paragraph``, the characters after which a
  paragraph ends at the next full stop;
- ``voices``, ``max_batch``, ``max_wait_ms``, ``trace``, ``check``: as in
  ``open_loop_rest``.
"""

from __future__ import annotations

import threading
import time

from . import common

DRAIN_SECONDS = 60.0


def requests(mix: dict, model: dict, voices: list, seed: int, seconds: float) -> list[dict]:
    """The run's documents, in the order the clients take them."""
    n, c = mix["docs"], mix["chars"]
    lengths = common.lognormal_lengths(common.rng_for(seed, 1), n, c)
    voice = common.zipf_voices(common.rng_for(seed, 3), n, len(voices), mix["voices"]["zipf_s"])
    rng, words = common.rng_for(seed, 4), common.bank_words()
    return [{"i": i, "voice": int(voice[i]),
             "text": common.text_of_length(rng, words, int(lengths[i]), c["paragraph"])}
            for i in range(n)]


def drive(reqs: list, mix: dict, model: dict, voices: list, api, events=(),
          seconds: float = 0.0) -> dict:
    """Run the clients until ``seconds`` after the window opens, then wait
    for the documents in flight (at most a minute). ``events`` are
    (seconds after the window opens, callable) run on this thread."""
    lock = threading.Lock()
    queue = list(reqs)
    records: list = []
    inflight: dict = {}
    t0 = time.perf_counter()
    close = t0 + seconds

    def client():
        while True:
            with lock:
                if time.perf_counter() >= close or not queue:
                    return
                req = queue.pop(0)
                rec = {"i": req["i"], "due": time.perf_counter()}
                rec["sent"] = rec["due"]
                inflight[req["i"]] = rec
            v = voices[req["voice"]]
            try:
                wave, _ = api.synthesize(req["text"], gender=v["gender"], group=v["group"],
                                         area=v["area"], emotion=v["emotion"])
                rec["pcm"], rec["ok"] = wave, True
            except Exception as e:  # noqa: BLE001 — a failed document is counted
                rec["ok"], rec["error"] = False, f"{type(e).__name__}: {e}"
            rec["end"] = time.perf_counter()
            with lock:
                records.append(inflight.pop(req["i"]))

    threads = [threading.Thread(target=client, name=f"bench-client-{k}", daemon=True)
               for k in range(mix["clients"])]
    for t in threads:
        t.start()
    for at, fn in sorted(events, key=lambda e: e[0]):
        time.sleep(max(0.0, t0 + at - time.perf_counter()))
        fn()
    deadline = close + DRAIN_SECONDS
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    with lock:
        for rec in inflight.values():  # still waiting a minute past the close
            records.append({**rec, "ok": False, "end": float("inf"),
                            "error": "no waveform a minute past the window's close"})
        inflight.clear()
    records.sort(key=lambda r: r["i"])
    return {"start": t0, "records": records}
